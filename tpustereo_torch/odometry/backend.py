"""Stereo visual odometry backend (cv_slam tier; SURVEY.md §3 #19, §4.4): a
copy of the JAX package's `odometry/backend.py` in torch.

Per frame: one tracking step on the device (`odometry.fused.
fused_track_step`): disparity + Harris corners + NCC-patch descriptors +
keyframe matching + Huber-GN pose; with `cfg.strips > 1` the strip-tiled
matcher (`dist.sgbm_tiled`, BASELINE config 5), then
`fused_track_from_disp`, as the JAX `step` does. The host receives only
the small (T, n_matches) pair, in one transfer, for the keyframe decision
and the pose-graph bookkeeping. Keyframe feature state stays on the device
between frames. The host logic (keyframe rules, closure picks, the pose
update) is numpy, op for op as in the JAX package. State is checkpointable
in the JAX package's layout (SURVEY.md §5.4), so a killed run resumes at
the last keyframe, in either package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpustereo_torch import dist
from tpustereo_torch.api import _as_u8, _device
from tpustereo_torch.config import Config
from tpustereo_torch.data.datasets import KittiCalib
from tpustereo_torch.odometry import fused
from tpustereo_torch.odometry.fused import batched_candidate_match
from tpustereo_torch.odometry.pnp import gauss_newton_pose
from tpustereo_torch.odometry.pose_graph import PoseGraph
from tpustereo_torch.odometry.se3 import inv_se3

# describe() emits 8x8 normalized patches; the bootstrap zero-keyframe
# state must match its descriptor width
_DESC_DIM = 64


def _inv_se3_np(T: np.ndarray) -> np.ndarray:
    """Host-side SE(3) inverse — the per-frame pose update must not pay a
    device dispatch for a 4x4 inverse."""
    out = np.eye(4, dtype=np.float32)
    R, t = T[:3, :3], T[:3, 3]
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    max_corners: int = 512
    min_similarity: float = 0.6
    gn_iters: int = 10
    keyframe_translation: float = 0.3   # new keyframe beyond this motion (m)
    keyframe_rotation: float = 0.05     # or beyond this rotation (rad, approx)
    keyframe_min_matches: int = 40      # or when tracking starves
    optimize_every: int = 5             # pose-graph GN every K keyframes
    min_depth: float = 0.5
    max_depth: float = 80.0
    # --- loop closure (drift correction) -------------------------------
    loop_closure: bool = True
    lc_min_gap: int = 6        # keyframe-index gap before a pair is eligible
    lc_min_matches: int = 30   # tentative mutual matches to attempt PnP
    lc_max_residual: float = 2.0  # px; geometric-verification gate
    lc_max_candidates: int = 100  # cap on appearance checks per keyframe


@dataclasses.dataclass
class _Keyframe:
    index: int               # pose-graph node id
    pts: np.ndarray          # (K, 2) float32 [y, x], subpixel
    desc: np.ndarray         # (K, P) float32
    X: np.ndarray            # (K, 3) float32 3D points (camera frame)
    valid: np.ndarray        # (K,) bool (corner valid & depth valid)


class StereoOdometry:
    """Runs on `device` ("cuda" unless the caller passes "cpu"; raises when
    CUDA is absent). With `cfg.strips > 1` the matcher tiles each frame
    over `mesh`'s strips (by default `cfg.strips` strips on `device`)."""

    def __init__(self, calib: KittiCalib, cfg: Optional[Config] = None,
                 ocfg: Optional[OdometryConfig] = None, device="cuda",
                 mesh=None):
        self.calib = calib
        self.cfg = cfg or Config()
        self.ocfg = ocfg or OdometryConfig()
        self.device = _device(device)
        if mesh is None and self.cfg.strips > 1:
            mesh = dist.make_mesh(1, self.cfg.strips, device=self.device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh is on {mesh.device}, the odometry on "
                             f"{self.device}")
        self._mesh = mesh
        self.graph = PoseGraph(device=str(self.device))
        self.kf: Optional[_Keyframe] = None
        self.kfs: List[_Keyframe] = []   # keyframe database for loop closure
        self.closures: List[Tuple[int, int]] = []  # accepted closure edges
        self.pose = np.eye(4, dtype=np.float32)      # world <- current cam
        self._traj: List[np.ndarray] = []
        self._frames = 0
        self._intr = torch.tensor([calib.fx, calib.fy, calib.cx, calib.cy],
                                  dtype=torch.float32, device=self.device)
        self._baseline = torch.tensor(calib.baseline, dtype=torch.float32,
                                      device=self.device)
        # keyframe feature state resident on the device (desc, valid, X) —
        # re-uploading it every frame would waste a host->device transfer
        self._kf_dev = None

    # ------------------------------------------------------------------
    def _upload(self, img: np.ndarray) -> torch.Tensor:
        """(H, W) uint8 on the device. On the card the copy goes through
        pinned memory without blocking the host: a pageable copy would
        synchronise."""
        t = torch.from_numpy(np.ascontiguousarray(_as_u8(img)))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _kf_state(self):
        if self._kf_dev is not None:
            return self._kf_dev
        # bootstrap: all-zero state — matching finds nothing, GN holds I
        K = self.ocfg.max_corners
        dev = self.device
        return (torch.zeros((K, _DESC_DIM), dtype=torch.float32, device=dev),
                torch.zeros((K,), dtype=torch.bool, device=dev),
                torch.zeros((K, 3), dtype=torch.float32, device=dev))

    def _store_keyframe(self, out) -> _Keyframe:
        """Materialize a keyframe from a TrackOut: numpy copies (one
        transfer) for the graph/checkpoint/loop-closure machinery, device
        handles kept for next frame's matching."""
        P = out.desc.shape[1]
        host = torch.cat([out.pts, out.desc, out.X,
                          out.valid[:, None].to(torch.float32)],
                         1).cpu().numpy()
        pts, desc = host[:, :2].copy(), host[:, 2:2 + P].copy()
        X, valid = host[:, 2 + P:5 + P].copy(), host[:, 5 + P] > 0
        node = self.graph.add_keyframe(self.pose)
        kf = _Keyframe(node, pts, desc, X, valid)
        self.kfs.append(kf)
        self._kf_dev = (out.desc, out.valid, out.X)
        return kf

    # ------------------------------------------------------------------
    def step(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        """Process one rectified pair; returns the current world pose.

        A tracked frame makes one device-to-host transfer, (T, n_matches)
        for the keyframe decision. Keyframe frames add one (feature
        materialization) and the occasional pose-graph/loop-closure work
        (SURVEY.md §4.4)."""
        kf_desc, kf_valid, kf_X = self._kf_state()
        l8, r8 = self._upload(left), self._upload(right)
        if self.cfg.strips > 1:
            disp = dist.sgbm_tiled(l8, r8, self.cfg, self._mesh)
            out = fused.fused_track_from_disp(l8, disp, kf_desc, kf_valid,
                                              kf_X, self._intr,
                                              self._baseline, self.cfg,
                                              self.ocfg)
        else:
            out = fused.fused_track_step(l8, r8, kf_desc, kf_valid, kf_X,
                                         self._intr, self._baseline, self.cfg,
                                         self.ocfg)
        self._frames += 1

        if self.kf is None:
            self.kf = self._store_keyframe(out)
            self._traj.append(self.pose.copy())
            return self.pose

        # one transfer for everything the host decision needs (a count of
        # at most max_corners is exact in float32)
        host = torch.cat([out.T.reshape(-1),
                          out.n_matches.reshape(1).to(torch.float32)]
                         ).cpu().numpy()
        T = host[:16].reshape(4, 4)  # kf cam -> current cam
        n_matches = int(host[16])
        kf_pose = self.graph.poses[self.kf.index]
        self.pose = (kf_pose @ _inv_se3_np(T)).astype(np.float32)
        self._traj.append(self.pose.copy())

        trans = float(np.linalg.norm(T[:3, 3]))
        rot = float(np.arccos(np.clip((np.trace(T[:3, :3]) - 1) / 2, -1, 1)))
        if (trans > self.ocfg.keyframe_translation
                or rot > self.ocfg.keyframe_rotation
                or n_matches < self.ocfg.keyframe_min_matches):
            new_kf = self._store_keyframe(out)
            self.graph.add_edge(self.kf.index, new_kf.index,
                                _inv_se3_np(T),
                                weight=min(1.0, n_matches / 100.0))
            self.kf = new_kf
            closed = self.ocfg.loop_closure and self._loop_closure(new_kf)
            if (not closed
                    and len(self.graph.poses) % self.ocfg.optimize_every == 0):
                self.graph.optimize()
                self.pose = self.graph.poses[self.kf.index].copy()
        return self.pose

    # ------------------------------------------------------------------
    def _loop_closure(self, new_kf: _Keyframe) -> bool:
        """Loop-closure detection + geometric verification (SURVEY.md §4.4).

        Appearance candidate: every stored keyframe at least lc_min_gap
        indices back is NCC-matched against the new keyframe — all
        candidates at once (`fused.batched_candidate_match`); the best
        candidate with >= lc_min_matches mutual matches goes to geometric
        verification — Huber-GN PnP of the old keyframe's 3D points onto the
        new keyframe's pixels. A closure is accepted only if the mean
        weighted reprojection residual passes lc_max_residual; the edge is
        added and the whole graph re-optimised immediately, which is what
        actually corrects accumulated drift."""
        elig = [old for old in self.kfs[:-1]
                if new_kf.index - old.index >= self.ocfg.lc_min_gap]
        if len(elig) > self.ocfg.lc_max_candidates:
            # evenly stride-sample so the check stays O(cap) per keyframe on
            # arbitrarily long sequences while still spanning the whole past
            step = len(elig) / self.ocfg.lc_max_candidates
            elig = [elig[int(i * step)]
                    for i in range(self.ocfg.lc_max_candidates)]
        if not elig:
            return False
        idx_bs, goods, counts = batched_candidate_match(
            self._to_device(np.stack([old.desc for old in elig])),
            self._to_device(np.stack([old.valid for old in elig])),
            self._to_device(new_kf.desc), self._to_device(new_kf.valid),
            self.ocfg.min_similarity)
        counts = counts.cpu().numpy()
        e = int(np.argmax(counts))  # first max == the old loop's tie rule
        n = int(counts[e])
        if n < self.ocfg.lc_min_matches:
            return False
        old = elig[e]
        idx_b, good = idx_bs[e].cpu().numpy(), goods[e].cpu().numpy()
        w = (good & old.valid).astype(np.float32)
        u = new_kf.pts[idx_b][:, ::-1].astype(np.float32)
        T, res = gauss_newton_pose(self._to_device(old.X), self._to_device(u),
                                   self._to_device(w), self._intr,
                                   iters=self.ocfg.gn_iters)
        if float(res) > self.ocfg.lc_max_residual:
            return False
        self.graph.add_edge(old.index, new_kf.index,
                            inv_se3(T).cpu().numpy(),
                            weight=min(2.0, n / 50.0))
        self.closures.append((old.index, new_kf.index))
        self.graph.optimize()
        self.pose = self.graph.poses[new_kf.index].copy()
        return True

    # ------------------------------------------------------------------
    def trajectory(self) -> np.ndarray:
        return np.stack(self._traj) if self._traj else np.zeros((0, 4, 4))

    # --- checkpoint / resume (SURVEY.md §5.4) --------------------------
    def save(self, path: str) -> None:
        if self.kf is None:
            raise ValueError("nothing to checkpoint yet")
        self.graph.save(path, extra=dict(
            kf_index=np.int64(self.kf.index), kf_pts=self.kf.pts,
            kf_desc=self.kf.desc, kf_X=self.kf.X, kf_valid=self.kf.valid,
            cur_pose=self.pose, frames=np.int64(self._frames),
            traj=self.trajectory(),
            # keyframe database (loop closure must survive a resume)
            kfs_index=np.array([k.index for k in self.kfs], np.int64),
            kfs_pts=np.stack([k.pts for k in self.kfs]),
            kfs_desc=np.stack([k.desc for k in self.kfs]),
            kfs_X=np.stack([k.X for k in self.kfs]),
            kfs_valid=np.stack([k.valid for k in self.kfs]),
            closures=np.array(self.closures, np.int64).reshape(-1, 2)))

    @classmethod
    def resume(cls, path: str, calib: KittiCalib, cfg: Optional[Config] = None,
               ocfg: Optional[OdometryConfig] = None,
               device="cuda", mesh=None) -> "StereoOdometry":
        self = cls(calib, cfg, ocfg, device=device, mesh=mesh)
        graph, extra = PoseGraph.load(path, device=str(self.device))
        self.graph = graph
        self.kf = _Keyframe(int(extra["kf_index"]), extra["kf_pts"],
                            extra["kf_desc"], extra["kf_X"], extra["kf_valid"])
        if "kfs_index" in extra:
            self.kfs = [
                _Keyframe(int(i), p, d, X, v)
                for i, p, d, X, v in zip(
                    extra["kfs_index"], extra["kfs_pts"], extra["kfs_desc"],
                    extra["kfs_X"], extra["kfs_valid"])]
            self.kf = self.kfs[-1]
            self.closures = [(int(a), int(b)) for a, b in extra["closures"]]
        else:  # pre-loop-closure checkpoint: only the latest keyframe
            self.kfs = [self.kf]
        self.pose = extra["cur_pose"]
        self._frames = int(extra["frames"])
        self._traj = [p for p in extra["traj"]]
        # re-seed the device-resident keyframe state from the checkpoint
        self._kf_dev = (self._to_device(self.kf.desc),
                        self._to_device(self.kf.valid),
                        self._to_device(self.kf.X))
        return self
