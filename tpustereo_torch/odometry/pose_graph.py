"""Keyframe pose graph + Gauss–Newton optimizer over SE(3)
(SURVEY.md §3 #19, §4.4 `odometry.pose_graph.optimize`); a copy of the JAX
package's `odometry/pose_graph.py` in torch.

Graph state lives on the host (append-only lists, trivially
checkpointable); the optimizer is a GN over the stacked tangent
increments on the device, with Jacobians by forward-mode autodiff
(`torch.func.jacfwd`) — the graphs here are small (keyframe chains + sparse
extra edges), so a dense 6N normal-equation solve is the right tool.
Checkpoints keep the JAX package's `.npz` layout and keys, so a checkpoint
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from tpustereo_torch.odometry.se3 import exp_se3, inv_se3, log_se3


def optimize_poses(poses: torch.Tensor, edges_ij: torch.Tensor,
                   edges_T: torch.Tensor, edges_w: torch.Tensor,
                   iters: int = 10, damping: float = 1e-6) -> torch.Tensor:
    """GN over keyframe poses. poses (N,4,4) world<-kf; edges (E,2) int
    (i, j) with measured relative pose T_ij ≈ T_i^{-1} T_j and weight w.
    Pose 0 is gauge-fixed. Returns refined (N,4,4)."""
    N = poses.shape[0]
    dev = poses.device
    inv_meas = inv_se3(edges_T)
    eye = torch.eye(N * 6, dtype=poses.dtype, device=dev)
    # gauge fix: pin pose 0 by zeroing its increment rows/cols
    fix = torch.arange(N * 6, device=dev) < 6
    fix2 = fix[:, None] | fix[None, :]
    for _ in range(iters):
        def res(xi, cur=poses):
            P = cur @ exp_se3(xi.reshape(N, 6))       # right-perturbed
            rel = inv_se3(P[edges_ij[:, 0]]) @ P[edges_ij[:, 1]]
            return (log_se3(inv_meas @ rel) * edges_w[:, None]).reshape(-1)

        xi0 = torch.zeros(N * 6, dtype=poses.dtype, device=dev)
        J = jacfwd(res)(xi0)                          # (6E, 6N)
        r = res(xi0)
        H = J.T @ J + damping * eye
        g = J.T @ r
        H = torch.where(fix2, eye, H)
        g = torch.where(fix, 0.0, g)
        delta = -torch.linalg.solve_ex(H, g, check_errors=False)[0]
        poses = poses @ exp_se3(delta.reshape(N, 6))
    return poses


@dataclasses.dataclass
class PoseGraph:
    """Append-only keyframe pose graph (host state, SURVEY.md §5.4);
    `optimize` runs on `device`."""
    poses: List[np.ndarray] = dataclasses.field(default_factory=list)
    edges: List[Tuple[int, int, np.ndarray, float]] = dataclasses.field(default_factory=list)
    device: str = "cuda"

    def add_keyframe(self, pose_world: np.ndarray) -> int:
        self.poses.append(np.asarray(pose_world, np.float32))
        return len(self.poses) - 1

    def add_edge(self, i: int, j: int, T_ij: np.ndarray, weight: float = 1.0):
        self.edges.append((i, j, np.asarray(T_ij, np.float32), float(weight)))

    def optimize(self, iters: int = 10) -> np.ndarray:
        if len(self.poses) < 2 or not self.edges:
            return np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))
        dev = torch.device(self.device)
        poses = torch.from_numpy(np.stack(self.poses)).to(dev)
        ij = torch.from_numpy(np.array([[e[0], e[1]] for e in self.edges],
                                       np.int64)).to(dev)
        Ts = torch.from_numpy(np.stack([e[2] for e in self.edges])).to(dev)
        w = torch.from_numpy(np.array([e[3] for e in self.edges],
                                      np.float32)).to(dev)
        out = optimize_poses(poses, ij, Ts, w, iters=iters).cpu().numpy()
        self.poses = [out[k] for k in range(out.shape[0])]
        return out

    # --- checkpoint / resume (SURVEY.md §5.4) ---------------------------
    def save(self, path: str, extra: dict | None = None) -> None:
        # atomic write (tmp + rename): a process killed mid-save must never
        # leave a truncated checkpoint behind — the previous one stays intact
        if not path.endswith(".npz"):
            path = path + ".npz"
        tmp = path + ".tmp.npz"
        np.savez(tmp,
                 poses=np.stack(self.poses) if self.poses else np.zeros((0, 4, 4)),
                 edge_ij=np.array([[e[0], e[1]] for e in self.edges], np.int32).reshape(-1, 2),
                 edge_T=np.stack([e[2] for e in self.edges]) if self.edges else np.zeros((0, 4, 4)),
                 edge_w=np.array([e[3] for e in self.edges], np.float32),
                 **(extra or {}))
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, device: str = "cuda") -> Tuple["PoseGraph", dict]:
        g = cls(device=device)
        with np.load(path, allow_pickle=False) as z:
            g.poses = [p for p in z["poses"]]
            g.edges = [(int(ij[0]), int(ij[1]), T, float(w))
                       for ij, T, w in zip(z["edge_ij"], z["edge_T"],
                                           z["edge_w"])]
            extra = {k: z[k] for k in z.files
                     if k not in ("poses", "edge_ij", "edge_T", "edge_w")}
        return g, extra
