"""One odometry tracking step on the device (SURVEY.md §4.4): a copy of the
JAX package's `odometry/fused.py` in torch.

A tracked frame is disparity (the full SGM pipeline, the CUDA kernels on
the card) + Harris corners + patch descriptors + keyframe matching (one
matrix product) + backprojection + Huber-GN pose, all on the device of the
inputs with no host synchronisation in this module: the caller transfers
only what its keyframe decision needs. Where the JAX package compiles
each function into one program, the port runs the same functions as a
sequence of launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.odometry.features import (describe, detect_corners,
                                               match_descriptors)
from tpustereo_torch.odometry.pnp import gauss_newton_pose
from tpustereo_torch.pipeline import sgbm, sgbm_frames


class TrackOut(NamedTuple):
    """Everything a frame step can need — host code transfers only the
    small leaves (T, residual, n_matches) unless it makes a keyframe."""
    disp: torch.Tensor    # (H, W) float32
    pts: torch.Tensor     # (K, 2) float32 [y, x], subpixel
    desc: torch.Tensor    # (K, P) float32
    valid: torch.Tensor   # (K,) bool: corner valid & depth valid (keyframe-ready)
    X: torch.Tensor       # (K, 3) float32 camera-frame 3D points
    T: torch.Tensor       # (4, 4) float32 keyframe cam -> current cam
    residual: torch.Tensor  # () float32 mean weighted reprojection residual
    n_matches: torch.Tensor  # () int32 weighted match count


def backproject(pts: torch.Tensor, disp: torch.Tensor, intr: torch.Tensor,
                baseline: torch.Tensor, min_depth: float, max_depth: float):
    """3D points at (subpixel) corner positions; the disparity lookup
    rounds, the ray uses the subpixel position."""
    fx, fy, cx, cy = intr
    H, W = disp.shape
    pi = torch.round(pts).to(torch.int64)
    py = torch.clamp(pi[:, 0], 0, H - 1)
    px = torch.clamp(pi[:, 1], 0, W - 1)
    d = disp[py, px]
    z = torch.where(d > 0, fx * baseline / torch.clamp(d, min=1e-6), 0.0)
    ok = (z > min_depth) & (z < max_depth)
    x = (pts[:, 1] - cx) * z / fx
    y = (pts[:, 0] - cy) * z / fy
    return torch.stack([x, y, z], -1).to(torch.float32), ok


def _track_core(left, disp, kf_desc, kf_valid, kf_X, intr, baseline,
                ocfg) -> TrackOut:
    pts, cvalid = detect_corners(left, max_corners=ocfg.max_corners)
    desc = describe(left, pts)
    X, ok = backproject(pts, disp, intr, baseline,
                        ocfg.min_depth, ocfg.max_depth)
    idx_b, good = match_descriptors(kf_desc, desc, kf_valid, cvalid,
                                    min_similarity=ocfg.min_similarity)
    w = (good & kf_valid).to(torch.float32)
    u = torch.flip(pts[idx_b], [1])  # (K, 2) [x, y] pixels
    T, res = gauss_newton_pose(kf_X, u, w, intr, iters=ocfg.gn_iters)
    return TrackOut(disp, pts, desc, cvalid & ok, X, T, res,
                    w.sum().to(torch.int32))


def fused_track_step(left, right, kf_desc, kf_valid, kf_X, intr, baseline,
                     cfg: Config, ocfg) -> TrackOut:
    """sgbm + features + matching + GN pose for one (H, W) uint8 pair. On
    the first frame pass all-zero keyframe state: matching finds nothing
    (kf_valid all False), GN holds T = I, and the caller consumes only the
    keyframe fields."""
    disp = sgbm(left, right, cfg)
    return _track_core(left, disp, kf_desc, kf_valid, kf_X, intr, baseline,
                       ocfg)


def fused_track_from_disp(left, disp, kf_desc, kf_valid, kf_X, intr,
                          baseline, cfg: Config, ocfg) -> TrackOut:
    """Tracking for callers whose disparity comes from elsewhere (the
    strip-tiled matcher of BASELINE config 5, `dist.sgbm_tiled`)."""
    return _track_core(left, disp, kf_desc, kf_valid, kf_X, intr, baseline,
                       ocfg)


def fused_track_frames(lefts, rights, kf_desc, kf_valid, kf_X, intr,
                       baseline, cfg: Config, ocfg) -> TrackOut:
    """High-rate tracking: F frames, all tracked against the SAME keyframe.
    Disparities come from one set of kernel launches over the F frames
    (`sgbm_frames`); features/matching/GN are frame-independent given a
    fixed keyframe, so they run per frame. Semantics caveat vs the
    sequential `step` loop: keyframe decisions apply only at chunk
    boundaries, so a keyframe born mid-chunk does not retarget the chunk's
    remaining frames. Returns TrackOut with a leading (F,) axis."""
    disp = sgbm_frames(lefts, rights, cfg)
    outs = [_track_core(lefts[f], disp[f], kf_desc, kf_valid, kf_X, intr,
                        baseline, ocfg) for f in range(lefts.shape[0])]
    return TrackOut(*(torch.stack(leaves) for leaves in zip(*outs)))


def batched_candidate_match(descs, valids, new_desc, new_valid,
                            min_similarity):
    """Loop-closure candidate matching for ALL stored keyframes at once:
    mutual-NN NCC over a stack of matrix products + per-candidate weighted
    match counts. descs (E, K, P), valids (E, K). Returns (idx_bs (E, K),
    goods (E, K), counts (E,))."""
    idx_bs, goods = match_descriptors(descs, new_desc, valids, new_valid,
                                      min_similarity=min_similarity)
    counts = (goods & valids).sum(dim=1).to(torch.int32)
    return idx_bs, goods, counts
