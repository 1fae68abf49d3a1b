"""Stereo evaluation metrics (SURVEY.md §1.1, §3 #11); numpy only, a copy
of the JAX package's `eval/metrics.py`.

All metrics take float32 disparity maps with invalid = -1 (prediction) and
invalid <= 0 (ground truth), and an optional extra validity mask.
Pixels where the prediction is invalid count as errors (standard KITTI /
Middlebury protocol: missing estimates are penalised, not skipped).
"""

from __future__ import annotations

import numpy as np


def _gt_mask(gt: np.ndarray, mask=None) -> np.ndarray:
    m = gt > 0
    if mask is not None:
        m &= mask
    return m


def d1_all(pred: np.ndarray, gt: np.ndarray, mask=None) -> float:
    """KITTI 2015 D1: fraction of labeled pixels with error > 3 px AND
    > 5 % of the true disparity. Invalid predictions are errors."""
    m = _gt_mask(gt, mask)
    if not m.any():
        return float("nan")
    err = np.abs(pred - gt)
    bad_px = (err > 3.0) & (err > 0.05 * gt)
    bad_px |= pred < 0
    return float(bad_px[m].mean())


def bad(pred: np.ndarray, gt: np.ndarray, thresh: float = 2.0, mask=None) -> float:
    """Middlebury bad-τ: fraction of pixels with |d - d_gt| > τ.
    Invalid predictions are errors."""
    m = _gt_mask(gt, mask)
    if not m.any():
        return float("nan")
    bad_px = (np.abs(pred - gt) > thresh) | (pred < 0)
    return float(bad_px[m].mean())


def end_point_error(pred: np.ndarray, gt: np.ndarray, mask=None) -> float:
    """Mean absolute disparity error over pixels where both are valid."""
    m = _gt_mask(gt, mask) & (pred >= 0)
    if not m.any():
        return float("nan")
    return float(np.abs(pred - gt)[m].mean())


# ---------------------------------------------------------------------------
# trajectory metrics (SURVEY.md §4.4, §5.5; VERDICT r3 next #5)
# ---------------------------------------------------------------------------

def align_rigid(est_t: np.ndarray, gt_t: np.ndarray):
    """Least-squares rigid alignment (R, t) minimising
    Σ ||R·est_i + t − gt_i||² (Horn/Umeyama without scale — stereo
    odometry observes metric scale through the baseline, so a scale fit
    would hide calibration errors). est_t/gt_t: (n, 3)."""
    mu_e, mu_g = est_t.mean(axis=0), gt_t.mean(axis=0)
    H = (est_t - mu_e).T @ (gt_t - mu_g)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    Rm = Vt.T @ S @ U.T
    return Rm, mu_g - Rm @ mu_e


def ate(traj: np.ndarray, gt: np.ndarray) -> dict:
    """Absolute trajectory error (TUM protocol): rigid-align the estimated
    positions to ground truth, then report translation-residual stats.
    traj/gt: (n, 4, 4) world<-cam pose mats (StereoOdometry.trajectory /
    synthetic_sequence gt / KITTI poses.txt rows)."""
    est_t, gt_t = traj[:, :3, 3], gt[:, :3, 3]
    if len(est_t) < 2:
        return {"rmse": 0.0, "mean": 0.0, "median": 0.0, "max": 0.0,
                "n": int(len(est_t))}
    Rm, t = align_rigid(est_t, gt_t)
    res = np.linalg.norm((est_t @ Rm.T + t) - gt_t, axis=1)
    return {"rmse": float(np.sqrt((res ** 2).mean())),
            "mean": float(res.mean()), "median": float(np.median(res)),
            "max": float(res.max()), "n": int(len(res))}


def _rot_angle_deg(Rm: np.ndarray) -> float:
    c = (np.trace(Rm) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def rpe(traj: np.ndarray, gt: np.ndarray, delta: int = 1) -> dict:
    """Relative pose error over frame gaps of `delta` (TUM protocol):
    E_i = (gt_i⁻¹ gt_{i+δ})⁻¹ (traj_i⁻¹ traj_{i+δ}); reports the
    translational RMSE (m) and rotational RMSE (deg) of the E_i."""
    n = len(traj)
    if n <= delta:
        return {"trans_rmse": 0.0, "rot_rmse_deg": 0.0, "n": 0,
                "delta": int(delta)}
    tr, rot = [], []
    for i in range(n - delta):
        d_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        d_es = np.linalg.inv(traj[i]) @ traj[i + delta]
        E = np.linalg.inv(d_gt) @ d_es
        tr.append(np.linalg.norm(E[:3, 3]))
        rot.append(_rot_angle_deg(E[:3, :3]))
    tr, rot = np.asarray(tr), np.asarray(rot)
    return {"trans_rmse": float(np.sqrt((tr ** 2).mean())),
            "rot_rmse_deg": float(np.sqrt((rot ** 2).mean())),
            "n": int(len(tr)), "delta": int(delta)}


def kitti_segment_errors(traj: np.ndarray, gt: np.ndarray,
                         lengths=(100, 200, 300, 400, 500, 600, 700, 800)
                         ) -> dict:
    """KITTI odometry protocol: average translational error (%) and
    rotational error (deg/m) over all subsequences of the given path
    lengths (meters along the GT path). Returns NaNs when the trajectory
    is shorter than the smallest segment (synthetic smoke sequences) —
    the number becomes meaningful on real KITTI data (EVAL.md)."""
    gt_t = gt[:, :3, 3]
    dist = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(gt_t, axis=0), axis=1))])
    t_errs, r_errs = [], []
    for L in lengths:
        for i in range(len(gt)):
            js = np.searchsorted(dist, dist[i] + L)
            if js >= len(gt):
                break
            d_gt = np.linalg.inv(gt[i]) @ gt[js]
            d_es = np.linalg.inv(traj[i]) @ traj[js]
            E = np.linalg.inv(d_gt) @ d_es
            t_errs.append(np.linalg.norm(E[:3, 3]) / L)
            r_errs.append(np.radians(_rot_angle_deg(E[:3, :3])) / L)
    if not t_errs:
        return {"t_err_pct": float("nan"), "r_err_deg_per_m": float("nan"),
                "n_segments": 0}
    return {"t_err_pct": float(100.0 * np.mean(t_errs)),
            "r_err_deg_per_m": float(np.degrees(np.mean(r_errs))),
            "n_segments": int(len(t_errs))}
