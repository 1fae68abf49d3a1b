"""Synthetic rectified stereo pairs and sequences with analytic ground truth
(numpy only; a copy of the JAX package's `synthetic_pair` and
`synthetic_sequence`, so both packages draw the same frames from the same
seed).

Level-3 oracle (SURVEY.md §5.0): on these pairs the true disparity is known
in closed form, so every matcher (golden NumPy, OpenCV, the TPU pipeline)
can be validated absolutely, not just against each other.

Geometry convention (shared with the whole framework): the left pixel (y, x)
matches the right pixel (y, x - d(y, x)), d >= 0. The right image is
resampled from a continuous band-limited texture T so that the
correspondence holds exactly: right(y, xr) = T(y, xl(xr)) with
xr = xl - d(xl).
"""

from __future__ import annotations

import numpy as np


def _texture(H: int, W: int, seed: int, oversample: int = 4) -> np.ndarray:
    """Continuous texture as a dense fine grid (linear interp between
    samples), band-limited by box smoothing so interpolation is benign."""
    rng = np.random.default_rng(seed)
    fine = rng.uniform(0.0, 1.0, size=(H, W * oversample + oversample))
    # horizontal smoothing (3 passes of width-`oversample` box filter)
    k = oversample * 2 + 1
    for _ in range(3):
        pad = np.pad(fine, ((0, 0), (k // 2, k // 2)), mode="wrap")
        cs = np.pad(pad.cumsum(axis=1), ((0, 0), (1, 0)))
        fine = (cs[:, k:] - cs[:, :-k]) / k
    u = np.arange(fine.shape[1]) / oversample
    # add deterministic sinusoids for large-scale structure
    yy = np.arange(H)[:, None]
    fine = fine + 0.3 * np.sin(2 * np.pi * u[None, :] / 23.0 + yy / 17.0)
    fine = fine + 0.2 * np.sin(2 * np.pi * u[None, :] / 7.3)
    return fine  # index with u*oversample


def _sample(tex: np.ndarray, u: np.ndarray, oversample: int = 4) -> np.ndarray:
    """Sample texture rows at continuous horizontal coordinates u (H, W)."""
    H = tex.shape[0]
    pos = np.clip(u * oversample, 0, tex.shape[1] - 1 - 1e-6)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0
    rows = np.arange(H)[:, None]
    return tex[rows, i0] * (1 - frac) + tex[rows, i0 + 1] * frac


def synthetic_pair(shape=(96, 128), disparity=8.0, slope=0.0, seed=0,
                   noise=0.0):
    """Build (left, right, gt_disparity, valid_mask).

    disparity: base disparity a; slope: b in d(x) = a + b*x (so the true
    surface is a slanted plane). Pixels whose match falls outside the right
    image are marked invalid in the mask.
    Returns uint8 images (H, W), float32 gt, bool mask.
    """
    H, W = shape
    a, b = float(disparity), float(slope)
    assert b < 1.0, "slope must be < 1 for invertibility"
    tex = _texture(H, W + int(abs(a)) + int(abs(b) * W) + 8, seed)

    xl = np.broadcast_to(np.arange(W, dtype=np.float64)[None, :], (H, W))
    d = a + b * xl  # ground-truth disparity on the left image
    left = _sample(tex, xl)
    # right(y, xr) = T(xl(xr)) with xl = (xr + a) / (1 - b)
    xr = np.broadcast_to(np.arange(W, dtype=np.float64)[None, :], (H, W))
    right = _sample(tex, (xr + a) / (1.0 - b))

    def to_u8(img):
        lo, hi = tex.min(), tex.max()
        return np.clip((img - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)

    left_u8, right_u8 = to_u8(left), to_u8(right)
    if noise > 0:
        rng = np.random.default_rng(seed + 1)
        left_u8 = np.clip(left_u8 + rng.normal(0, noise, (H, W)), 0, 255).astype(np.uint8)
        right_u8 = np.clip(right_u8 + rng.normal(0, noise, (H, W)), 0, 255).astype(np.uint8)

    valid = (xl - d) >= 0.0  # match inside the right image
    return left_u8, right_u8, d.astype(np.float32), valid


def synthetic_sequence(n_frames: int = 8, shape=(96, 128), depth: float = 8.0,
                       fx: float = 200.0, baseline: float = 0.5,
                       step_x: float = 0.1, slant: float = 0.3,
                       seed: int = 0, cam_xs=None):
    """Geometrically consistent stereo sequence: a textured world plane
    Z(U) = depth + slant*U viewed by a camera translating along +x by
    `step_x` metres per frame. All views are exact closed-form resamplings
    of one texture, ground-truth poses are known, and the slant gives the
    scene depth variation — a fronto-parallel plane under a narrow FOV
    makes x-translation and yaw nearly indistinguishable, which is a scene
    degeneracy, not an estimator bug (SURVEY.md §4.4).

    Returns (calib, [(left, right)...], gt_poses (n, 4, 4) world<-cam).

    Geometry: pixel x of a camera at world x = c sees the plane point with
    U solving (U - c)/Z(U) = xi, xi = (x - cx)/fx:
        U = (c + xi*depth) / (1 - xi*slant).

    cam_xs: explicit camera x positions per frame (overrides n_frames /
    step_x) — e.g. an out-and-back loop for loop-closure tests.
    """
    from tpustereo_torch.data.datasets import KittiCalib
    H, W = shape
    cx = W / 2.0
    scale = fx / depth                 # texture pixels per world metre
    xs = np.broadcast_to(np.arange(W, dtype=np.float64)[None, :], (H, W))
    xi = (xs - cx) / fx

    def u_of(cam_x):
        return (cam_x + xi * depth) / (1.0 - xi * slant)

    # texture span: U across all frames/cameras, converted to tex pixels
    if cam_xs is None:
        cam_xs = [i * step_x for i in range(n_frames)]
    cam_xs = [float(c) for c in cam_xs]
    n_frames = len(cam_xs)
    cams = list(cam_xs)
    cams += [c + baseline for c in cams]
    u_min = min(float(u_of(c).min()) for c in cams)
    u_max = max(float(u_of(c).max()) for c in cams)
    span = int(np.ceil((u_max - u_min) * scale)) + 8
    tex = _texture(H, span, seed)
    lo, hi = tex.min(), tex.max()

    def render(cam_x):
        coords = (u_of(cam_x) - u_min) * scale
        img = _sample(tex, coords)
        return np.clip((img - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)

    frames = []
    poses = np.zeros((n_frames, 4, 4), np.float32)
    for i, c in enumerate(cam_xs):
        frames.append((render(c), render(c + baseline)))
        poses[i] = np.eye(4)
        poses[i][0, 3] = c
    calib = KittiCalib(fx=fx, fy=fx, cx=cx, cy=H / 2.0, baseline=baseline)
    return calib, frames, poses
