"""Synthetic rectified stereo pairs with analytic ground truth (numpy only;
a copy of the JAX package's `synthetic_pair`, so both packages draw the same
pairs from the same seed).

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
