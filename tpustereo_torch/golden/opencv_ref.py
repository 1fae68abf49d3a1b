"""OpenCV StereoSGBM/StereoBM adapters — level-2 oracle (a copy of the JAX
package's `golden/opencv_ref.py`, over the port's `Config`).

OpenCV uses a Birchfield–Tomasi cost (not census), so agreement with the
pipeline is expected at the disparity-map / metric level (bad-pixel
bounds), not per stage. These adapters normalise OpenCV's int16
disparity*16 output to the float32 / invalid=-1 convention. cv2 is
imported when an adapter runs: a machine without it (the card machine has
none) imports this module, and `have_cv2()` says whether it can run.
"""

from __future__ import annotations

import importlib.util

import numpy as np

from tpustereo_torch.config import Config
from tpustereo_torch.golden.sgbm_numpy import INVALID


def have_cv2() -> bool:
    return importlib.util.find_spec("cv2") is not None


def _norm(raw: np.ndarray, min_disparity: int) -> np.ndarray:
    disp = raw.astype(np.float32) / 16.0
    disp[raw < min_disparity * 16] = INVALID
    return disp


def opencv_sgbm(left: np.ndarray, right: np.ndarray, cfg: Config) -> np.ndarray:
    """cv2.StereoSGBM; MODE_HH for 8-path parity, MODE_SGBM for 5-path."""
    import cv2
    mode = cv2.STEREO_SGBM_MODE_HH if cfg.paths == 8 else cv2.STEREO_SGBM_MODE_SGBM
    m = cv2.StereoSGBM.create(
        minDisparity=cfg.min_disparity,
        numDisparities=cfg.num_disparities,
        blockSize=5,
        P1=8 * 25,
        P2=32 * 25,
        disp12MaxDiff=cfg.disp12_max_diff,
        uniquenessRatio=cfg.uniqueness_ratio,
        speckleWindowSize=cfg.speckle_window_size,
        speckleRange=cfg.speckle_range,
        mode=mode,
    )
    # NB cv2 5.0 compute() signature: compute(left, right) -> disparity
    raw = m.compute(left, right)
    return _norm(raw, cfg.min_disparity)


def opencv_bm(left: np.ndarray, right: np.ndarray, cfg: Config) -> np.ndarray:
    """cv2.StereoBM (SAD block matching) for config-1 parity."""
    import cv2
    m = cv2.StereoBM.create(numDisparities=cfg.num_disparities,
                            blockSize=cfg.sad_block)
    raw = m.compute(left, right)
    return _norm(raw, cfg.min_disparity)
