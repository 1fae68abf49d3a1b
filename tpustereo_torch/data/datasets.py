"""Stereo calibration for KITTI odometry sequences (numpy only; a copy of
the JAX package's `KittiCalib` and `parse_kitti_odometry_calib`).

The image loaders of the JAX `data/datasets.py` are not ported yet: they
read through cv2, and the port's data I/O is still to come (ROADMAP.md,
queue 1, item 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class KittiCalib:
    """Stereo calibration: focal length (px), baseline (m), principal point."""
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float

    def depth_from_disparity(self, disp: np.ndarray) -> np.ndarray:
        """Z = f*B/d; invalid (d<=0) -> 0."""
        z = np.where(disp > 0, self.fx * self.baseline / np.maximum(disp, 1e-6), 0.0)
        return z.astype(np.float32)


def parse_kitti_odometry_calib(path: str) -> KittiCalib:
    """Parse a KITTI odometry `calib.txt` (P0..P3 rows). Baseline from
    P0/P1 (gray pair): B = -P1[0,3]/fx."""
    mats = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            arr = np.fromstring(vals, sep=" ")
            if arr.size == 12:
                mats[key.strip()] = arr.reshape(3, 4)
    p0, p1 = mats["P0"], mats["P1"]
    fx, fy = p0[0, 0], p0[1, 1]
    return KittiCalib(fx=fx, fy=fy, cx=p0[0, 2], cy=p0[1, 2],
                      baseline=-p1[0, 3] / fx)
