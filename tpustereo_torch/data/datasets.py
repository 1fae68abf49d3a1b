"""Dataset loaders: Middlebury pairs + PFM ground truth, KITTI 2015
training pairs, KITTI odometry sequences + calibration (numpy only; a copy
of the JAX package's `data/datasets.py`, reading through the port's own
codec, `data/io.py`).

No dataset ships with the repository; loaders take explicit roots and
raise FileNotFoundError when a file is absent. `data.synthetic` covers
everything else.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from tpustereo_torch.data.io import (read_image_gray, read_kitti_disparity,
                                     read_pfm)


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


def load_middlebury_pair(scene_dir: str, half_res: bool = False):
    """Middlebury 2014-layout scene dir: im0.png/im1.png + disp0*.pfm.
    Returns (left, right, gt or None). gt invalid = inf/0 -> -1."""
    left = read_image_gray(os.path.join(scene_dir, "im0.png"))
    right = read_image_gray(os.path.join(scene_dir, "im1.png"))
    gt = None
    for name in ("disp0GT.pfm", "disp0.pfm"):
        p = os.path.join(scene_dir, name)
        if os.path.exists(p):
            gt = read_pfm(p)
            gt = np.where(np.isfinite(gt) & (gt > 0), gt, -1.0).astype(np.float32)
            break
    if half_res:
        left, right = left[::2, ::2], right[::2, ::2]
        if gt is not None:
            gt = np.where(gt[::2, ::2] > 0, gt[::2, ::2] / 2.0, -1.0)
    return left, right, gt


def load_kitti2015_pair(root: str, index: int, training: bool = True):
    """KITTI 2015 layout: {root}/{training|testing}/image_2/xxxxxx_10.png,
    image_3/..., disp_occ_0/xxxxxx_10.png. Returns (left, right, gt|None)."""
    split = "training" if training else "testing"
    name = f"{index:06d}_10.png"
    left = read_image_gray(os.path.join(root, split, "image_2", name))
    right = read_image_gray(os.path.join(root, split, "image_3", name))
    gt = None
    gt_path = os.path.join(root, split, "disp_occ_0", name)
    if training and os.path.exists(gt_path):
        gt = read_kitti_disparity(gt_path)
    return left, right, gt


def kitti_odometry_sequence(root: str, sequence: str = "00",
                            max_frames: Optional[int] = None,
                            prefetch: int = 2,
                            ) -> Tuple[KittiCalib, Iterator[Tuple[np.ndarray, np.ndarray]]]:
    """KITTI odometry layout: {root}/sequences/{seq}/image_0, image_1,
    calib.txt. Yields (left, right) uint8 frames in order.

    prefetch > 0: a thread decodes that many pairs ahead of the consumer
    (`data.prefetch.prefetch_pairs`), so the odometry loop's device step
    does not wait on file IO. 0 = synchronous."""
    seq_dir = os.path.join(root, "sequences", sequence)
    calib = parse_kitti_odometry_calib(os.path.join(seq_dir, "calib.txt"))
    left_dir = os.path.join(seq_dir, "image_0")
    names = sorted(os.listdir(left_dir))
    if max_frames is not None:
        names = names[:max_frames]
    paths = [(os.path.join(left_dir, n), os.path.join(seq_dir, "image_1", n))
             for n in names]

    if prefetch > 0:
        from tpustereo_torch.data.prefetch import prefetch_pairs
        return calib, prefetch_pairs(paths, depth=prefetch)

    def gen():
        for lp, rp in paths:
            yield read_image_gray(lp), read_image_gray(rp)

    return calib, gen()
