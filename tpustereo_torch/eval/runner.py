"""Evaluation runner: the pipeline on Middlebury / KITTI 2015 / synthetic
pairs, D1-all and bad-2.0 against the ground truth, and optionally the
delta to the golden NumPy SGBM and to OpenCV's StereoSGBM. The counterpart
of the JAX package's `eval/runner.py`, on `device` ("cuda" unless the
caller passes "cpu"; raises when CUDA is absent)."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from tpustereo_torch.api import _device
from tpustereo_torch.config import Config
from tpustereo_torch.eval.metrics import bad, d1_all, end_point_error


def _metrics(pred, gt) -> dict:
    return {"d1_all": round(d1_all(pred, gt), 5),
            "bad_2.0": round(bad(pred, gt, 2.0), 5),
            "bad_1.0": round(bad(pred, gt, 1.0), 5),
            "epe": round(end_point_error(pred, gt), 4)}


def _eval_one(left, right, gt, cfg: Config, name: str, compare_golden: bool,
              compare_opencv: bool, device) -> dict:
    """One pair's entry; the port's metrics sit under "tpu", the JAX
    report's key, so both packages' reports compare key for key."""
    from tpustereo_torch.api import match_pair
    disp = match_pair(left, right, cfg, device=device)
    entry = {"pair": name, "shape": list(left.shape)}
    if gt is not None:
        entry["tpu"] = _metrics(disp, gt)
    if compare_golden:
        from tpustereo_torch.golden import sgbm_numpy
        gdisp = sgbm_numpy(left, right, cfg)
        if gt is not None:
            entry["golden"] = _metrics(gdisp, gt)
        both = (disp >= 0) & (gdisp >= 0)
        entry["tpu_vs_golden_max_abs"] = float(
            np.abs(disp - gdisp)[both].max()) if both.any() else 0.0
    if compare_opencv:
        from tpustereo_torch.golden.opencv_ref import have_cv2, opencv_sgbm
        if not have_cv2():
            entry["opencv"] = "cv2 not installed"
        else:
            odisp = opencv_sgbm(left, right, cfg)
            if gt is not None:
                entry["opencv"] = _metrics(odisp, gt)
    return entry


def synthetic_cases(cfg: Config, shape) -> List[tuple]:
    """The runner's synthetic pairs at `shape`: (name, left, right, gt)
    with gt -1 where the truth is undefined, true disparities inside
    [0, D) (d(x) = d0 + slope * x)."""
    from tpustereo_torch.data.synthetic import synthetic_pair
    D = cfg.num_disparities
    cases = [(0.3 * D, 0.0), (0.25 * D, 0.2 * D / shape[1]),
             (0.5 * D, 0.3 * D / shape[1])]
    out = []
    for i, (d0, sl) in enumerate(cases):
        L, R, gt, valid = synthetic_pair(shape, disparity=d0, slope=sl,
                                         seed=i)
        out.append((f"synthetic_{i}", L, R,
                    np.where(valid & (gt > 0), gt, -1.0)))
    return out


def evaluate(cfg: Config, middlebury: Optional[str] = None,
             kitti2015: Optional[str] = None, kitti_indices: str = "0-9",
             half_res: bool = False, synthetic: bool = False,
             compare_golden: bool = False, compare_opencv: bool = False,
             device="cuda") -> dict:
    """Returns a structured report; aggregates mean metrics over pairs."""
    dev = _device(device)
    pairs: List[dict] = []

    if synthetic or not (middlebury or kitti2015):
        # full-size pairs on the card; small ones on the CPU (the JAX
        # runner's choice by backend)
        shape = (192, 320) if dev.type != "cpu" else (96, 160)
        for name, L, R, gt in synthetic_cases(cfg, shape):
            pairs.append(_eval_one(L, R, gt, cfg, name, compare_golden,
                                   compare_opencv, dev))

    if middlebury:
        from tpustereo_torch.data.datasets import load_middlebury_pair
        L, R, gt = load_middlebury_pair(middlebury, half_res=half_res)
        pairs.append(_eval_one(L, R, gt, cfg, middlebury,
                               compare_golden, compare_opencv, dev))

    if kitti2015:
        from tpustereo_torch.data.datasets import load_kitti2015_pair
        lo, _, hi = kitti_indices.partition("-")
        for idx in range(int(lo), int(hi or lo) + 1):
            L, R, gt = load_kitti2015_pair(kitti2015, idx)
            pairs.append(_eval_one(L, R, gt, cfg, f"kitti2015_{idx:06d}",
                                   compare_golden, compare_opencv, dev))

    report = {"config": dataclasses.asdict(cfg), "pairs": pairs,
              "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S")}
    keyed = [p["tpu"] for p in pairs if "tpu" in p]
    if keyed:
        report["mean"] = {k: round(float(np.mean([m[k] for m in keyed])), 5)
                          for k in keyed[0]}
    return report
