"""Bytes and operations roofline of the stereo pipeline on a Hopper card:
what share of the card's memory rate and integer rate a measured frame
time reaches. The counterpart of the JAX package's `eval/roofline.py`,
whose model counts TPU vector element-ops and lane rolls on the padded
slabs of its Pallas kernels; none of that carries over to the H100.

The model counts the WORK of a frame from `cfg` and its shape alone:

* bytes: each stage of the JAX function decomposition (the census cost
  volume; the directional sweeps into S; the backward sweep fused with
  WTA; the LR check; speckle; the fill; the median — `sgm_select_pallas`
  and `_postproc_frames`) reads each of its inputs once and writes each
  of its outputs once, as `chip_smoke.py` reckons a kernel's bound. The
  stages' intermediate volumes (C uint8, S int16) are in it; the kernels'
  re-reads are not.
* integer operations: the SGM recurrence's path-cell updates (paths x H x
  W x D) times `SGM_OPS_PER_UPDATE`; for SAD the absolute differences and
  window sums, H x W x D x `SAD_OPS_PER_CELL`; for census + WTA the cost
  and the selection, H x W x D x (`COST_OPS_PER_CELL` +
  `WTA_OPS_PER_CELL`).

None of it depends on which kernels implement the stages, on the route
toggles (`kernels.sgm.BIDIR_VERT`, `ops.postproc.BITONIC_SPECKLE`), on
tiling or on how the work is split into launches, so a redesign moves the
measured time against a fixed yardstick. The counts are a floor of the
work, not of what a kernel moves: the port's sweeps of a set (two fused
passes and E) each read all of C, so a share well under 1 says how much
traffic a design adds.

`device_busy_fraction` reads a `torch.profiler` Chrome trace: the span
from the first device kernel's start to the last one's end, and the share
of it in which a kernel, copy or fill ran (the union of their intervals);
a trace with fewer kernel events than the port's wrappers launched is
refused, not read.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterable, Optional, Tuple

from tpustereo_torch.config import Config

# H100 SXM (NVIDIA's data sheet, dense, at the 700 W power limit): HBM3 at
# 3.35 TB/s; 67e12 operations/s outside the tensor cores (the float32
# rate, which the integer pipe's adds, mins and selects do not exceed).
H100_SXM = {"name": "H100 SXM", "hbm_bytes_per_s": 3.35e12,
            "int_ops_per_s": 67e12}

# One SGM path-cell update, L_r(p, d) = C(p, d) + min(L(d), L(d-1) + P1,
# L(d+1) + P1, min_k L + P2) - min_k L: two adds of P1, three mins, the
# add of C, the subtract of the previous minimum, its share of the min
# over d, and the add into S.
SGM_OPS_PER_UPDATE = 9
# SAD per (pixel, disparity): the difference and its absolute value, then
# the separable running window sums (an add and a subtract an axis).
SAD_OPS_PER_CELL = 6
# census + Hamming per cost: xor, popcount, the out-of-image compare and
# select; WTA per cost: the compare and select of the running minimum.
COST_OPS_PER_CELL = 4
WTA_OPS_PER_CELL = 2

# the stages that `production_stage_times`'s "core(cost+sweeps+wta)" row
# times: everything before the LR check and post-processing
CORE_STAGES = ("cost", "sweeps", "select")


def chip_spec(device_name: str) -> Optional[dict]:
    """The peaks of a card by its `torch.cuda.get_device_name`; None for a
    card (or "cpu") the model has no figures for. Only the SXM H100 is
    known ("NVIDIA H100 80GB HBM3"): the PCIe and NVL parts run other
    clocks and memory."""
    n = device_name or ""
    if "H100" in n and ("HBM3" in n or "SXM" in n):
        return H100_SXM
    return None


def bound(nbytes: float, ops: float, spec: dict = H100_SXM
          ) -> Tuple[float, str]:
    """(least ms the card needs for nbytes moved and ops integer
    operations, which of "bytes" / "operations" binds)."""
    t_bytes = nbytes / spec["hbm_bytes_per_s"] * 1e3
    t_ops = ops / spec["int_ops_per_s"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _postproc_bytes(cfg: Config, n: int, lr_in: int) -> Dict[str, int]:
    """The stages after selection, per frame of n pixels: the LR check
    (lr_in bytes a pixel of right-view map and disparity read, ok
    written, and the hits map with the Hirschmueller fill), speckle
    (disparity + valid read, the masked map written), the fill and the
    median (float32 in and out)."""
    out: Dict[str, int] = {}
    if cfg.disp12_max_diff >= 0:
        hits = cfg.fill_mode == "hirschmuller"
        out["lr_check"] = (lr_in + 1 + hits) * n
    out["speckle"] = (4 + 1 + 4) * n
    if cfg.fill_mode == "background":
        out["fill"] = 8 * n
    elif cfg.fill_mode == "hirschmuller":
        out["fill"] = 9 * n
    if cfg.median_filter:
        out["median"] = 8 * n
    return out


def sgm_ops_model(cfg: Config, shape: Tuple[int, int]) -> Optional[dict]:
    """Per-frame bytes and operations of the SGM pipeline; None for
    another mode. Stages: the census cost (images in, C out), the sweeps
    of paths - 1 directions (C in, S out), the backward sweep fused with
    WTA (C and S in; disparity, valid and the right-view map out), then
    the LR check and post-processing."""
    if cfg.mode != "sgm":
        return None
    H, W = shape
    n = H * W
    cells = n * cfg.num_disparities
    hbm = {"cost": 2 * n + cells, "sweeps": cells + 2 * cells,
           "select": 3 * cells + 9 * n}
    hbm.update(_postproc_bytes(cfg, n, 8))
    updates = cfg.paths * cells
    return {"shape": [H, W], "paths": cfg.paths,
            "disparities": cfg.num_disparities,
            "path_cell_updates": updates,
            "int_ops_total": updates * SGM_OPS_PER_UPDATE,
            "hbm_bytes": hbm, "hbm_bytes_total": sum(hbm.values())}


def sad_ops_model(cfg: Config, shape: Tuple[int, int]) -> Optional[dict]:
    """Per-frame bytes and operations of the SAD pipeline; None for
    another mode. The plane sweep fused with WTA reads the images and
    writes disparity and valid (and the right-view map with the LR
    check): the volume never exists."""
    if cfg.mode != "sad":
        return None
    H, W = shape
    n = H * W
    cells = n * cfg.num_disparities
    lr = cfg.disp12_max_diff >= 0
    hbm = {"select": 2 * n + (5 + 4 * lr) * n}
    hbm.update(_postproc_bytes(cfg, n, 8))
    return {"shape": [H, W], "disparities": cfg.num_disparities,
            "block": cfg.sad_block, "cells": cells,
            "int_ops_total": cells * SAD_OPS_PER_CELL,
            "hbm_bytes": hbm, "hbm_bytes_total": sum(hbm.values())}


def census_wta_ops_model(cfg: Config, shape: Tuple[int, int]
                         ) -> Optional[dict]:
    """Per-frame bytes and operations of census + WTA; None for another
    mode. The census cost (images in, C out), then WTA with uniqueness,
    subpixel and the LR check over C (C in, disparity and valid out)."""
    if cfg.mode != "census_wta":
        return None
    H, W = shape
    n = H * W
    cells = n * cfg.num_disparities
    hbm = {"cost": 2 * n + cells, "select": cells + 5 * n}
    hbm.update(_postproc_bytes(cfg, n, 8))
    hbm.pop("lr_check", None)       # folded into the selection over C
    return {"shape": [H, W], "disparities": cfg.num_disparities,
            "cells": cells,
            "int_ops_total": cells * (COST_OPS_PER_CELL + WTA_OPS_PER_CELL),
            "hbm_bytes": hbm, "hbm_bytes_total": sum(hbm.values())}


def ops_model(cfg: Config, shape: Tuple[int, int]) -> dict:
    """The model of the configuration's mode."""
    return {"sgm": sgm_ops_model, "sad": sad_ops_model,
            "census_wta": census_wta_ops_model}[cfg.mode](cfg, shape)


def _util(nbytes: float, ops: float, sec: float, spec: dict) -> dict:
    return {"hbm_util": round(nbytes / sec / spec["hbm_bytes_per_s"], 6),
            "int_util": round(ops / sec / spec["int_ops_per_s"], 6)}


def roofline(cfg: Config, shape: Tuple[int, int], sec_per_frame: float,
             device_name: str = "",
             core_sec_per_frame: Optional[float] = None) -> Optional[dict]:
    """Utilization record of a measured frame time: achieved bytes/s and
    operations/s against the card's peaks. `bound` names the resource the
    model says binds (the larger of its two least times) and `share` is
    that least time over the frame's. With `core_sec_per_frame` (the
    differenced cost + sweeps + WTA time of `production_stage_times`),
    `core` holds the same for the model's core stages alone. For a card
    the model has no figures for, the record names the card and holds the
    model without shares."""
    if sec_per_frame <= 0:
        return None
    m = ops_model(cfg, shape)
    spec = chip_spec(device_name)
    rec = {"chip_assumed": spec["name"] if spec else None,
           "device_name": device_name,
           "hbm_peak_gbps": spec["hbm_bytes_per_s"] / 1e9 if spec else None,
           "int_peak_gops": spec["int_ops_per_s"] / 1e9 if spec else None,
           "model": m}
    if spec is None:
        return rec
    nbytes, ops = m["hbm_bytes_total"], m["int_ops_total"]
    rec["hbm_gbps_achieved"] = round(nbytes / sec_per_frame / 1e9, 3)
    rec["int_gops_achieved"] = round(ops / sec_per_frame / 1e9, 3)
    rec.update(_util(nbytes, ops, sec_per_frame, spec))
    least_ms, rec["bound"] = bound(nbytes, ops, spec)
    rec["share"] = round(least_ms / 1e3 / sec_per_frame, 6)
    if core_sec_per_frame and core_sec_per_frame > 0:
        core_bytes = sum(v for k, v in m["hbm_bytes"].items()
                         if k in CORE_STAGES)
        rec["core"] = _util(core_bytes, ops, core_sec_per_frame, spec)
    return rec


def shares(rec: dict) -> Dict[str, float]:
    """Every utilization share of a `roofline` record, by key."""
    out = {k: rec[k] for k in ("hbm_util", "int_util", "share") if k in rec}
    out.update({f"core.{k}": v for k, v in rec.get("core", {}).items()})
    return out


# ---------------------------------------------------------------------------
# the device's busy share, from a profiler's kernel intervals
# ---------------------------------------------------------------------------

def busy_share(intervals: Iterable[Tuple[str, float, float]]
               ) -> Optional[dict]:
    """Span, busy time and busy share of device intervals (name, start
    us, duration us): the span runs from the first one's start to the last
    one's end; busy is the length of their union, so intervals that
    overlap (two streams, or one event listed twice) count once and the
    share never passes 1 on its own. None when there are none."""
    ivs = sorted(intervals, key=lambda iv: iv[1])
    if not ivs:
        return None
    span = max(s + d for _, s, d in ivs) - ivs[0][1]
    busy, end = 0.0, ivs[0][1]
    for _, s, d in ivs:
        busy += max(0.0, s + d - max(s, end))
        end = max(end, s + d)
    by_name: Dict[str, float] = {}
    for name, _, d in ivs:
        by_name[name] = by_name.get(name, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "busy_fraction": round(busy / span, 6) if span > 0 else 1.0,
            "kernels": len(ivs),
            "top_ms": [(n[:60], round(us / 1e3, 4)) for n, us in top]}


# the Chrome trace categories of device work (kineto's names)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_fraction(trace_dir: str, min_kernels: int = 0
                         ) -> Optional[dict]:
    """`busy_share` of the newest Chrome trace (`*.json`, as
    `torch.profiler`'s `export_chrome_trace` writes it) under trace_dir;
    None when there is none, or it holds fewer than `min_kernels` kernel
    events (a session that recorded only part of the calls' launches:
    pass the launches the port's wrappers counted over them)."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.json"),
                      recursive=True)
    if not paths:
        return None
    with open(max(paths, key=os.path.getmtime)) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) \
        else trace
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in _DEVICE_CATS and "dur" in e]
    if sum(e["cat"] == "kernel" for e in device) < min_kernels:
        return None
    return busy_share((e.get("name", ""), float(e["ts"]), float(e["dur"]))
                      for e in device)
