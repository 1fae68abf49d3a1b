"""The frozen work model of one SGM frame, by stage, and the card's peaks.

A copy of the port's `eval/roofline.py` (`sgm_ops_model`,
`_postproc_bytes`, `bound`) kept under the benchmark, where a change to the
program cannot move it. It counts the WORK a frame needs from the
configuration and its shape alone: each stage reads each of its inputs once
and writes each of its outputs once (bytes), and the integer operations of
its arithmetic. It never looks at which kernels ran, so a redesign moves
only the measured side of a roofline share.

Operations by stage (the port's model puts all of them under the sweeps):

* cost: xor, popcount, the out-of-image compare and select a cell (4);
* sweeps: the paths - 1 directions before the backward sweep, 9 a
  path-cell update;
* select: the backward sweep's update (9) and WTA's compare and select (2)
  a cell.

A stage's least time is the larger of its bytes over the memory rate and
its operations over the integer rate.
"""

from __future__ import annotations

from typing import Dict

# H100 SXM (NVIDIA's data sheet, dense, at the 700 W power limit): HBM3 at
# 3.35 TB/s; 67e12 operations/s outside the tensor cores, the float32 FMA
# rate, which no integer add, min or select path exceeds (a ceiling: the
# 16-bit SIMD path issues about half of it)
PEAKS = {"name": "H100 SXM", "hbm_bytes_per_s": 3.35e12,
         "int_ops_per_s": 67e12}

SGM_OPS_PER_UPDATE = 9
COST_OPS_PER_CELL = 4
WTA_OPS_PER_CELL = 2


def postproc_bytes(pinned: dict, n: int, lr_in: int) -> Dict[str, int]:
    """Bytes of the stages after selection for a frame of n pixels: the LR
    check (lr_in bytes a pixel of right-view map and disparity read, ok
    written, the hits map with the Hirschmueller fill), speckle (disparity
    and valid read, the masked map written), the fill and the median
    (float32 in and out)."""
    out: Dict[str, int] = {}
    if pinned["disp12_max_diff"] >= 0:
        hits = pinned["fill_mode"] == "hirschmuller"
        out["lr_check"] = (lr_in + 1 + hits) * n
    out["speckle"] = (4 + 1 + 4) * n
    if pinned["fill_mode"] == "background":
        out["fill"] = 8 * n
    elif pinned["fill_mode"] == "hirschmuller":
        out["fill"] = 9 * n
    if pinned["median_filter"]:
        out["median"] = 8 * n
    return out


def sgm_frame(pinned: dict, shape) -> Dict[str, Dict[str, float]]:
    """{stage: {"bytes": b, "ops": o}} of one frame of an SGM
    configuration (the `pinned` fields of a configuration file)."""
    if pinned["mode"] != "sgm":
        raise ValueError(f"the work model covers mode 'sgm', not "
                         f"{pinned['mode']!r}")
    H, W = shape
    n = H * W
    cells = n * pinned["num_disparities"]
    stages = {
        "cost": {"bytes": 2 * n + cells, "ops": cells * COST_OPS_PER_CELL},
        "sweeps": {"bytes": cells + 2 * cells,
                   "ops": (pinned["paths"] - 1) * cells * SGM_OPS_PER_UPDATE},
        "select": {"bytes": 3 * cells + 9 * n,
                   "ops": cells * (SGM_OPS_PER_UPDATE + WTA_OPS_PER_CELL)},
    }
    for name, b in postproc_bytes(pinned, n, 8).items():
        stages[name] = {"bytes": b, "ops": 0}
    return stages


def bound(nbytes: float, ops: float, peaks: dict = PEAKS) -> float:
    """The least seconds the card needs for nbytes moved and ops integer
    operations: the larger of the two times."""
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["int_ops_per_s"])


def least_seconds(stages: Dict[str, Dict[str, float]], names) -> float:
    """The sum of the named stages' least times (a stage the configuration
    lacks, such as a fill, counts nothing)."""
    return sum(bound(stages[s]["bytes"], stages[s]["ops"])
               for s in names if s in stages)
