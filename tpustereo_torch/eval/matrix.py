"""The evaluation matrix: the JAX package's `scripts/gen_eval_md.py` on the
port. Thirteen operating points (every preset, `min_disparity`, census 9x7
in 62-bit words, adaptive P2, both gap fills, D = 256 and 512, SAD with the
LR check and `min_disparity`), each on three synthetic pairs with analytic
truth: mean D1-all, bad-2.0, bad-1.0 and EPE, and the largest |pipeline -
golden| over the pixels both leave valid.

    python -m tpustereo_torch.eval.matrix [--device cpu] [--out PATH]

prints each row's record and the markdown table of `EVAL.md`, and writes
the records as JSON only where `--out` says. It runs on the card unless
given `--device cpu`, and raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Iterable, List, Optional

import numpy as np

from tpustereo_torch.api import _device
from tpustereo_torch.config import PRESETS
from tpustereo_torch.eval.runner import _eval_one, synthetic_cases

K = PRESETS["kitti_sgm8"].replace(frames_per_step=1)

# (row name, config, custom shape or None -> the runner's CPU cases), the
# rows of `scripts/gen_eval_md.py` and the keys of `scripts/eval_head.json`
ROWS = [
    ("tsukuba_sad (D=64, SAD block 9)", PRESETS["tsukuba_sad"], None),
    ("middlebury_census_wta (D=128)", PRESETS["middlebury_census_wta"], None),
    ("middlebury_sgm4 (4-path, D=128)",
     PRESETS["middlebury_sgm4"].replace(frames_per_step=1), None),
    ("kitti_sgm8 (8-path, D=128)", K, None),
    ("kitti_odometry (cfg-5 knobs)",
     PRESETS["kitti_odometry"].replace(strips=1), None),
    ("kitti_sgm8 + min_disparity=16", K.replace(min_disparity=16), None),
    ("kitti_sgm8 + census 9x7 (62-bit)", K.replace(census_window=(9, 7)),
     None),
    ("kitti_sgm8 + adaptive P2", K.replace(adaptive_p2=True), None),
    ("kitti_sgm8 + fill=background", K.replace(fill_mode="background"),
     None),
    ("kitti_sgm8 + fill=hirschmuller",
     K.replace(fill_mode="hirschmuller"), None),
    ("kitti_sgm8 at D=256", K.replace(num_disparities=256), (96, 320)),
    ("kitti_sgm8 at D=512", K.replace(num_disparities=512), (96, 640)),
    ("tsukuba_sad + LR + min_disp=8",
     PRESETS["tsukuba_sad"].replace(disp12_max_diff=1, min_disparity=8),
     None),
]

# the runner's synthetic cases on the CPU, at which `eval_head.json` was made
DEFAULT_SHAPE = (96, 160)


def row_cases(cfg, shape=None) -> List[tuple]:
    """A row's pairs as (name, left, right, gt), gt -1 where undefined:
    the runner's cases at `DEFAULT_SHAPE`, or at a custom shape the
    script's `custom_eval` cases (d0 = 0.3, 0.25 and 0.45 D, slopes 0 and
    0.2 D / W, seeds 0-2)."""
    if shape is None:
        return synthetic_cases(cfg, DEFAULT_SHAPE)
    from tpustereo_torch.data.synthetic import synthetic_pair
    D = cfg.num_disparities
    sl = 0.2 * D / shape[1]
    out = []
    for i, (d0, s) in enumerate([(0.3 * D, 0.0), (0.25 * D, sl),
                                 (0.45 * D, sl)]):
        L, R, gt, valid = synthetic_pair(shape, disparity=d0, slope=s,
                                         seed=i)
        out.append((f"synthetic_{i}", L, R,
                    np.where(valid & (gt > 0), gt, -1.0)))
    return out


def run_matrix(device="cuda", rows: Optional[Iterable[str]] = None) -> dict:
    """{row name: {"mean", "golden_max_abs", "pairs", "wall_s"}}, the
    records of `scripts/eval_head.json`, for every row or those named in
    `rows`. Each pair goes through `runner._eval_one` with the golden."""
    dev = _device(device)
    names = [n for n, _, _ in ROWS]
    wanted = names if rows is None else list(rows)
    unknown = sorted(set(wanted) - set(names))
    if unknown:
        raise KeyError(f"no such rows: {unknown}; known: {names}")
    out = {}
    for name, cfg, shape in ROWS:
        if name not in wanted:
            continue
        t = time.time()
        pairs = [_eval_one(L, R, gt, cfg, pname, True, False, dev)
                 for pname, L, R, gt in row_cases(cfg, shape)]
        keyed = [p["tpu"] for p in pairs]
        out[name] = {
            "mean": {k: round(float(np.mean([m[k] for m in keyed])), 5)
                     for k in keyed[0]},
            "golden_max_abs": max(p["tpu_vs_golden_max_abs"] for p in pairs),
            "pairs": len(pairs), "wall_s": round(time.time() - t, 1)}
    return out


def table(records: dict) -> str:
    """The markdown table of `EVAL.md`, one line a row."""
    lines = [
        "| Operating point | pairs | mean D1-all | mean bad-2.0 | mean EPE"
        " | max |pipeline − golden| |",
        "|---|---|---|---|---|---|",
    ]
    for name, r in records.items():
        m = r["mean"]
        lines.append(
            f"| {name} | {r['pairs']} | {m['d1_all']:.4f} |"
            f" {m['bad_2.0']:.4f} | {m['epe']:.4f} |"
            f" {r['golden_max_abs']:.1e} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpustereo_torch.eval.matrix",
        description="the 13-row evaluation matrix against the golden SGBM")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--out", help="write the records as JSON to this path")
    args = p.parse_args(argv)
    t0 = time.time()
    records = {}
    for name, _, _ in ROWS:
        records.update(run_matrix(args.device, [name]))
        print(name, records[name], flush=True)
    print("total", round(time.time() - t0, 1), "s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    print(table(records))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
