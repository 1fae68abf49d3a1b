"""The readings that the limits of `correct` are set from, at a cell's own
size, on the card, several seeds in one process:

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --entry program|control --seconds <s>

`program` runs the cell's entry as the benchmark does (a short window,
then the check); `control` puts the reference computed in bfloat16, the
nearest precision below the configuration's float32 subpixel stage, in
the program's place. Each seed prints one JSON line: its readings and
whether the run came out correct. The benchmark's own runs never run the
control.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or ".") != os.path.dirname(
                   os.path.abspath(__file__))]
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import sgbm_ref  # noqa: E402


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--entry", choices=("program", "control"),
                    required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(a.workload)
    pinned = cell.config["pinned"]

    def control(left, right, cfg):
        return sgbm_ref.sgbm_frames(left, right, pinned,
                                    harness.REF_MAX_CELLS, torch.bfloat16)
    entry = control if a.entry == "control" else None
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run(cell, seed, a.seconds, False, "cuda", t0,
                        entry=entry)
        print(json.dumps({"workload": a.workload, "entry": a.entry,
                          "seed": seed, "correct": r["correct"],
                          "readings": {k: v["value"]
                                       for k, v in r["checks"].items()},
                          "frames": r["attempted"],
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
