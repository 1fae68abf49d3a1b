"""Headline benchmark of the port, the counterpart of the root `bench.py`:
SGM 8-path, the full `kitti_sgm8` pipeline at KITTI 2015 geometry
(375x1242, D=128), frames/s on one card.

    python -m tpustereo_torch.bench [batch iters runs]   # 16 20 3

Prints ONE JSON line with `bench.py`'s keys:
  {"metric": ..., "value": N, "unit": "fps/chip", "vs_baseline": N,
   "runs": N, "spread": [lo, hi]}
`value` is the mean of `runs` timed loops of `iters` batches each (CUDA
events, after a warm-up that builds the kernels), `spread` their lowest
and highest; vs_baseline is against the OpenCV CPU proxy (2.72 frames/s,
BASELINE.md). Needs a CUDA card.
"""

import json
import sys


def main(argv=None):
    from tpustereo_torch.config import PRESETS
    from tpustereo_torch.eval.bench import BASELINE_FPS, run_benchmark

    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if len(argv) > 0 else 16
    iters = int(argv[1]) if len(argv) > 1 else 20
    runs = int(argv[2]) if len(argv) > 2 else 3
    records = [run_benchmark(PRESETS["kitti_sgm8"], shape=(375, 1242),
                             batch=batch, iters=iters)
               for _ in range(max(1, runs))]
    vals = sorted(r["value"] for r in records)
    mean = sum(vals) / len(vals)
    line = {"metric": records[0]["metric"], "value": round(mean, 3),
            "unit": records[0]["unit"],
            "vs_baseline": round(mean / BASELINE_FPS, 2),
            "runs": len(vals), "spread": [vals[0], vals[-1]]}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
