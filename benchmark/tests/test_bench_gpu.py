"""The harness on the card at a reduced size, for each traffic mix: the
port's kernels come out correct and the control (the reference in
bfloat16 in the program's place) does not. They skip without a card:

    python -m pytest -p no:cacheprovider -o addopts="" -m gpu \
        benchmark/tests/test_bench_gpu.py
"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import sgbm_ref

pytestmark = pytest.mark.gpu


def _cell(name):
    cell = harness.load_cell(name)
    cell.config["shape"] = [120, 400]
    cell.traffic.update(pool=2 * cell.traffic["batch"], warmup_calls=2,
                        check_megapixels=0.5)
    return cell


@pytest.mark.parametrize("name", ["kitti_sgm8.stream-b8",
                                  "middlebury_sgm4.stream-b8",
                                  "kitti_sgm8.live-b1"])
def test_card_run_correct_and_control_not(cuda, name):
    cell = _cell(name)
    r = harness.run(cell, 2 ** 31 + 7, 1.0, True, cuda, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and set(r["metrics"]) == set(
        cell.metrics)

    def control(left, right, cfg):
        return sgbm_ref.sgbm_frames(left, right, cell.config["pinned"],
                                    subpixel_dtype=torch.bfloat16)
    r = harness.run(cell, 2 ** 31 + 8, 0.5, False, cuda,
                    time.perf_counter(), entry=control)
    assert not r["correct"], r["checks"]
