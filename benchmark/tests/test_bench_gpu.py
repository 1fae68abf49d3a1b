"""The harness on the card at a reduced size, for each traffic mix: the
port's kernels come out correct and the control (the reference in
bfloat16 in the program's place) does not. They skip without a card:

    python -m pytest -p no:cacheprovider -o addopts="" -m gpu \
        benchmark/tests/test_bench_gpu.py
"""

import time

import numpy as np
import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.gpu


def _cell(name):
    cell = harness.load_cell(name)
    cell.config["shape"] = [120, 400]
    cell.traffic.update(pool=2 * cell.traffic["batch"], warmup_calls=2,
                        check_megapixels=0.5)
    return cell


@pytest.mark.parametrize("name", ["kitti_sgm8.stream-b8",
                                  "middlebury_sgm4.stream-b8",
                                  "kitti_sgm8.live-b1",
                                  "kitti_sgm8.api-b8",
                                  "kitti_odometry.exact-b1"])
def test_card_run_correct_and_control_not(cuda, name):
    cell = _cell(name)
    r = harness.run(cell, 2 ** 31 + 7, 1.0, True, cuda, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and set(r["metrics"]) == set(
        cell.metrics)
    if "api.copy_link_pct" in cell.metrics:
        assert 0 < r["metrics"]["api.copy_link_pct"]["value"] <= 100
    r = harness.run(cell, 2 ** 31 + 8, 0.5, False, cuda,
                    time.perf_counter(),
                    entry=harness.control_entry(cell, cuda))
    assert not r["correct"], r["checks"]


def test_host_inputs_unpinned_and_equal_to_the_card_pool(cuda):
    pool, inputs = harness.make_inputs(_cell("kitti_sgm8.api-b8"),
                                       2 ** 31 + 9, cuda)
    assert pool["left"].is_cuda
    for k in ("left", "right"):
        assert isinstance(inputs[k], np.ndarray)
        assert not torch.from_numpy(inputs[k]).is_pinned()
        assert np.array_equal(inputs[k], pool[k].cpu().numpy())
