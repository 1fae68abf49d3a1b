"""The plain reference against the port's CPU path (its plain versions) and
the loop-literal NumPy golden, at a tiny size on the layered scenes; the
control (the reference in bfloat16) against it."""

import json
import os

import pytest
import torch

from benchmark import harness, scenes
from benchmark.reference import sgbm_ref


def _config(name, **pinned):
    f = os.path.join(harness.ROOT, "benchmark", "configs", name + ".json")
    data = json.load(open(f))
    data["pinned"] = dict(data["pinned"], **pinned)
    return data


@pytest.mark.parametrize("name", ["kitti_sgm8", "middlebury_sgm4"])
def test_reference_equals_the_port_on_the_cpu(name):
    from tpustereo_torch.pipeline import sgbm_batched
    data = _config(name, num_disparities=32)
    p = scenes.make_pool(data["scene"], 4, (48, 128), 32, 11, "cpu")
    ref = sgbm_ref.sgbm_frames(p["left"], p["right"], data["pinned"])
    out = sgbm_batched(p["left"], p["right"], harness.port_config(data))
    assert harness.compare(out, ref) == {"invalid_mismatch_px": 0,
                                         "disp_gap_px": 0.0}
    assert 0.02 < float((ref == -1).float().mean()) < 0.8


def test_reference_equals_the_golden():
    from tpustereo_torch.golden.sgbm_numpy import sgbm_numpy
    data = _config("kitti_sgm8", num_disparities=24, min_disparity=3)
    p = scenes.make_pool(data["scene"], 1, (40, 96), 24, 5, "cpu")
    ref = sgbm_ref.sgbm(p["left"], p["right"], data["pinned"])[0]
    gold = sgbm_numpy(p["left"][0].numpy(), p["right"][0].numpy(),
                      harness.port_config(data))
    assert torch.equal(torch.from_numpy(gold), ref)


def test_blocks_of_frames_change_nothing():
    data = _config("kitti_sgm8", num_disparities=16)
    p = scenes.make_pool(data["scene"], 3, (32, 64), 16, 9, "cpu")
    whole = sgbm_ref.sgbm_frames(p["left"], p["right"], data["pinned"])
    one = sgbm_ref.sgbm_frames(p["left"], p["right"], data["pinned"],
                               max_cells=1)
    assert torch.equal(whole, one)


def test_control_in_bfloat16_differs():
    data = _config("kitti_sgm8", num_disparities=64)
    p = scenes.make_pool(data["scene"], 2, (64, 192), 64, 13, "cpu")
    ref = sgbm_ref.sgbm_frames(p["left"], p["right"], data["pinned"])
    ctl = sgbm_ref.sgbm_frames(p["left"], p["right"], data["pinned"],
                               subpixel_dtype=torch.bfloat16)
    got = harness.compare(ctl, ref)
    assert got["disp_gap_px"] > data["check"]["disp_gap_px"]


def test_refused_configurations():
    data = _config("kitti_sgm8", adaptive_p2=True)
    x = torch.zeros((1, 8, 16), dtype=torch.uint8)
    with pytest.raises(NotImplementedError):
        sgbm_ref.sgbm(x, x, data["pinned"])
