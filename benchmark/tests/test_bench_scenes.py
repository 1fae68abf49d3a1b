"""The layered scenes: fixed by the seed, every true disparity inside
[0, D), occluded strips, and the same amount of content on every seed."""

import json
import os

import pytest
import torch

from benchmark import harness, scenes


def _scene(config):
    f = os.path.join(harness.ROOT, "benchmark", "configs", config + ".json")
    return json.load(open(f))["scene"]


@pytest.mark.parametrize("config", ["kitti_sgm8", "middlebury_sgm4"])
def test_scenes_fixed_by_seed(config):
    sc = _scene(config)
    seed = 2 ** 31 + 12345
    a = scenes.make_pool(sc, 4, (64, 160), 48, seed, "cpu")
    b = scenes.make_pool(sc, 4, (64, 160), 48, seed, "cpu")
    c = scenes.make_pool(sc, 4, (64, 160), 48, seed + 1, "cpu")
    for k in ("left", "right", "disp", "occluded", "boxes"):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["left"], c["left"])
    assert a["left"].dtype == torch.uint8 and a["left"].shape == (4, 64, 160)
    assert sorted(a["boxes"].tolist()) == sorted(c["boxes"].tolist()) == \
        [3, 4, 5, 6]


@pytest.mark.parametrize("config", ["kitti_sgm8", "middlebury_sgm4"])
def test_disparities_in_range_with_occlusions(config):
    sc = _scene(config)
    D = 64
    p = scenes.make_pool(sc, 4, (96, 256), D, 7, "cpu")
    assert float(p["disp"].min()) >= 0 and float(p["disp"].max()) < D
    occ = p["occluded"].float().mean(dim=(1, 2))
    assert bool((occ > 0.005).all()), occ
    # the boxes stand nearer than what lies behind them
    assert float(p["disp"].max()) > 0.2 * D


def test_sky_is_low_texture():
    sc = _scene("kitti_sgm8")
    p = scenes.make_pool(sc, 2, (96, 256), 64, 3, "cpu")
    rows = int(sc["sky_rows"] * 96)
    sky = p["left"][:, :rows].float().std()
    ground = p["left"][:, -rows:].float().std()
    assert sky < 0.2 * ground
