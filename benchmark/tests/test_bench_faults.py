"""Whole runs of the harness on the CPU at a tiny size, with the look for a
card skipped: the port's plain path comes out correct; the control (the
reference computed in bfloat16, put in the program's place) and each fault
planted under the timed path come out not correct."""

import json
import os
import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import sgbm_ref

SEED = 2 ** 31 + 99


def _cell(traffic, batch, paths=8):
    spec = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    name = "kitti_sgm8" if paths == 8 else "middlebury_sgm4"
    config = json.load(open(os.path.join(
        harness.ROOT, "benchmark", "configs", name + ".json")))
    config["shape"] = [40, 112]
    config["pinned"]["num_disparities"] = 32
    t = json.load(open(os.path.join(harness.ROOT, "benchmark", "traffic",
                                    traffic + ".json")))
    t.update(pool=2 * batch, warmup_calls=1, check_megapixels=0.01)
    assert t["batch"] == batch
    return harness.Cell(f"{name}.{traffic}", config, t, {}, spec)


def _run(cell, entry=None):
    r = harness.run(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                    entry=entry)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    return r


def _port():
    from tpustereo_torch.pipeline import sgbm_batched
    return sgbm_batched


@pytest.mark.parametrize("traffic,batch,paths", [
    ("stream-b8", 8, 8), ("stream-b8", 8, 4), ("live-b1", 1, 8)])
def test_sound_run_is_correct(traffic, batch, paths):
    r = _run(_cell(traffic, batch, paths))
    assert r["correct"], r["checks"]
    assert r["checks"]["invalid_mismatch_px"]["value"] == 0
    live = ".live" if batch == 1 else ""
    assert set(r["metrics"]) == {"frames_per_s" + live,
                                 "call_latency_p95_ms" + live,
                                 "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("traffic,batch", [("stream-b8", 8),
                                           ("live-b1", 1)])
def test_control_is_not_correct(traffic, batch):
    cell = _cell(traffic, batch)

    def control(left, right, cfg):
        return sgbm_ref.sgbm_frames(left, right, cell.config["pinned"],
                                    subpixel_dtype=torch.bfloat16)
    r = _run(cell, control)
    assert not r["correct"], r["checks"]


def test_half_the_batch_left_out_is_not_correct():
    port = _port()

    def half(left, right, cfg):
        B = left.shape[0]
        out = port(left[:B // 2], right[:B // 2], cfg)
        return torch.cat([out, out])
    assert not _run(_cell("stream-b8", 8), half)["correct"]


@pytest.mark.parametrize("traffic,batch", [("stream-b8", 8),
                                           ("live-b1", 1)])
def test_an_altered_answer_is_not_correct(traffic, batch):
    port = _port()

    def altered(left, right, cfg):
        out = port(left, right, cfg)
        valid = (out[0] >= 0).nonzero()
        y, x = valid[len(valid) // 2].tolist()
        out[0, y, x] += 0.5
        return out
    assert not _run(_cell(traffic, batch), altered)["correct"]


def test_an_answer_marked_invalid_is_not_correct():
    port = _port()

    def dropped(left, right, cfg):
        out = port(left, right, cfg)
        valid = (out[-1] >= 0).nonzero()
        y, x = valid[0].tolist()
        out[-1, y, x] = -1.0
        return out
    r = _run(_cell("stream-b8", 8), dropped)
    assert not r["correct"]
    assert r["checks"]["invalid_mismatch_px"]["value"] >= 1
