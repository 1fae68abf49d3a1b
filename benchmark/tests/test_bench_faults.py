"""Whole runs of the harness on the CPU at a tiny size, with the look for a
card skipped: the port's plain path comes out correct; the control (the
reference computed in bfloat16, put in the program's place) and each fault
planted under the timed path come out not correct. Host-array traffic
(`api-b8`) runs `api.match_batch` on the CPU, numpy in and numpy out."""

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import harness

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
                    entry=entry or _port(cell))
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    return r


def _port(cell):
    """The cell's entry on the CPU: `sgbm_batched`, or for host arrays
    `api.match_batch` with device="cpu"."""
    if harness.arrays(cell.traffic) == "device":
        from tpustereo_torch.pipeline import sgbm_batched
        return sgbm_batched
    from tpustereo_torch.api import match_batch

    def api(left, right, cfg):
        assert isinstance(left, np.ndarray) and left.base is not None
        return match_batch(left, right, cfg, device="cpu")
    return api


@pytest.mark.parametrize("traffic,batch,paths", [
    ("stream-b8", 8, 8), ("stream-b8", 8, 4), ("live-b1", 1, 8),
    ("api-b8", 8, 8)])
def test_sound_run_is_correct(traffic, batch, paths):
    r = _run(_cell(traffic, batch, paths))
    assert r["correct"], r["checks"]
    assert r["checks"]["invalid_mismatch_px"]["value"] == 0
    # the API's p95 swings with the host's memory speed and is bounded in
    # no class: the cell reports its throughput alone, under its own bound
    assert set(r["metrics"]) == {
        "stream-b8": {"frames_per_s", "call_latency_p95_ms"},
        "live-b1": {"frames_per_s.live", "call_latency_p95_ms.live"},
        "api-b8": {"frames_per_s.api"}}[traffic] | {"peak_mem_gib",
                                                    "setup_s"}


@pytest.mark.parametrize("traffic,batch", [("stream-b8", 8),
                                           ("live-b1", 1), ("api-b8", 8)])
def test_control_is_not_correct(traffic, batch):
    cell = _cell(traffic, batch)
    r = _run(cell, harness.control_entry(cell, "cpu"))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("traffic", ["stream-b8", "api-b8"])
def test_half_the_batch_left_out_is_not_correct(traffic):
    cell = _cell(traffic, 8)
    port = _port(cell)

    def half(left, right, cfg):
        B = left.shape[0]
        out = port(left[:B // 2], right[:B // 2], cfg)
        return (torch.cat([out, out]) if isinstance(out, torch.Tensor)
                else np.concatenate([out, out]))
    assert not _run(cell, half)["correct"]


@pytest.mark.parametrize("traffic,batch", [("stream-b8", 8),
                                           ("live-b1", 1), ("api-b8", 8)])
def test_an_altered_answer_is_not_correct(traffic, batch):
    cell = _cell(traffic, batch)
    port = _port(cell)

    def altered(left, right, cfg):
        out = port(left, right, cfg)
        y, x = np.argwhere(np.asarray(out[0]) >= 0)[
            int((np.asarray(out[0]) >= 0).sum()) // 2]
        out[0, y, x] += 0.5
        return out
    assert not _run(cell, altered)["correct"]


@pytest.mark.parametrize("traffic", ["stream-b8", "api-b8"])
def test_an_answer_marked_invalid_is_not_correct(traffic):
    cell = _cell(traffic, 8)
    port = _port(cell)

    def dropped(left, right, cfg):
        out = port(left, right, cfg)
        y, x = np.argwhere(np.asarray(out[-1]) >= 0)[0]
        out[-1, y, x] = -1.0
        return out
    r = _run(cell, dropped)
    assert not r["correct"]
    assert r["checks"]["invalid_mismatch_px"]["value"] >= 1


@pytest.mark.parametrize("fault", ["float64", "wrong_shape", "tensor",
                                   "list"])
def test_a_host_answer_of_another_kind_is_not_correct(fault):
    """A host-array entry's answer in float64, of another shape, as a
    tensor or as no array at all reads as a full mismatch."""
    cell = _cell("api-b8", 8)
    port = _port(cell)

    def other(left, right, cfg):
        out = port(left, right, cfg)
        return {"float64": lambda: out.astype(np.float64),
                "wrong_shape": lambda: out[:, :, :-1],
                "tensor": lambda: torch.from_numpy(out),
                "list": lambda: out.tolist()}[fault]()
    r = _run(cell, other)
    assert not r["correct"]
    H, W = cell.config["shape"]
    assert r["checks"]["invalid_mismatch_px"]["value"] == 8 * H * W
    assert r["checks"]["disp_gap_px"]["value"] == harness.NO_ANSWER


def test_host_inputs_are_unpinned_copies_of_the_pool():
    cell = _cell("api-b8", 8)
    pool, inputs = harness.make_inputs(cell, SEED, "cpu")
    device_pool, same = harness.make_inputs(_cell("stream-b8", 8), SEED,
                                            "cpu")
    assert same is device_pool
    for k in ("left", "right"):
        x = inputs[k]
        assert isinstance(x, np.ndarray) and x.dtype == np.uint8
        assert x.flags.c_contiguous and x[8:16].flags.c_contiguous
        assert not torch.from_numpy(x).is_pinned()
        assert np.array_equal(x, pool[k].numpy())
        assert torch.equal(device_pool[k], pool[k])


@pytest.mark.parametrize("traffic,kind", [("stream-b8", torch.Tensor),
                                          ("api-b8", np.ndarray)])
def test_the_entry_takes_the_traffics_arrays(traffic, kind):
    """Without `arrays` the entry is passed tensors, with "host" numpy
    views of the host pool, in the warm-up and the window alike."""
    cell = _cell(traffic, 8)
    assert ("arrays" in cell.traffic) == (kind is np.ndarray)
    port, seen = _port(cell), []

    def spy(left, right, cfg):
        seen.append((type(left), type(right)))
        return port(left, right, cfg)
    assert _run(cell, spy)["correct"]
    assert len(seen) > cell.traffic["warmup_calls"]
    assert set(seen) == {(kind, kind)}


def test_unknown_arrays_fail():
    cell = _cell("api-b8", 8)
    cell.traffic["arrays"] = "pinned"
    with pytest.raises(harness.CellError, match="arrays"):
        _run(cell)
