"""The strip-tiled cell (`kitti_odometry.exact-b1`) on the CPU at a tiny
size: the harness's bound entry (`harness.bind_entry`) builds the traffic's
mesh once and passes it; exact tiling equals the untiled reference bit for
bit, at any strip count and at heights and widths that do not divide
evenly; the preset's own halo mode, the reason for the configuration's
departure, reads `correct` false, and so does each fault planted under the
timed path."""

import time
import warnings

import numpy as np
import pytest
import torch

from benchmark import harness, scenes
from benchmark.reference import sgbm_ref

CELL = "kitti_odometry.exact-b1"
SEED = 2 ** 31 + 77


def _cell(shape=(90, 97), **pinned):
    cell = harness.load_cell(CELL)
    cell.config = dict(cell.config, shape=list(shape))
    cell.config["pinned"] = dict(cell.config["pinned"], num_disparities=32,
                                 **pinned)
    cell.traffic = dict(cell.traffic, pool=2, warmup_calls=1,
                        check_megapixels=0.01)
    return cell


def _run(cell, entry=None):
    with warnings.catch_warnings():
        # halo mode warns where a strip is shorter than the halo
        warnings.simplefilter("ignore")
        r = harness.run(cell, SEED, 0.2, False, "cpu", time.perf_counter(),
                        entry=entry)
    assert r["attempted"] > 0 and list(r)[-1] == "checks"
    return r


@pytest.mark.parametrize("strips,shape", [(2, (50, 129)), (3, (61, 97)),
                                          (2, (90, 97))])
def test_exact_tiling_equals_the_reference(strips, shape):
    cell = _cell(shape, strips=strips)
    cfg = harness.port_config(cell.config)
    entry = harness.bind_entry(cell, cfg, torch.device("cpu"))
    pool = scenes.make_pool(cell.config["scene"], 2, shape, 32, SEED, "cpu")
    out = torch.cat([entry(pool["left"][i:i + 1], pool["right"][i:i + 1],
                           cfg) for i in range(2)])
    ref = sgbm_ref.sgbm_frames(pool["left"], pool["right"],
                               cell.config["pinned"])
    assert torch.equal(out, ref)
    assert (out >= 0).float().mean() > 0.5


def test_sound_run_is_correct_and_reports_the_live_class():
    r = _run(_cell())
    assert r["correct"], r["checks"]
    assert r["checks"]["invalid_mismatch_px"]["value"] == 0
    assert r["checks"]["disp_gap_px"]["value"] == 0.0
    assert set(r["metrics"]) == {"frames_per_s.live",
                                 "call_latency_p95_ms.live", "peak_mem_gib",
                                 "setup_s"}


def test_the_preset_as_shipped_is_not_correct():
    """The preset's halo approximation, run as the cell runs it, departs
    from the untiled reference: the reason for `departs`."""
    r = _run(_cell(exact_tiling=False))
    assert not r["correct"], r["checks"]


def _tiled(cfg_change=None, out_change=None):
    """The strip-tiled entry on the cell's own mesh, its configuration or
    its answer altered."""
    from tpustereo_torch.dist import make_mesh, sgbm_tiled_batched
    mesh = make_mesh(1, 2, device="cpu")

    def entry(left, right, cfg):
        out = sgbm_tiled_batched(left, right,
                                 cfg_change(cfg) if cfg_change else cfg,
                                 mesh)
        return out_change(out) if out_change else out
    return entry


def _altered(out):
    y, x = np.argwhere(out[0].numpy() >= 0)[int((out[0] >= 0).sum()) // 2]
    out[0, y, x] += 0.5
    return out


def _dropped(out):
    y, x = np.argwhere(out[0].numpy() >= 0)[0]
    out[0, y, x] = -1.0
    return out


@pytest.mark.parametrize("fault", ["halo", "altered", "dropped",
                                   "one_strip"])
def test_a_fault_is_not_correct(fault):
    """A halo-mode answer planted in the exact cell; one answer altered
    where it is produced, or marked invalid; the ring cut, each strip
    matched alone (one strip's mesh for every strip's rows would be the
    untiled matcher, so the cut is strips of their own)."""
    entry = {
        "halo": lambda: _tiled(lambda c: c.replace(exact_tiling=False)),
        "altered": lambda: _tiled(out_change=_altered),
        "dropped": lambda: _tiled(out_change=_dropped),
        "one_strip": _strips_alone,
    }[fault]()
    r = _run(_cell(), entry)
    assert not r["correct"], r["checks"]


def _strips_alone():
    """Each strip's rows matched on their own: no carry crosses the
    boundary."""
    from tpustereo_torch.pipeline import sgbm_batched

    def entry(left, right, cfg):
        h = -(-left.shape[1] // 2)
        return torch.cat([sgbm_batched(left[:, a:a + h], right[:, a:a + h],
                                       cfg)
                          for a in (0, h)], dim=1)
    return entry


def test_the_mesh_is_built_once_in_set_up(monkeypatch):
    from tpustereo_torch import dist
    built, calls = [], []
    make_mesh, tiled = dist.make_mesh, dist.sgbm_tiled_batched

    def counted(*a, **k):
        built.append((a, k))
        return make_mesh(*a, **k)

    def spy(left, right, cfg, mesh):
        calls.append(mesh)
        return tiled(left, right, cfg, mesh)
    monkeypatch.setattr(dist, "make_mesh", counted)
    monkeypatch.setattr(dist, "sgbm_tiled_batched", spy)
    assert _run(_cell())["correct"]
    assert built == [((1, 2), {"device": torch.device("cpu")})]
    assert len(calls) > 1 and all(m is calls[0] for m in calls)
    assert calls[0].shape == {"data": 1, "strip": 2}


def test_without_a_mesh_the_entry_is_the_function_itself():
    from tpustereo_torch.pipeline import sgbm_batched
    cell = harness.load_cell("kitti_sgm8.live-b1")
    assert harness.bind_entry(cell, harness.port_config(cell.config),
                              torch.device("cpu")) is sgbm_batched


def test_an_unknown_mesh_fails():
    cell = _cell()
    cell.traffic["mesh"] = "devices"
    with pytest.raises(harness.CellError, match="mesh"):
        harness.bind_entry(cell, harness.port_config(cell.config),
                           torch.device("cpu"))

