"""The port's harness, roofline and eval runner (`tpustereo_torch.eval.
bench`, `eval.roofline`, `eval.runner`, `golden`) against the JAX
package's, on the CPU at tiny shapes. No time measured here is a device
number: the records say `"backend": "cpu"`.

Exact throughout: the runner's per-pair metrics equal the JAX runner's
(the port's pipeline gives the JAX jnp pipeline's disparity bit for bit);
the golden copy equals the JAX golden; the roofline's counts equal the
bytes and operations reckoned by hand.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tpustereo.config import PRESETS as JPRESETS
from tpustereo.eval import bench as jbench
from tpustereo.eval.runner import evaluate as j_evaluate
from tpustereo.golden import sgbm_numpy as j_sgbm_numpy
from tpustereo_torch import PRESETS, kernels
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.dist import make_mesh
from tpustereo_torch.eval import bench, roofline, runner
from tpustereo_torch.golden import opencv_ref, sgbm_numpy
from tpustereo_torch.ops import postproc

TINY = (24, 40)
JSMALL = JPRESETS["kitti_sgm8"].replace(num_disparities=16, frames_per_step=1)
SMALL = config_from_jax(dataclasses.asdict(JSMALL))
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def jax_records():
    """The JAX harness's records at the tiny shape."""
    run = jbench.run_benchmark(JSMALL, shape=TINY, batch=2, iters=1)
    odo = jbench.run_odometry_benchmark(JSMALL, shape=TINY, frames=1,
                                        iters=1)
    return run, odo


def test_run_benchmark_record_has_the_jax_keys(jax_records):
    jrun, _ = jax_records
    rec = bench.run_benchmark(SMALL, shape=TINY, batch=2, iters=1,
                              stages=True, device="cpu")
    assert set(rec) == set(jrun) | {"stage_ms"}
    # the keys of the JAX `production_stage_times` for this configuration
    assert list(rec["stage_ms"]) == [
        "full_pipeline", "speckle", "median3", "lr_check",
        "core(cost+sweeps+wta)", "unattributed"]
    for k in ("metric", "unit", "batch", "chips", "tiled"):
        assert rec[k] == jrun[k], k
    assert rec["config"] == jrun["config"]
    assert rec["backend"] == "cpu" and rec["device_kind"] == "cpu"
    assert rec["value"] > 0 and rec["ms_per_frame"] > 0
    # the CPU has no peaks in the model: the record names it, no shares
    rl = rec["roofline"]
    assert rl["chip_assumed"] is None and rl["device_name"] == "cpu"
    assert not roofline.shares(rl)


def test_run_odometry_benchmark_record_has_the_jax_keys(jax_records):
    _, jodo = jax_records
    rec = bench.run_odometry_benchmark(SMALL, shape=TINY, frames=1, iters=1,
                                       device="cpu")
    assert set(rec) == set(jodo)
    for k in ("metric", "unit", "stacked", "tiled", "frames_per_step",
              "max_corners", "config"):
        assert rec[k] == jodo[k], k


@pytest.mark.parametrize("mode", ["stacked", "tiled"])
def test_run_odometry_benchmark_modes(mode):
    kw = {"stacked": True} if mode == "stacked" else {
        "tiled": True, "mesh": make_mesh(1, 2, device="cpu")}
    rec = bench.run_odometry_benchmark(
        SMALL.replace(halo=8), shape=(32, 48), frames=2, iters=1,
        device="cpu", **kw)
    assert rec[mode] and rec["ms_per_frame"] > 0
    assert rec["config"]["strips"] == (2 if mode == "tiled" else 1)


def test_tiled_run_benchmark_on_a_one_device_mesh():
    rec = bench.run_benchmark(SMALL.replace(halo=8), shape=(32, 48), batch=2,
                              iters=1, stages=True, tiled=True,
                              mesh=make_mesh(1, 2, device="cpu"),
                              device="cpu")
    assert rec["tiled"] and rec["chips"] == 1
    assert rec["config"]["strips"] == 2
    assert "roofline" not in rec
    assert list(rec["stage_ms"]) == [
        "census+cost_volume(fused)", "sgm_select(4 sweeps+wta fused)",
        "dr_consistency", "speckle", "median3"]


def test_default_mesh_over_several_cards_is_not_ported(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="queue 1"):
        bench._mesh_on(None, torch.device("cuda"))
    assert bench._mesh_on(None, torch.device("cpu")).shape == {"data": 1,
                                                               "strip": 1}
    with pytest.raises(ValueError, match="the mesh is on"):
        bench._mesh_on(make_mesh(1, 2, device="cpu"), torch.device("cuda"))


STAGES = {
    "kitti_sgm8": ["census+cost_volume(fused)",
                   "sgm_select(4 sweeps+wta fused)", "dr_consistency",
                   "speckle", "median3"],
    "middlebury_census_wta": ["census+cost_volume(fused)", "wta_subpixel"],
    "tsukuba_sad": ["sad_fused(volume+wta)"],
}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_times_names_the_route(name):
    L, R, _, _ = synthetic_pair(TINY, 4.0, seed=0)
    ms = bench.stage_times(L, R, PRESETS[name].replace(num_disparities=16),
                           iters=1, device="cpu")
    assert list(ms) == STAGES[name] and all(v >= 0 for v in ms.values())


def test_stage_times_on_the_volume_route():
    L, R, _, _ = synthetic_pair(TINY, 4.0, seed=0)
    ms = bench.stage_times(L, R, SMALL.replace(p2=1000), iters=1,
                           device="cpu")
    assert list(ms) == ["census+cost_volume(fused)", "aggregate",
                        "wta_subpixel", "lr_check", "speckle", "median3"]


def test_baseline_is_the_jax_one():
    assert bench.BASELINE_FPS == jbench.BASELINE_FPS


def test_timed_loop_on_the_cpu_uses_the_host_clock():
    calls = []
    x = torch.zeros(3)
    sec = bench._timed_device_loop(lambda t: calls.append(t), x, iters=4)
    assert sec >= 0 and len(calls) == 5   # one warm-up, then the loop


@pytest.mark.parametrize("name", sorted(JPRESETS))
def test_evaluate_matches_jax_per_pair(name):
    jcfg = JPRESETS[name].replace(num_disparities=32)
    ours = runner.evaluate(config_from_jax(dataclasses.asdict(jcfg)),
                           synthetic=True, device="cpu")
    theirs = j_evaluate(jcfg, synthetic=True)
    assert ours["pairs"] == theirs["pairs"]
    assert ours["mean"] == theirs["mean"]
    assert ours["config"] == theirs["config"]


def test_evaluate_golden_and_opencv(monkeypatch):
    cfg = SMALL.replace(num_disparities=32)
    rep = runner.evaluate(cfg, synthetic=True, device="cpu",
                          compare_golden=True, compare_opencv=True)
    for p in rep["pairs"]:
        assert p["tpu_vs_golden_max_abs"] == 0.0
        assert p["golden"] == p["tpu"]
        assert set(p["opencv"]) == set(p["tpu"])
    monkeypatch.setattr(opencv_ref, "have_cv2", lambda: False)
    rep = runner.evaluate(cfg, synthetic=True, device="cpu",
                          compare_opencv=True)
    assert all(p["opencv"] == "cv2 not installed" for p in rep["pairs"])


def test_evaluate_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.evaluate(SMALL, synthetic=True)


@pytest.mark.parametrize("name", ["kitti_sgm8", "tsukuba_sad",
                                  "middlebury_census_wta"])
def test_golden_copy_equals_jax_golden(name):
    jcfg = JPRESETS[name].replace(num_disparities=16, speckle_window_size=20)
    L, R, _, _ = synthetic_pair((20, 32), 4.0, seed=2)
    np.testing.assert_array_equal(
        sgbm_numpy(L, R, config_from_jax(dataclasses.asdict(jcfg))),
        j_sgbm_numpy(L, R, jcfg))


# --- roofline ----------------------------------------------------------------

def test_sgm_counts_at_kitti_size_by_hand():
    cfg = PRESETS["kitti_sgm8"]
    H, W, D = 375, 1242, 128
    n, v = H * W, H * W * D
    m = roofline.sgm_ops_model(cfg, (H, W))
    assert m["path_cell_updates"] == 8 * v == 476_928_000
    assert m["int_ops_total"] == 9 * 8 * v
    # cost: L, R in, C out; sweeps: C in, S (int16) out; bwd + WTA: C and
    # S in, disp (4), valid (1), d_r (4) out; LR: d_r + disp in, ok out;
    # speckle: disp + valid in, map out; median: map in and out
    assert m["hbm_bytes"] == {"cost": 2 * n + v, "sweeps": 3 * v,
                              "select": 3 * v + 9 * n, "lr_check": 9 * n,
                              "speckle": 9 * n, "median": 8 * n}
    assert m["hbm_bytes_total"] == 7 * v + 37 * n
    m4 = roofline.sgm_ops_model(PRESETS["middlebury_sgm4"], (H, W))
    assert m4["path_cell_updates"] == 4 * v


def test_sad_and_census_wta_counts_by_hand():
    H, W = 288, 384
    n = H * W
    m = roofline.sad_ops_model(PRESETS["tsukuba_sad"], (H, W))
    assert m["int_ops_total"] == 6 * n * 64
    assert m["hbm_bytes"] == {"select": 7 * n, "speckle": 9 * n}
    m = roofline.census_wta_ops_model(PRESETS["middlebury_census_wta"],
                                      (375, 621))
    n, v = 375 * 621, 375 * 621 * 128
    assert m["int_ops_total"] == 6 * v
    assert m["hbm_bytes"] == {"cost": 2 * n + v, "select": v + 5 * n,
                              "speckle": 9 * n}
    assert roofline.sgm_ops_model(PRESETS["tsukuba_sad"], (H, W)) is None


@pytest.mark.parametrize("name", ["kitti_sgm8", "middlebury_sgm4",
                                  "kitti_odometry"])
def test_counts_do_not_follow_the_implementation(monkeypatch, name):
    """The same counts under BIDIR_VERT, BITONIC_SPECKLE, tiling and the
    launch split (frames_per_step, batch)."""
    cfg = PRESETS[name]
    base = roofline.ops_model(cfg, (375, 1242))
    monkeypatch.setattr(kernels.sgm, "BIDIR_VERT", True)
    monkeypatch.setattr(postproc, "BITONIC_SPECKLE", True)
    for c in (cfg, cfg.replace(strips=4, exact_tiling=True),
              cfg.replace(strips=1), cfg.replace(frames_per_step=1,
                                                 batch_size=8)):
        assert roofline.ops_model(c, (375, 1242)) == base


def test_chip_spec_knows_only_the_sxm_h100():
    assert roofline.chip_spec(H100) == roofline.H100_SXM
    for other in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-"
                  "80GB", "cpu", ""):
        assert roofline.chip_spec(other) is None


def test_roofline_record_on_the_h100():
    cfg = PRESETS["kitti_sgm8"]
    m = roofline.sgm_ops_model(cfg, (375, 1242))
    rl = roofline.roofline(cfg, (375, 1242), 0.95e-3, H100,
                           core_sec_per_frame=0.8e-3)
    assert rl["chip_assumed"] == "H100 SXM" and rl["device_name"] == H100
    assert rl["hbm_peak_gbps"] == 3350 and rl["int_peak_gops"] == 67000
    assert rl["hbm_util"] == pytest.approx(
        m["hbm_bytes_total"] / 0.95e-3 / 3.35e12, rel=1e-5)
    assert rl["int_util"] == pytest.approx(
        m["int_ops_total"] / 0.95e-3 / 67e12, rel=1e-5)
    assert rl["bound"] == "bytes" and rl["share"] == rl["hbm_util"]
    core_bytes = sum(m["hbm_bytes"][k] for k in ("cost", "sweeps", "select"))
    assert rl["core"]["hbm_util"] == pytest.approx(
        core_bytes / 0.8e-3 / 3.35e12, rel=1e-5)
    assert all(0 < s <= 1 for s in roofline.shares(rl).values())
    other = roofline.roofline(cfg, (375, 1242), 0.95e-3, "NVIDIA A100")
    assert other["chip_assumed"] is None and "hbm_util" not in other
    assert other["device_name"] == "NVIDIA A100"


def test_bound_by_bytes_and_by_operations():
    assert roofline.bound(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert roofline.bound(0, 67e9) == (pytest.approx(1.0), "operations")


def test_device_busy_fraction_reads_a_chrome_trace(tmp_path):
    """A trace in the layout `export_chrome_trace` writes: host ops and a
    CUDA runtime call are not device work; kernels, copies and fills are."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 500},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 5, "dur": 3},
        {"ph": "X", "cat": "kernel", "name": "census_kernel", "ts": 100,
         "dur": 40},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 150,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "sweep_kernel", "ts": 160,
         "dur": 40},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 300},
    ]
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    b = roofline.device_busy_fraction(str(tmp_path))
    assert b["span_ms"] == pytest.approx(0.1)
    assert b["busy_ms"] == pytest.approx(0.09)
    assert b["busy_fraction"] == pytest.approx(0.9)
    assert b["kernels"] == 3
    assert roofline.device_busy_fraction(str(tmp_path / "none")) is None


def test_busy_share_counts_overlapping_intervals_once():
    """Two streams' kernels that overlap, and one event listed twice, add
    their union to the busy time: the share stays the device's, under 1
    without a clip, and a gap still shows."""
    b = roofline.busy_share([("a", 0.0, 10.0), ("b", 5.0, 10.0),
                             ("a", 0.0, 10.0), ("c", 30.0, 5.0)])
    assert b["span_ms"] == pytest.approx(0.035)
    assert b["busy_ms"] == pytest.approx(0.020)
    assert b["busy_fraction"] == pytest.approx(20 / 35)
    assert b["kernels"] == 4
    full = roofline.busy_share([("a", 0.0, 10.0), ("b", 2.0, 8.0)])
    assert full["busy_fraction"] == pytest.approx(1.0)
    assert roofline.busy_share([]) is None


def test_device_busy_fraction_refuses_a_partial_trace(tmp_path):
    """A session that recorded fewer kernel events than the wrappers
    launched gives no share; memsets and copies do not make up kernels."""
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 5},
              {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 5,
               "dur": 5}]
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    assert roofline.device_busy_fraction(str(tmp_path), min_kernels=1)[
        "busy_fraction"] == pytest.approx(1.0)
    assert roofline.device_busy_fraction(str(tmp_path), min_kernels=2) \
        is None


def test_device_busy_fraction_of_a_cpu_profile_is_none(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    assert roofline.device_busy_fraction(str(tmp_path)) is None


def test_profile_dir_needs_the_card(tmp_path):
    with pytest.raises(ValueError, match="card"):
        bench.run_benchmark(SMALL, shape=TINY, batch=1, iters=1,
                            profile_dir=str(tmp_path), device="cpu")
