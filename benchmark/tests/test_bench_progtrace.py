"""The reader of the program's spans (`benchmark/progtrace.py`) on a
hand-made Chrome trace: nested `tps.*` spans inside the benchmark's own,
runtime calls and device operations linked by `correlation`, one launch
outside any span and one device operation whose runtime call is missing;
and the benchmark's readers, which read the same values whether the trace
holds the program's spans or not."""

import glob
import json
import os

import pytest

from benchmark import devtrace, harness, progtrace, workmodel

MAIN, OTHER = 101, 202

# (name, start us, end us) on the main thread
HOST = [("loop", 0, 5), ("issue", 5, 105), ("wait", 105, 200),
        ("loop", 200, 205)]
TPS = [("tps.sgbm_batched", 6, 100), ("tps.frames", 7, 90),
       ("tps.census", 10, 20), ("tps.sweeps", 20, 50),
       ("tps.lr_check", 50, 54), ("tps.speckle", 55, 80),
       ("tps.speckle.labels", 56, 60), ("tps.speckle.sizes", 60, 79),
       ("tps.median", 80, 85), ("tps.cat", 90, 95)]
# (runtime call, tid, ts, correlation, device op, cat, start, dur); the
# device op None where the call launches nothing traced
CALLS = [
    ("cudaLaunchKernel", MAIN, 3, 7, "void at::native::fill_kernel<f>()",
     "kernel", 25, 3),                                   # outside any span
    ("cudaGetDevice", MAIN, 8, None, None, None, 0, 0),
    ("cudaLaunchKernel", MAIN, 15, 1, "void census_cost_kernel<5>(int)",
     "kernel", 30, 10),
    ("cudaLaunchCooperativeKernel", MAIN, 25, 2,
     "void sgm_fused_kernel<128, true>(x)", "kernel", 40, 80),
    ("cudaMemsetAsync", MAIN, 30, 3, "Memset (Device)", "gpu_memset", 120, 5),
    ("cudaLaunchKernel", MAIN, 51, 11, "lr_check_kernel(int)", "kernel",
     125, 2),
    ("cudaLaunchKernel", MAIN, 57, 4, "cc_local_kernel(int*)", "kernel",
     130, 5),
    ("cudaLaunchKernel", MAIN, 62, 5,
     "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>()",
     "kernel", 140, 10),
    ("cudaStreamSynchronize", MAIN, 70, None, None, None, 0, 0),
    ("cudaLaunchKernel", MAIN, 82, 8, "median3_kernel(float*)", "kernel",
     150, 5),
    ("cudaMemcpyAsync", MAIN, 92, 9, "Memcpy DtoD (Device -> Device)",
     "gpu_memcpy", 160, 5),
    ("cudaLaunchKernel", OTHER, 30, 12, "void other_thread_kernel()",
     "kernel", 185, 5),                                  # no span there
]
# a device operation whose runtime call the trace lacks
ORPHAN = ("void at::native::vectorized_elementwise_kernel<4>()", "kernel",
          170, 10, 10)


def _trace(with_program=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "pid": 1,
           "tid": MAIN, "ts": s, "dur": e - s}
          for n, s, e in HOST + (TPS if with_program else [])]
    ev += [{"ph": "X", "cat": "gpu_user_annotation", "name": n, "pid": 0,
            "tid": 7, "ts": s + 20, "dur": e - s}
           for n, s, e in (TPS if with_program else [])]
    for name, tid, ts, corr, op, cat, start, dur in CALLS:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1,
                   "tid": tid, "ts": ts, "dur": 1,
                   "args": {"correlation": corr} if corr else {}})
        if op is not None:
            ev.append({"ph": "X", "cat": cat, "name": op, "pid": 0,
                       "tid": 7, "ts": start, "dur": dur,
                       "args": {"correlation": corr}})
    name, cat, start, dur, corr = ORPHAN
    ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
               "ts": start, "dur": dur, "args": {"correlation": corr}})
    ev.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 15})
    return {"traceEvents": ev}


@pytest.fixture
def trace_path(tmp_path):
    def write(with_program=True):
        p = tmp_path / f"trace_{int(with_program)}.json"
        p.write_text(json.dumps(_trace(with_program)))
        return str(p)
    return write


def test_attribution_by_innermost_span(trace_path):
    prog = progtrace.read_program(trace_path())
    owner = {o.name: (prog.owner(o).name if prog.owner(o) else None)
             for o in prog.ops}
    assert owner == {
        "void at::native::fill_kernel<f>()": None,
        "void census_cost_kernel<5>(int)": "tps.census",
        "void sgm_fused_kernel<128, true>(x)": "tps.sweeps",
        "Memset (Device)": "tps.sweeps",
        "lr_check_kernel(int)": "tps.lr_check",
        "cc_local_kernel(int*)": "tps.speckle.labels",
        "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>()":
            "tps.speckle.sizes",
        "median3_kernel(float*)": "tps.median",
        "Memcpy DtoD (Device -> Device)": "tps.cat",
        "void other_thread_kernel()": None,
        ORPHAN[0]: None}
    assert len(prog.roots) == 1


def test_readings(trace_path):
    prog = progtrace.read_program(trace_path())
    r = progtrace.readings(prog)
    assert r == {
        "pipeline.lead_in_ms": pytest.approx((15 - 6) * 1e-3),
        "census.host_ms": pytest.approx(10e-3),
        "sweeps.host_ms": pytest.approx(30e-3),
        # lr_check 4 + speckle 25 (its children inside) + median 5
        "postproc.host_ms": pytest.approx(34e-3)}
    total = sum(c[7] for c in CALLS if c[4]) + ORPHAN[3]
    assert progtrace.unattributed_pct(prog) == pytest.approx(
        100 * (3 + 5 + 10) / total)


def test_stage_table(trace_path):
    rows = progtrace.stages(progtrace.read_program(trace_path()), frames=2)
    assert rows["tps.speckle"]["host_ms"] == pytest.approx(25e-3)
    assert rows["tps.speckle"]["self_ms"] == pytest.approx(2e-3)
    assert rows["tps.frames"]["self_ms"] == pytest.approx(
        (83 - 10 - 30 - 4 - 25 - 5) * 1e-3)
    assert rows["tps.sweeps"]["ops_per_frame"] == 1.0          # 2 of 2
    assert rows["tps.sweeps"]["device_ms_per_frame"] == \
        pytest.approx(85e-3 / 2)
    # the launch in the harness's loop; the orphan and the other thread's
    assert rows["loop"]["ops_per_frame"] == 0.5
    assert rows[progtrace.NO_SPAN]["ops_per_frame"] == 1.0
    assert rows["tps.speckle.sizes"]["syncs"] == 1.0
    # the device's gaps: 28-30 (host in tps.sweeps), 127-130, 135-140,
    # 155-160, 165-170 (host in wait), 180-185 (wait)
    assert rows["tps.sweeps"]["idle_ms"] == pytest.approx(2e-3)
    assert rows["wait"]["idle_ms"] == pytest.approx(23e-3)
    idle = sum(r["idle_ms"] for r in rows.values())
    ops = [(o.name, o.cat, o.start, o.dur) for o in
           progtrace.read_program(trace_path()).ops]
    assert idle == pytest.approx(
        sum(n for _, n, _ in devtrace.gaps(ops)) * 1e-3)


def test_longest_gaps(trace_path):
    g = progtrace.longest_gaps(progtrace.read_program(trace_path()), top=6)
    assert [x["ms"] for x in g] == pytest.approx(
        [5e-3, 5e-3, 5e-3, 5e-3, 3e-3, 2e-3])
    assert g[0] == {"ms": pytest.approx(5e-3),
                    "before": "at_cuda_detail::cub::"
                              "DeviceRadixSortOnesweepKernel",
                    "launched_in": "tps.speckle.sizes",
                    "host_ms": {"wait": pytest.approx(5e-3)}}
    assert g[2]["launched_in"] is None                 # the orphan
    assert g[-1] == {"ms": pytest.approx(2e-3),
                     "before": "census_cost_kernel",
                     "launched_in": "tps.census",
                     "host_ms": {"tps.sweeps": pytest.approx(2e-3)}}


def test_no_program_spans(trace_path):
    prog = progtrace.read_program(trace_path(with_program=False))
    assert progtrace.readings(prog) == dict.fromkeys(
        ("pipeline.lead_in_ms", "census.host_ms", "sweeps.host_ms",
         "postproc.host_ms"))
    assert progtrace.unattributed_pct(prog) == 100.0


def test_timeline_nesting_and_split():
    S = progtrace.Span
    line = progtrace.Timeline([S("a", 0, 0, 10), S("b", 0, 2, 5),
                               S("c", 0, 5, 8), S("d", 0, 12, 14)])
    assert [line.at(t) and line.at(t).name
            for t in (-1, 0, 2, 4.9, 5, 8, 9, 10, 11, 13, 20)] == \
        [None, "a", "b", "b", "c", "a", "a", None, None, "d", None]
    assert line.split(1, 13) == {"a": 1 + 2, "b": 3, "c": 3,
                                 "other": 2, "d": 1}


def test_existing_readers_unchanged_by_program_spans(trace_path):
    """Each reader of benchmark/metrics/ reads the same value from the
    trace with the program's spans as from the trace without them."""
    config = harness.load_cell("kitti_sgm8.stream-b8").config
    stages = workmodel.sgm_frame(config["pinned"], tuple(config["shape"]))
    values = []
    for with_program in (False, True):
        ops, spans = devtrace.read_chrome_trace(trace_path(with_program))
        view = devtrace.TraceView(ops, spans, 1, 2, [0.002, 0.003], stages)
        got = {}
        for path in sorted(glob.glob(os.path.join(
                harness.ROOT, "benchmark", "metrics", "*.py"))):
            if os.path.basename(path) != "__init__.py":
                got[os.path.basename(path)] = harness.load_reader(path)(view)
        values.append(got)
        assert devtrace.breakdown(ops, spans) == devtrace.breakdown(
            *devtrace.read_chrome_trace(trace_path(False)))
    assert values[0] == values[1]
    assert len(values[0]) == 14 and None not in values[0].values()


def test_cpu_trace_of_the_port(tmp_path):
    """A profiled CPU call of the port: its spans read, no launches."""
    import torch

    from tpustereo_torch.config import PRESETS
    from tpustereo_torch.pipeline import sgbm_batched
    cfg = PRESETS["kitti_sgm8"].replace(num_disparities=16,
                                        frames_per_step=2)
    g = torch.Generator().manual_seed(5)
    L = torch.randint(0, 256, (4, 20, 40), dtype=torch.uint8, generator=g)
    R = torch.roll(L, -3, dims=-1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sgbm_batched(L, R, cfg)
    path = str(tmp_path / "cpu.json")
    prof.export_chrome_trace(path)
    prog = progtrace.read_program(path)
    assert len(prog.roots) == 1
    r = progtrace.readings(prog)
    assert r["pipeline.lead_in_ms"] is None
    assert all(r[f"{k}.host_ms"] > 0 for k in progtrace.LAYERS)
    rows = progtrace.stages(prog, 4)
    assert rows["tps.frames"]["host_ms"] <= rows["tps.sgbm_batched"][
        "host_ms"]
    assert sum(r["self_ms"] for r in rows.values()) == pytest.approx(
        rows["tps.sgbm_batched"]["host_ms"])


def test_a_traced_run_on_the_cpu(tmp_path):
    """`run_cell` at a tiny size on the CPU: the window traced, its spans
    read, the benchmark's readers beside them, the trace kept."""
    cell = harness.load_cell("kitti_sgm8.live-b1")
    cell.config = dict(cell.config, shape=[24, 64])
    cell.config["pinned"] = dict(cell.config["pinned"], num_disparities=16)
    cell.traffic = dict(cell.traffic, pool=2, warmup_calls=1,
                        trace_frames=2)
    out = progtrace.run_cell(cell, 2 ** 31 + 5, 2.0, str(tmp_path), "cpu")
    assert out["calls"] == 2 and out["frames"] == 2
    assert out["run"]["traced"][1] == 2
    assert out["readings"]["pipeline.lead_in_ms"] is None
    assert all(out["readings"][f"{k}.host_ms"] > 0 for k in progtrace.LAYERS)
    assert set(out["benchmark"]) == set(cell.metrics)
    assert os.path.isfile(tmp_path / "trace.json")
