"""The arithmetic of the readings on hand-made numbers: the p95 over all
calls, the union of device intervals, idle gaps labelled by host span, the
per-layer readers and the frozen work model."""

import pytest

from benchmark import devtrace, harness, workmodel


def test_p95_over_all_calls():
    vals = [float(i) for i in range(1, 101)]          # 1 .. 100
    assert harness.p95(vals) == pytest.approx(95.05)
    assert harness.p95([5.0] * 19 + [100.0]) == pytest.approx(9.75)
    assert harness.p95([3.0]) == 3.0


def test_union_counts_overlaps_once():
    assert devtrace.union_us([(0, 10), (5, 10), (30, 5)]) == 20
    assert devtrace.union_us([(0, 10), (2, 3)]) == 10
    assert devtrace.union_us([]) == 0


def _view(stages=None, frames=2):
    ops = [("void census_cost_kernel<5>(int)", "kernel", 0.0, 10.0),
           ("void sgm_fused_kernel<128, true>(x)", "kernel", 10.0, 40.0),
           ("Memset (Device)", "gpu_memset", 60.0, 5.0),
           ("median3_kernel(float*)", "kernel", 65.0, 5.0),
           ("void at::native::elementwise_kernel<...>()", "kernel", 90.0,
            10.0)]
    spans = [("issue", -5.0, 55.0), ("wait", 55.0, 100.0),
             ("loop", 100.0, 102.0)]
    return devtrace.TraceView(ops, spans, 1, frames, [0.001, 0.003],
                              stages)


def test_gaps_labelled_by_host_span():
    v = _view()
    g = devtrace.gaps(v.ops)
    assert [(s, n) for s, n, _ in g] == [(50.0, 10.0), (70.0, 20.0)]
    assert devtrace.span_at(v.spans, 55.0) == "wait"
    assert devtrace.span_at(v.spans, 52.0) == "issue"
    assert devtrace.idle_by_span(v.ops, v.spans) == {
        "wait": pytest.approx(30e-6)}
    b = devtrace.breakdown(v.ops, v.spans)
    assert b["device_ops"][0] == ["sgm_fused_kernel", 40e-6]
    assert b["idle_gaps"][0][0] == \
        "wait: before at::native::elementwise_kernel"
    assert v.window_us == 105.0


def test_short_names():
    assert devtrace.short("void a::b<c<d>, 3>(int*, float)") == "a::b"
    assert devtrace.short("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD"


def test_readers_on_a_hand_made_trace():
    from benchmark.harness import load_reader
    import os
    stages = {"cost": {"bytes": 3.35e6, "ops": 0},           # 1 us
              "sweeps": {"bytes": 0, "ops": 67e6 * 2},       # 2 us
              "select": {"bytes": 3.35e6 * 3, "ops": 0},     # 3 us
              "speckle": {"bytes": 3.35e6, "ops": 0},        # 1 us
              "median": {"bytes": 3.35e6, "ops": 0}}         # 1 us
    v = _view(stages)
    d = os.path.join(harness.ROOT, "benchmark", "metrics")

    def r(name):
        return load_reader(os.path.join(d, name + ".py"))(v)
    assert r("census_roofline") == pytest.approx(100 * 2 * 1 / 10)
    assert r("sweeps_roofline") == pytest.approx(100 * 2 * 5 / 40)
    # median3 + memset + the library kernel: 20 us
    assert r("postproc_roofline") == pytest.approx(100 * 2 * 2 / 20)
    assert r("frame_roofline") == pytest.approx(100 * 2 * 8 / 105)
    assert r("device.idle_pct") == pytest.approx(100 * 30 / 100)
    assert r("pipeline.device_ops_per_frame") == pytest.approx(5 / 2)
    assert r("pipeline.host_issue_ms") == pytest.approx(2.0)
    empty = devtrace.TraceView([], [], 0, 0, [], None)
    for name in ("census_roofline", "sweeps_roofline", "postproc_roofline",
                 "frame_roofline", "device.idle_pct",
                 "pipeline.device_ops_per_frame", "pipeline.host_issue_ms"):
        assert load_reader(os.path.join(d, name + ".py"))(empty) is None


def test_copy_readers_on_a_hand_made_trace():
    """api.copy_ms and api.copy_link_pct read the HtoD and DtoH copies of
    the view alone; nothing to read gives None, never 0."""
    from benchmark.harness import load_reader
    import os
    d = os.path.join(harness.ROOT, "benchmark", "metrics")

    def r(name, view):
        return load_reader(os.path.join(d, name + ".py"))(view)
    v = _view()
    assert r("api.copy_ms", v) is None and r("api.copy_link_pct", v) is None
    # two calls: 2 x 0.75 MB up in 50 us each, 1.5 MB down in 150 us
    v = devtrace.TraceView(v.ops, v.spans, 2, 16, [], None, copies=[
        ("HtoD", 0.0, 50.0, 0.75e6), ("HtoD", 60.0, 50.0, 0.75e6),
        ("DtoH", 200.0, 150.0, 1.5e6)])
    assert r("api.copy_ms", v) == pytest.approx(250e-3 / 2)
    assert r("api.copy_link_pct", v) == pytest.approx(
        100 * 3e6 / 250e-6 / 64e9)
    v.copies.append(("DtoH", 400.0, 10.0, None))
    assert r("api.copy_link_pct", v) is None
    assert r("api.copy_ms", v) == pytest.approx(260e-3 / 2)


def test_work_model_by_stage():
    pinned = {"mode": "sgm", "num_disparities": 128, "paths": 8,
              "disp12_max_diff": 1, "fill_mode": "off",
              "median_filter": True}
    st = workmodel.sgm_frame(pinned, (375, 1242))
    n = 375 * 1242
    cells = n * 128
    assert st["sweeps"]["ops"] == 7 * cells * 9
    assert st["select"]["ops"] == cells * 11
    assert st["cost"]["ops"] == cells * 4
    assert st["select"]["bytes"] == 3 * cells + 9 * n
    assert set(st) == {"cost", "sweeps", "select", "lr_check", "speckle",
                       "median"}
    # the sweeps are bound by their operations, the select by its bytes
    t = workmodel.least_seconds(st, ("sweeps",))
    assert t == pytest.approx(7 * cells * 9 / 67e12)


def test_ring_work_and_reader():
    """The exact ring's work comes from the sweeps stage alone: its 3
    bytes a cell and 9 operations a cell for each of the paths - 2
    directions that scan y; 53.5 us a frame at 376 x 1241 x 128, bound by
    the bytes. The reader takes it over the fused sweep's device time."""
    from benchmark.harness import load_reader
    import os
    cells = 376 * 1241 * 128
    for paths in (4, 8):
        pinned = {"mode": "sgm", "num_disparities": 128, "paths": paths,
                  "disp12_max_diff": 1, "fill_mode": "off",
                  "median_filter": True}
        w = workmodel.ring(workmodel.sgm_frame(pinned, (376, 1241)))
        assert w == {"bytes": 3 * cells, "ops": 9 * (paths - 2) * cells}
    assert workmodel.bound(w["bytes"], w["ops"]) == pytest.approx(
        53.4867e-6, rel=1e-5)
    read = load_reader(os.path.join(harness.ROOT, "benchmark", "metrics",
                                    "tiling.ring_roofline.py"))
    # a million cells of 8 paths: 3e6 bytes (0.896 us) and 6 x 9e6
    # operations (0.806 us) a frame; two frames over 40 us of fused sweep
    stages = {"sweeps": {"bytes": 3e6, "ops": 7 * 9e6}}
    assert read(_view(stages)) == pytest.approx(100 * 2 * (3e6 / 3.35e12)
                                                / 40e-6)
    assert read(_view(None)) is None
    no_fused = _view(stages)
    no_fused.ops = [o for o in no_fused.ops if "sgm_fused" not in o[0]]
    assert read(no_fused) is None


def test_compare_readings():
    import torch
    ref = torch.tensor([[[1.0, -1.0, 2.5, 3.0]]])
    assert harness.compare(ref.clone(), ref) == {"invalid_mismatch_px": 0,
                                                 "disp_gap_px": 0.0}
    out = torch.tensor([[[1.0, 4.0, 2.75, -1.0]]])
    assert harness.compare(out, ref) == {"invalid_mismatch_px": 2,
                                         "disp_gap_px": 0.25}
    out[0, 0, 0] = float("nan")
    assert harness.compare(out, ref)["disp_gap_px"] == harness.NO_ANSWER
    short = harness.compare(ref[:, :, :2], ref)
    assert short["disp_gap_px"] == harness.NO_ANSWER
    assert not harness.verdict(short, {"invalid_mismatch_px": 0,
                                       "disp_gap_px": 0.01}, 1)
