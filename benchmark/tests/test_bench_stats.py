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
