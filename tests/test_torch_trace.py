"""The pipeline's stage spans (`tpustereo_torch.trace`), on the CPU: off
without a profiler (the shared no-op, `record_function` never entered),
under `torch.profiler` the spans of each stage nested in their call and
counted per set of frames, on the fused route, the volume route, a batch
that `frames_per_step` does not divide and the gap fills; the outputs the
same bit for bit with the profiler on and off."""

import pytest
import torch

from tpustereo_torch import trace
from tpustereo_torch.config import PRESETS
from tpustereo_torch.ops import postproc
from tpustereo_torch.pipeline import sgbm_batched
from tpustereo_torch.pipeline.sgbm import volume_route


def _pairs(B, H=20, W=40, seed=5):
    g = torch.Generator().manual_seed(seed)
    L = torch.randint(0, 256, (B, H, W), dtype=torch.uint8, generator=g)
    return L, torch.roll(L, -3, dims=-1)


def _spans(fn):
    """fn() under a CPU profiler -> (its result, [(span, innermost tps.*
    span around it or None)] in order of start)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    got = []
    for e in prof.events():
        if not e.name.startswith(trace.PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(trace.PREFIX):
            p = p.cpu_parent
        got.append((e.name, p.name if p is not None else None))
    return out, got


def _expected(chunks, volume=False, fill=False):
    """The spans of one `sgbm_batched` call of `kitti_sgm8` (speckle and
    the median on) with `chunks` sets of frames."""
    per = [("tps.frames", "tps.sgbm_batched"), ("tps.census", "tps.frames"),
           ("tps.sweeps", "tps.frames")]
    per += ([("tps.select", "tps.frames")] if volume
            else [("tps.lr_check", "tps.frames")])
    per += [("tps.speckle", "tps.frames"),
            ("tps.speckle.labels", "tps.speckle"),
            ("tps.speckle.sizes", "tps.speckle")]
    per += [("tps.fill", "tps.frames")] if fill else []
    per += [("tps.median", "tps.frames")]
    return ([("tps.sgbm_batched", None)] + per * chunks
            + [("tps.cat", "tps.sgbm_batched")])


def test_off_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("census") is trace.span("sweeps")
    with trace.span("census"):
        pass
    L, R = _pairs(2)
    cfg = PRESETS["kitti_sgm8"].replace(num_disparities=16,
                                        frames_per_step=2)
    assert sgbm_batched(L, R, cfg).shape == (2, 20, 40)


def test_span_name_under_a_profiler():
    def one():
        with trace.span("census"):
            pass
    _, got = _spans(one)
    assert got == [("tps.census", None)]


@pytest.mark.parametrize("B, kw, chunks, volume, fill", [
    (4, dict(), 2, False, False),
    (4, dict(p2=1000), 2, True, False),
    (3, dict(), 3, False, False),
    (2, dict(fill_mode="background"), 1, False, True),
    (2, dict(fill_mode="hirschmuller", p2=1000), 1, True, True),
], ids=["fused", "volume", "b3_f2", "fused_background", "volume_hirsch"])
def test_spans_of_a_call(B, kw, chunks, volume, fill):
    cfg = PRESETS["kitti_sgm8"].replace(num_disparities=16,
                                        frames_per_step=2, **kw)
    L, R = _pairs(B)
    assert volume_route(cfg, L.shape[-1]) == volume
    off = sgbm_batched(L, R, cfg)
    on, got = _spans(lambda: sgbm_batched(L, R, cfg))
    assert got == _expected(chunks, volume, fill)
    assert torch.equal(on, off)


@pytest.mark.parametrize("mode, kw, first", [
    ("sad", dict(sad_block=5), ["tps.sweeps", "tps.lr_check"]),
    ("census_wta", dict(), ["tps.census", "tps.sweeps"]),
])
def test_spans_of_the_other_modes(mode, kw, first):
    cfg = PRESETS["kitti_sgm8"].replace(num_disparities=16, mode=mode,
                                        frames_per_step=1, **kw)
    L, R = _pairs(1)
    off = sgbm_batched(L, R, cfg)
    on, got = _spans(lambda: sgbm_batched(L, R, cfg))
    names = [n for n, _ in got]
    assert names[2:2 + len(first)] == first
    assert all(p == "tps.frames" for n, p in got[2:2 + len(first)])
    assert torch.equal(on, off)


def test_spans_under_bitonic_speckle(monkeypatch):
    monkeypatch.setattr(postproc, "BITONIC_SPECKLE", True)
    cfg = PRESETS["kitti_sgm8"].replace(num_disparities=16,
                                        frames_per_step=2)
    L, R = _pairs(2)
    off = sgbm_batched(L, R, cfg)
    on, got = _spans(lambda: sgbm_batched(L, R, cfg))
    assert got == _expected(1)
    assert torch.equal(on, off)
