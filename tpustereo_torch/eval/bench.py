"""Benchmark harness: warm-up, a timed loop by CUDA events, a per-stage
time table, and a structured JSON run record (config, git sha, device,
frames/s, ms a frame, roofline, busy share). The counterpart of the JAX
package's `eval/bench.py`; every function takes a `device` ("cuda" unless
the caller passes "cpu", and raises when CUDA is absent).

On the card a loop is timed by two CUDA events around `iters` calls, after
one warm-up call (which builds the kernels at their first use) and a
`torch.cuda.synchronize()`, and synchronised after: the events read the
device's time for the whole loop, whatever the host queued. On the CPU,
for the tests only, the host clock times the loop and the record says
`"backend": "cpu"`: no device number comes from there.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpustereo_torch.api import _device
from tpustereo_torch.config import Config
from tpustereo_torch.eval.roofline import device_busy_fraction, roofline

# OpenCV StereoSGBM MODE_HH on the CPU at KITTI size (BASELINE.md): the
# proxy baseline of `bench.py`, a CPU figure, neither a TPU nor a card one
BASELINE_FPS = 2.72


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _describe(dev: torch.device) -> Tuple[str, str, int]:
    """(backend, device kind, device count) of the run's device."""
    if dev.type == "cuda":
        return "cuda", torch.cuda.get_device_name(dev), \
            torch.cuda.device_count()
    return "cpu", "cpu", 1


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------

def cuda_ms(fn: Callable[[], object], reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events around reps
    calls (after `warmup` untimed calls and a synchronize)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean device milliseconds of fn(), a few kernel launches that never
    synchronise: `reps` calls captured in one CUDA graph, replayed between
    two events, so the host's time per launch (tens of µs through the
    Python wrappers, more than a short kernel takes) drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def _timed_device_loop(fn, *args, iters: int = 20) -> float:
    """Seconds a call of fn(*args) on the device of args[0]: `cuda_ms`
    over `iters` calls on the card, the host clock on the CPU (after one
    warm-up call). The JAX harness tweaks an input each iteration and
    folds the outputs into a checksum, because XLA would otherwise merge
    the identical calls of its one-program loop or drop their unused
    results. Eager PyTorch runs every call as issued and drops nothing, so
    neither is needed, and the loop allocates nothing of its own."""
    if args[0].device.type == "cuda":
        return cuda_ms(lambda: fn(*args), iters) / 1e3
    fn(*args)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def profile_busy(fn: Callable[[], object], calls: int = 1,
                 trace_dir: Optional[str] = None,
                 sessions: int = 3) -> Optional[dict]:
    """`roofline.device_busy_fraction` of `calls` calls of fn() on the
    card under `torch.profiler` (fn is called once untraced first): the
    Chrome trace is written to trace_dir (a temporary directory when None)
    and read back. A session now and then records none or only part of the
    device's work: a trace with fewer kernel events than the port's
    wrappers counted launches over the traced calls is refused, the
    session is run again, up to `sessions` times in all, and None comes
    back only when every one was refused. The record gains `launches`, the
    wrappers' count it was held to."""
    from torch.profiler import ProfilerActivity, profile

    from tpustereo_torch.kernels import launch_counts
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        out = trace_dir or tmp
        os.makedirs(out, exist_ok=True)
        for i in range(sessions):
            before = sum(launch_counts().values())
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            launches = sum(launch_counts().values()) - before
            prof.export_chrome_trace(os.path.join(
                out, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{i}.json"))
            busy = device_busy_fraction(out, min_kernels=launches)
            if busy is not None:
                return dict(busy, launches=launches)
    return None


def device_busy(fn: Callable[[], object]) -> str:
    """Device time by kernel and the device's busy share over one call of
    fn(), as a line of text."""
    b = profile_busy(fn)
    if b is None:
        return "not measured (the profiler recorded no device events)"
    return (f"span {b['span_ms']:.3f} ms, kernels {b['busy_ms']:.3f} ms, "
            f"busy {b['busy_fraction']:.4f}; top: "
            + "; ".join(f"{n} {ms:.3f} ms" for n, ms in b["top_ms"]))


# ---------------------------------------------------------------------------
# stage tables
# ---------------------------------------------------------------------------

def stage_times(left, right, cfg: Config, iters: int = 5,
                device="cuda") -> Dict[str, float]:
    """Per-stage milliseconds of one (H, W) pair, each stage timed alone
    through the port's kernel wrappers on the route the pipeline takes
    (the stages' sum bounds the whole from above), under the JAX stage
    names: the cost ("census+cost_volume(fused)", "sad_fused(volume+wta)"
    or "sad_volume"); the fused SGM route's "sgm_select(4 sweeps+wta
    fused)" and "dr_consistency"; over a whole volume "aggregate" (SGM),
    "wta_subpixel" (`wta_lr`, LR check off) and "lr_check" (`wta_lr` with
    it: the port checks inside the selection kernel); then "speckle" and
    "median3"."""
    from tpustereo_torch import kernels
    from tpustereo_torch.ops import sad_volume
    from tpustereo_torch.ops.postproc import speckle_frames
    from tpustereo_torch.pipeline.sgbm import (check_slice, sgbm_volume,
                                               volume_route)

    check_slice(cfg)
    dev = _device(device)
    L = torch.from_numpy(np.ascontiguousarray(left))[None].to(dev)
    R = torch.from_numpy(np.ascontiguousarray(right))[None].to(dev)
    D, d0, lr = cfg.num_disparities, cfg.min_disparity, cfg.disp12_max_diff
    ms: Dict[str, float] = {}

    def t(name, fn, *args):
        ms[name] = _timed_device_loop(fn, *args, iters=iters) * 1e3

    def census(l):
        return kernels.census_cost_volume(l, R, D, cfg.max_census_cost,
                                          cfg.census_window, d0)

    vroute = volume_route(cfg, L.shape[-1])
    if cfg.mode == "sad" and not vroute:
        t("sad_fused(volume+wta)", lambda l: kernels.sad_wta(l, R, cfg), L)
        disp, valid, d_r = kernels.sad_wta(L, R, cfg)
    elif cfg.mode == "sad":
        t("sad_volume", lambda l: sad_volume(l, R, D, cfg.sad_block, d0), L)
    else:
        t("census+cost_volume(fused)", census, L)
    if cfg.mode == "sgm" and not vroute:
        C = census(L)
        t("sgm_select(4 sweeps+wta fused)",
          lambda c: kernels.sgm_select(c, cfg, L), C)
        disp, valid, d_r = kernels.sgm_select(C, cfg, L)
        del C
    elif cfg.mode != "sad" or vroute:
        S = sgbm_volume(L, R, cfg) if vroute else census(L)
        if cfg.mode == "sgm":
            t("aggregate", lambda l: sgbm_volume(l, R, cfg), L)
        t("wta_subpixel", lambda s: kernels.wta_lr(
            s, cfg.replace(disp12_max_diff=-1)), S)
        if lr >= 0:
            t("lr_check", lambda s: kernels.wta_lr(s, cfg), S)
        disp, valid = kernels.wta_lr(S, cfg)
        del S
        d_r = None
    if d_r is not None and lr >= 0:
        t("dr_consistency", lambda r: kernels.dr_consistency(
            r, disp, D, lr, d0), d_r)
    if cfg.speckle_window_size > 0:
        t("speckle", lambda d: speckle_frames(
            d, valid, cfg, cc=kernels.connected_component_labels,
            sort=kernels.bitonic_sort), disp)
    if cfg.median_filter:
        t("median3", kernels.median3, disp)
    return {k: round(v, 3) for k, v in ms.items()}


def production_stage_times(cfg: Config, lefts: torch.Tensor,
                           rights: torch.Tensor, iters: int = 10
                           ) -> Dict[str, float]:
    """In-context per-stage ms a frame of the batched pipeline as the user
    runs it (`sgbm_batched`, `frames_per_step` frames a set of launches),
    by differencing: the whole pipeline, then the same with one
    post-processing stage off at a time (`cfg.replace`), each difference
    that stage's. 'core(cost+sweeps+wta)' runs with all of them off;
    'unattributed' is full - core - the stages (overlap; may be slightly
    negative)."""
    from tpustereo_torch.pipeline import sgbm_batched

    batch = lefts.shape[0]

    def ms_for(c: Config) -> float:
        sec = _timed_device_loop(lambda l, r: sgbm_batched(l, r, c),
                                 lefts, rights, iters=iters)
        return sec / batch * 1e3

    full = ms_for(cfg)
    out: Dict[str, float] = {"full_pipeline": full}
    strip = {}
    if cfg.speckle_window_size > 0:
        out["speckle"] = full - ms_for(cfg.replace(speckle_window_size=0))
        strip["speckle_window_size"] = 0
    if cfg.median_filter:
        out["median3"] = full - ms_for(cfg.replace(median_filter=False))
        strip["median_filter"] = False
    if cfg.disp12_max_diff >= 0 and cfg.fill_mode != "hirschmuller":
        out["lr_check"] = full - ms_for(cfg.replace(disp12_max_diff=-1))
        strip["disp12_max_diff"] = -1
    if cfg.fill_mode != "off":
        out["fill"] = full - ms_for(cfg.replace(fill_mode="off"))
        strip["fill_mode"] = "off"
    core = ms_for(cfg.replace(**strip))
    out["core(cost+sweeps+wta)"] = core
    out["unattributed"] = full - core - sum(
        v for k, v in out.items() if k not in ("full_pipeline",
                                               "core(cost+sweeps+wta)"))
    return {k: round(v, 3) for k, v in out.items()}


# ---------------------------------------------------------------------------
# run records
# ---------------------------------------------------------------------------

def _mesh_on(mesh, dev: torch.device):
    """`mesh`, which must lie on dev, or the JAX default, (data=1,
    strip=the device count): on one card a one-strip mesh; over several
    distinct cards `make_mesh` raises `NotImplementedError` (ROADMAP.md
    queue 1, item 7)."""
    from tpustereo_torch.dist import make_mesh
    if mesh is None:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        mesh = make_mesh(1, n, devices=[f"cuda:{i}" for i in range(n)]
                         if dev.type == "cuda" else [dev])
    if mesh.device != dev:
        raise ValueError(f"the mesh is on {mesh.device}, the run on {dev}")
    return mesh


def odometry_loop(cfg: Config, shape: Tuple[int, int] = (375, 1242),
                  frames: int = 4, ocfg=None, stacked: bool = False,
                  tiled: bool = False, mesh=None, device="cuda"):
    """The work `run_odometry_benchmark` times, on its inputs: (track_many,
    lefts, rights, cfg as run, the odometry config); track_many(lefts,
    rights) tracks every frame against the sequence's first."""
    from tpustereo_torch.data import synthetic_sequence
    from tpustereo_torch.odometry import OdometryConfig
    from tpustereo_torch.odometry.backend import _DESC_DIM
    from tpustereo_torch.odometry.fused import (fused_track_frames,
                                                fused_track_from_disp,
                                                fused_track_step)

    dev = _device(device)
    if tiled:
        from tpustereo_torch.dist import sgbm_tiled
        mesh = _mesh_on(mesh, dev)
        cfg = cfg.replace(strips=mesh.shape["strip"])
    else:
        cfg = cfg.replace(strips=1)
    ocfg = ocfg or OdometryConfig()
    calib, seq, _ = synthetic_sequence(
        n_frames=frames + 1, shape=shape, depth=12.0, fx=718.0,
        baseline=0.54, step_x=0.08, slant=0.35, seed=3)
    intr = torch.tensor([calib.fx, calib.fy, calib.cx, calib.cy],
                        dtype=torch.float32, device=dev)
    base = torch.tensor(calib.baseline, dtype=torch.float32, device=dev)
    K = ocfg.max_corners
    zeros = (torch.zeros((K, _DESC_DIM), dtype=torch.float32, device=dev),
             torch.zeros((K,), dtype=torch.bool, device=dev),
             torch.zeros((K, 3), dtype=torch.float32, device=dev))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out0 = fused_track_step(up(seq[0][0]), up(seq[0][1]), *zeros, intr,
                            base, cfg.replace(strips=1), ocfg)
    kf = (out0.desc, out0.valid, out0.X)
    Ls = up(np.stack([L for L, _ in seq[1:]]))
    Rs = up(np.stack([R for _, R in seq[1:]]))

    if stacked:
        def track_many(ls, rs):
            fused_track_frames(ls, rs, *kf, intr, base, cfg, ocfg)
    elif tiled:
        def track_many(ls, rs):
            for f in range(ls.shape[0]):
                disp = sgbm_tiled(ls[f], rs[f], cfg, mesh)
                fused_track_from_disp(ls[f], disp, *kf, intr, base, cfg,
                                      ocfg)
    else:
        def track_many(ls, rs):
            for f in range(ls.shape[0]):
                fused_track_step(ls[f], rs[f], *kf, intr, base, cfg, ocfg)
    return track_many, Ls, Rs, cfg, ocfg


def run_odometry_benchmark(cfg: Config, shape: Tuple[int, int] = (375, 1242),
                           frames: int = 4, iters: int = 10, ocfg=None,
                           stacked: bool = False, tiled: bool = False,
                           mesh=None, device="cuda") -> dict:
    """Frames/s of the odometry's tracking step on the device: the SGM
    matcher, corners, descriptors, keyframe matching and the GN pose, over
    `frames` pairs against one keyframe, a call per frame (the host's
    keyframe bookkeeping and the decision's transfer are left out, as in
    the JAX harness).

    Untiled: `fused_track_step` with cfg.strips = 1. stacked: all frames
    in one `fused_track_frames` call. tiled: the strip-tiled matcher
    (`dist.sgbm_tiled` over `mesh`, by default (data=1, strip=the device
    count)) feeding `fused_track_from_disp`, cfg.strips set to the mesh's
    strips, so the record's config is what was measured."""
    track_many, Ls, Rs, cfg, ocfg = odometry_loop(
        cfg, shape, frames, ocfg, stacked, tiled, mesh, device)
    H, W = shape
    sec = _timed_device_loop(track_many, Ls, Rs, iters=iters) / frames
    backend, kind, _ = _describe(Ls.device)
    return {
        "metric": (f"odometry fused-"
                   f"{'chunk' if stacked else 'tiled' if tiled else 'step'}"
                   f" fps/chip ({H}x{W}, D={cfg.num_disparities}, "
                   f"{cfg.paths}-path"
                   + (f", strips={cfg.strips}" if tiled else "") + ")"),
        "value": round(1.0 / sec, 3),
        "unit": "fps/chip",
        "ms_per_frame": round(sec * 1e3, 4),
        "stacked": stacked,
        "tiled": tiled,
        "frames_per_step": frames,
        "max_corners": ocfg.max_corners,
        "device_kind": kind,
        "backend": backend,
        "git_sha": _git_sha(),
        "config": dataclasses.asdict(cfg),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def run_benchmark(cfg: Config, shape: Tuple[int, int] = (375, 1242),
                  batch: int = 2, iters: int = 10, stages: bool = False,
                  tiled: bool = False, mesh: Optional[object] = None,
                  profile_dir: Optional[str] = None, device="cuda") -> dict:
    """One benchmark run -> a structured record: `batch` copies of
    `synthetic_pair(shape, disparity=40, slope=0.02, seed=0)` on the
    device through `sgbm_batched` (or, tiled, `dist.sgbm_tiled_batched`
    over `mesh`, by default (data=1, strip=the device count)), timed over
    `iters` calls.

    stages: the differenced stage table (`production_stage_times`), or,
    tiled, `stage_times` of one pair. Untiled runs carry `roofline`.
    profile_dir (card only): after the timed loop, three more calls run
    under `torch.profiler`, whose Chrome trace is written there and read
    into `device_busy_fraction`; the profiler's cost stays out of the
    timed number."""
    from tpustereo_torch.data import synthetic_pair
    from tpustereo_torch.pipeline import sgbm_batched

    dev = _device(device)
    if profile_dir and dev.type != "cuda":
        raise ValueError("profile_dir needs the card: the busy share is a "
                         "device measurement")
    H, W = shape
    L, R, _, _ = synthetic_pair((H, W), disparity=40.0, slope=0.02, seed=0)
    lefts = torch.from_numpy(np.stack([L] * batch)).to(dev)
    rights = torch.from_numpy(np.stack([R] * batch)).to(dev)
    backend, kind, n_devices = _describe(dev)
    if tiled:
        from tpustereo_torch.dist import sgbm_tiled_batched
        mesh = _mesh_on(mesh, dev)
        cfg = cfg.replace(strips=mesh.shape["strip"], batch_size=batch)

        def fn(l, r):
            return sgbm_tiled_batched(l, r, cfg, mesh)
        chips = len({d for row in mesh.grid for d in row})
    else:
        cfg = cfg.replace(batch_size=batch)

        def fn(l, r):
            return sgbm_batched(l, r, cfg)
        chips = 1
    sec = _timed_device_loop(fn, lefts, rights, iters=iters)

    fps = batch / sec
    mode = {"sad": f"SAD block-{cfg.sad_block}",
            "census_wta": "census+WTA"}.get(cfg.mode,
                                            f"SGM {cfg.paths}-path")
    record = {
        "metric": f"{mode} fps/chip ({H}x{W}, D={cfg.num_disparities})",
        "value": round(fps / chips, 3),
        "unit": "fps/chip",
        "vs_baseline": round(fps / chips / BASELINE_FPS, 2),
        "fps_total": round(fps, 3),
        "ms_per_frame": round(sec / batch * 1e3, 4),
        "batch": batch,
        "chips": chips,
        "n_devices": n_devices,
        "device_kind": kind,
        "backend": backend,
        "tiled": tiled,
        "git_sha": _git_sha(),
        "config": dataclasses.asdict(cfg),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    if stages:
        record["stage_ms"] = (stage_times(L, R, cfg, device=dev) if tiled
                              else production_stage_times(cfg, lefts, rights,
                                                          iters=iters))
    # one card's peaks against a tiled run would misstate it by the strip
    # count on several cards: untiled runs only, as in the JAX harness
    if not tiled:
        core_ms = (record.get("stage_ms") or {}).get("core(cost+sweeps+wta)")
        record["roofline"] = roofline(
            cfg, shape, sec / batch, device_name=kind,
            core_sec_per_frame=core_ms / 1e3 if core_ms else None)
    if profile_dir:
        busy = profile_busy(lambda: fn(lefts, rights), calls=3,
                            trace_dir=profile_dir)
        if busy:
            record["device_busy_fraction"] = busy
    return record

