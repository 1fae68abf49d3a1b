#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`tpustereo_torch`) on one CUDA card.

    python3 chip_smoke.py

Builds the eight CUDA kernels from `tpustereo_torch/csrc/` with nvcc, then
runs the port's paths.

The KITTI 8-path SGM preset as it stands (`PRESETS["kitti_sgm8"]`: speckle
window 100, range 2, the 3x3 median), at full KITTI size (375 x 1242,
D = 128, 8 frames, 4 per set of kernel launches):

1. builds the kernels and prints what ptxas says of each;
2. runs each of the path's six kernels and its plain PyTorch version on the
   card at the main path's shapes (the speckle and median kernels on the
   main path's own disparity maps) and requires integer and bool outputs
   and the median to be equal and the float disparity to agree within 1e-6;
3. drives `api.match_batch` on 8 synthetic pairs with every launch counter
   set to 0 just before, requires every kernel of the path to have
   launched, and holds the output against the plain PyTorch pipeline (the
   JAX package's jnp formulation, ported) run on the card;
4. times each kernel, its plain version, `component_big`, the whole path,
   and the whole path with speckle and the median off, with CUDA events,
   and prints them beside the card's name and power limit.

The SAD and census_wta modes, each preset as it stands
(`PRESETS["tsukuba_sad"]` at Tsukuba's 288 x 384, D = 64, block 9;
`PRESETS["middlebury_census_wta"]` at Middlebury half size, 375 x 621,
D = 128), on 8 synthetic pairs each:

5. holds `sad_wta` and `wta_lr` against their plain versions at those
   geometries, with the presets' LR check off and with it on
   (disp12_max_diff = 1), on 8 frames in one launch and on one;
6. drives `api.match_batch` on each preset, and on tsukuba_sad with the LR
   check on, with the launch counters set to 0 just before each; requires
   `sad_wta` (and `dr_consistency` with the LR check), `census_cost_volume`
   and `wta_lr` to have launched; holds each output against the plain
   pipeline on the card; and requires a valid fraction and bad-2.0 against
   the synthetic ground truth within bars set below the plain pipeline's
   own figures (`MODES`);
7. times both kernels per launch, their plain versions and bounds, each
   path at one frame per launch (the presets) and at 8, through
   `match_batch`, and the profiler's busy share.

Prints a `{"kernels": [...]}` line with all eight kernels (the launches of
the KITTI six from step 3, those of `sad_wta` and `wta_lr` from their
presets' runs in step 6), then `{"ok": true, "device": ...}` as the last
line. Exits non-zero, with no result, on any failure or when CUDA is
absent. Needs no network; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

SHAPE = (375, 1242)
BATCH = 8
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (data sheet)
SCALAR_OPS_PER_S = 67e12    # H100 SXM rate outside the tensor cores
DISP_TOL = 1e-6

KERNELS = {
    "census_cost_volume": ("tpustereo_torch/csrc/census_cost.cu",
                           "tpustereo/kernels/cost_pallas.py:164"),
    "sgm_sweep": ("tpustereo_torch/csrc/sgm_sweep.cu",
                  "tpustereo/kernels/sgm_pallas.py:664"),
    "sweep_bwd_wta": ("tpustereo_torch/csrc/bwd_wta.cu",
                      "tpustereo/kernels/sgm_pallas.py:1225"),
    "dr_consistency": ("tpustereo_torch/csrc/lr_check.cu",
                       "tpustereo/kernels/lr_pallas.py:83"),
    "connected_component_labels": ("tpustereo_torch/csrc/cc_labels.cu",
                                   "tpustereo/kernels/cc_pallas.py:148"),
    "median3": ("tpustereo_torch/csrc/median3.cu",
                "tpustereo/kernels/median_pallas.py:41"),
}
# the kernels of the SAD and census_wta paths that the KITTI path does not run
MODE_KERNELS = {
    "wta_lr": ("tpustereo_torch/csrc/wta_lr.cu",
               "tpustereo/kernels/wta_pallas.py:162"),
    "sad_wta": ("tpustereo_torch/csrc/sad_wta.cu",
                "tpustereo/kernels/sad_pallas.py:187"),
}
# preset: (frame shape, synthetic disparity, valid-fraction floor, bad-2.0
# ceiling). The bars sit below what the plain pipeline, which step 6 holds
# each output equal to, gives on these pairs: tsukuba_sad valid 0.993,
# bad-2.0 0.0081 (0.948 / 0.0082 with the LR check at max_diff 1);
# middlebury_census_wta valid 0.987, bad-2.0 0.099 (no aggregation, so far
# noisier than SGM).
MODES = {
    "tsukuba_sad": ((288, 384), 20.0, 0.9, 0.05),
    "middlebury_census_wta": ((375, 621), 40.0, 0.9, 0.15),
}


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch
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


def device_busy(fn) -> str:
    """Device time by kernel and the device's busy share over one call of
    fn(), from `torch.profiler` (the span runs from the first kernel's start
    to the last one's end)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return "not measured (the profiler recorded no device events)"
    span_us = (max(e.time_range.end for e in evs)
               - min(e.time_range.start for e in evs))
    busy_us = sum(e.time_range.elapsed_us() for e in evs)
    by_name: dict = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (f"span {span_us / 1e3:.3f} ms, kernels {busy_us / 1e3:.3f} ms, "
            f"busy {busy_us / span_us:.4f}; top: "
            + "; ".join(f"{n[:60]} {us / 1e3:.3f} ms" for n, us in top))


def bound(nbytes: float, ops: float):
    """(least ms for the work, which of bytes / operations binds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def plain_pipeline(L, R, cfg):
    """(F, H, W) frames through the JAX package's jnp formulation, ported:
    the mode's full cost volume (SGM: aggregated), `ops.wta`,
    `ops.lr_check` (true-unit d_R of the volume), plain speckle and median.
    No kernel runs."""
    import torch
    from tpustereo_torch.kernels.cost import census_cost_volume_plain
    from tpustereo_torch.ops import (aggregate, lr_check, median3,
                                     sad_volume, speckle_frames, wta)
    D, d0 = cfg.num_disparities, cfg.min_disparity
    if cfg.mode == "sad":
        S = sad_volume(L, R, D, cfg.sad_block, d0)
    else:
        S = census_cost_volume_plain(L, R, D, cfg.max_census_cost,
                                     cfg.census_window, d0)
        if cfg.mode == "sgm":
            S = aggregate(S, cfg)
    disp, _, valid = wta(S, cfg)
    valid &= lr_check(S, disp, cfg)
    del S
    out = torch.where(speckle_frames(disp, valid, cfg), disp, -1.0)
    return median3(out) if cfg.median_filter else out


def modes_path(card: str) -> list:
    """The SAD and census_wta paths: each new kernel against its plain
    version at its preset's geometry, LR check off (the presets) and on;
    `api.match_batch` on each unmodified preset (and tsukuba_sad with the
    LR check) against the plain pipeline; then times. Returns the two
    kernels' rows of the `kernels` line."""
    import torch
    from tpustereo_torch import PRESETS, api, kernels
    from tpustereo_torch.data import synthetic_pair
    from tpustereo_torch.kernels.sad import sad_wta_plain
    from tpustereo_torch.kernels.wta import wta_lr_plain
    from tpustereo_torch.kernels.cost import census_cost_volume_plain
    from tpustereo_torch.pipeline import sgbm_batched

    dev = torch.device("cuda")
    data = {}
    for name, (shape, d_true, _, _) in MODES.items():
        pairs = [synthetic_pair(shape, disparity=d_true, seed=s)
                 for s in range(BATCH)]
        lefts = np.stack([p[0] for p in pairs])
        rights = np.stack([p[1] for p in pairs])
        gts = np.stack([np.where(p[3], p[2], -1.0) for p in pairs])
        data[name] = (lefts, rights, gts, torch.from_numpy(lefts).to(dev),
                      torch.from_numpy(rights).to(dev))
    sad_cfg = PRESETS["tsukuba_sad"]
    cw_cfg = PRESETS["middlebury_census_wta"]
    lr_on = dict(disp12_max_diff=1)

    # --- 5. the two kernels against their plain versions, LR off and on,
    # on all 8 frames in one launch and on one frame (the preset's
    # frames_per_step)
    err = {"wta_lr": 0.0, "sad_wta": 0.0}
    L, R = data["tsukuba_sad"][3:]
    for cfg in (sad_cfg, sad_cfg.replace(**lr_on)):
        for n in (BATCH, 1):
            disp, valid, d_r = kernels.sad_wta(L[:n], R[:n], cfg)
            disp_p, valid_p, d_r_p = sad_wta_plain(L[:n], R[:n], cfg)
            torch.cuda.synchronize()
            what = f"sad_wta (frames {n}, max_diff {cfg.disp12_max_diff})"
            require(torch.equal(valid, valid_p), f"{what} valid differs")
            require((d_r is None and d_r_p is None)
                    or torch.equal(d_r, d_r_p), f"{what} d_r differs")
            e = (disp - disp_p).abs().max().item()
            require(e <= DISP_TOL, f"{what} disp differs by {e}")
            err["sad_wta"] = max(err["sad_wta"], e)
    del disp_p, valid_p, d_r_p
    D, d0 = cw_cfg.num_disparities, cw_cfg.min_disparity
    L, R = data["middlebury_census_wta"][3:]
    C = kernels.census_cost_volume(L, R, D, cw_cfg.max_census_cost,
                                   cw_cfg.census_window, d0)
    require(torch.equal(C, census_cost_volume_plain(
        L, R, D, cw_cfg.max_census_cost, cw_cfg.census_window, d0)),
        "census_cost_volume differs from plain at Middlebury geometry")
    for cfg in (cw_cfg, cw_cfg.replace(**lr_on)):
        for n in (BATCH, 1):
            disp, valid = kernels.wta_lr(C[:n], cfg)
            disp_p, valid_p = wta_lr_plain(C[:n], cfg)
            torch.cuda.synchronize()
            what = f"wta_lr (frames {n}, max_diff {cfg.disp12_max_diff})"
            require(torch.equal(valid, valid_p), f"{what} valid differs")
            e = (disp - disp_p).abs().max().item()
            require(e <= DISP_TOL, f"{what} disp differs by {e}")
            err["wta_lr"] = max(err["wta_lr"], e)
    del disp_p, valid_p
    for name, e in err.items():
        print(f"check {name}: max abs diff to plain = {e} (LR off and on, "
              f"{BATCH} frames and 1)", flush=True)

    # --- 6. each path through the user's entry point
    runs = [("tsukuba_sad", sad_cfg, ("sad_wta",)),
            ("tsukuba_sad", sad_cfg.replace(**lr_on),
             ("sad_wta", "dr_consistency")),
            ("middlebury_census_wta", cw_cfg,
             ("census_cost_volume", "wta_lr"))]
    launches = {}
    for name, cfg, need in runs:
        lefts, rights, gts, L, R = data[name]
        H, W = MODES[name][0]
        kernels.reset_launch_counts()
        out = api.match_batch(lefts, rights, cfg)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        label = f"{name} (max_diff {cfg.disp12_max_diff})"
        print(f"{label} path launches: {counts}", flush=True)
        for k in need:
            require(counts[k] > 0, f"{k} was not launched on the {label} "
                    f"path")
        if cfg == PRESETS[name]:
            launches.update({k: counts[k] for k in MODE_KERNELS
                             if counts[k] > 0})
        require(out.shape == (BATCH, H, W) and np.isfinite(out).all(),
                f"{label} output has the wrong shape or non-finite values")
        ref = plain_pipeline(L, R, cfg).cpu().numpy()
        require(np.array_equal(out == -1.0, ref == -1.0),
                f"{label} invalid pattern differs from the plain pipeline")
        path_err = float(np.abs(out - ref).max())
        require(path_err <= DISP_TOL,
                f"{label} disparity differs from the plain pipeline")
        m = gts > 0
        bad2 = float(((np.abs(out - gts) > 2.0) | (out < 0))[m].mean())
        vfrac = float((out >= 0).mean())
        print(f"{label} vs plain pipeline: max abs diff {path_err}; valid "
              f"fraction {vfrac:.4f}; bad-2.0 vs ground truth {bad2:.4f}",
              flush=True)
        _, _, v_min, bad_max = MODES[name]
        require(vfrac > v_min and bad2 < bad_max,
                f"{label} output is not a good disparity map")

    # --- 7. timing: each kernel per launch at the path's shape (one frame,
    # the presets' frames_per_step) and with all 8 frames in one launch
    L, R = data["tsukuba_sad"][3:]
    L1, R1 = L[:1].contiguous(), R[:1].contiguous()
    C1 = C[:1].contiguous()
    ms = {"sad_wta": cuda_ms(lambda: kernels.sad_wta(L1, R1, sad_cfg), 20),
          "wta_lr": cuda_ms(lambda: kernels.wta_lr(C1, cw_cfg), 50)}
    plain_ms = {
        "sad_wta": cuda_ms(lambda: sad_wta_plain(L1, R1, sad_cfg), 3),
        "wta_lr": cuda_ms(lambda: wta_lr_plain(C1, cw_cfg), 3)}
    ms8 = {"sad_wta": cuda_ms(lambda: kernels.sad_wta(L, R, sad_cfg), 5),
           "wta_lr": cuda_ms(lambda: kernels.wta_lr(C, cw_cfg), 10)}
    ms_lr = {
        "sad_wta": cuda_ms(lambda: kernels.sad_wta(
            L1, R1, sad_cfg.replace(**lr_on)), 20),
        "wta_lr": cuda_ms(lambda: kernels.wta_lr(
            C1, cw_cfg.replace(**lr_on)), 50)}
    print(f"[{card}] ms per launch of 8 frames: {ms8}; of one frame with "
          f"the LR check on: {ms_lr}", flush=True)
    Hs, Ws = MODES["tsukuba_sad"][0]
    Hc, Wc = MODES["middlebury_census_wta"][0]
    n_sad = Hs * Ws * sad_cfg.num_disparities
    n_cw = Hc * Wc * D
    bounds = {
        # images read once, disp + valid written; ~11 integer ops per cost
        # (difference, abs, fill select, four running-sum adds, the packed
        # min, the second min)
        "sad_wta": bound(2 * Hs * Ws + 5 * Hs * Ws, 11 * n_sad),
        # C read once, disp + valid written; ~4 ops per cost (pack, min,
        # second min); the LR fold is off in the preset
        "wta_lr": bound(n_cw + 5 * Hc * Wc, 4 * n_cw),
    }

    rows = []
    for name, cfg in (("tsukuba_sad", sad_cfg),
                      ("middlebury_census_wta", cw_cfg)):
        lefts, rights, _, L, R = data[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            api.match_batch(lefts, rights, cfg)
        torch.cuda.synchronize()
        api_fps = BATCH * reps / (time.perf_counter() - t0)
        f1_ms = cuda_ms(lambda: sgbm_batched(L, R, cfg), reps)
        f8_ms = cuda_ms(lambda: sgbm_batched(
            L, R, cfg.replace(frames_per_step=BATCH)), reps)
        print(f"[{card}] {name} whole path: {BATCH * 1e3 / f1_ms:.2f} "
              f"frames/s on device tensors at frames_per_step 1 (the "
              f"preset; {f1_ms:.3f} ms per batch of {BATCH}), "
              f"{BATCH * 1e3 / f8_ms:.2f} at frames_per_step {BATCH} "
              f"({f8_ms:.3f} ms); {api_fps:.2f} frames/s through "
              f"match_batch (numpy in/out)", flush=True)
        busy = device_busy(lambda: sgbm_batched(L, R, cfg))
        print(f"[{card}] {name} profiler, one batch: {busy}", flush=True)
    for name, (src, replaces) in MODE_KERNELS.items():
        b_ms, b_by = bounds[name]
        print(f"[{card}] {name}: {ms[name]:.4f} ms/launch, "
              f"{launches[name]} launches per batch of {BATCH}, "
              f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms[name]:.3f} ms, "
              f"library None", flush=True)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": ms[name],
                     "plain_ms": plain_ms[name], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    return rows


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = card_line()
    print(card, flush=True)

    from tpustereo_torch import PRESETS, api, kernels
    from tpustereo_torch.data import synthetic_pair
    from tpustereo_torch.kernels import _build
    from tpustereo_torch.kernels.cost import census_cost_volume_plain
    from tpustereo_torch.kernels.lr import dr_consistency_plain
    from tpustereo_torch.kernels.sgm import (sgm_sweep_plain,
                                             sweep_bwd_wta_plain)
    from tpustereo_torch.ops import (component_big,
                                     connected_component_labels, median3)
    from tpustereo_torch.ops.postproc import speckle_conn
    from tpustereo_torch.ops.sgm import DIRS_8
    from tpustereo_torch.pipeline import sgbm_batched

    secs = _build.build()
    print(f"build: {secs:.1f} s for {len(_build.NAMES)} libraries", flush=True)
    for name in _build.NAMES:
        with open(_build.log_path(name)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    cfg = PRESETS["kitti_sgm8"]
    cfg_off = cfg.replace(speckle_window_size=0, median_filter=False)
    D, F = cfg.num_disparities, cfg.frames_per_step
    d0, p1, p2 = cfg.min_disparity, cfg.p1, cfg.p2
    pairs = [synthetic_pair(SHAPE, disparity=40.0, seed=s)
             for s in range(BATCH)]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    gts = np.stack([np.where(p[3], p[2], -1.0) for p in pairs])
    dev = torch.device("cuda")
    L = torch.from_numpy(lefts).to(dev)
    R = torch.from_numpy(rights).to(dev)
    Lf, Rf = L[:F].contiguous(), R[:F].contiguous()
    H, W = SHAPE
    n_pix = F * H * W
    n_cost = n_pix * D
    err = {}

    # --- 1. each kernel against its plain version, at the main path's shapes
    C = kernels.census_cost_volume(Lf, Rf, D, cfg.max_census_cost,
                                   cfg.census_window, d0)
    C_p = census_cost_volume_plain(Lf, Rf, D, cfg.max_census_cost,
                                   cfg.census_window, d0)
    torch.cuda.synchronize()
    require(torch.equal(C, C_p), "census_cost_volume differs from plain")
    err["census_cost_volume"] = (C.int() - C_p.int()).abs().max().item()
    del C_p

    S7 = torch.zeros(C.shape, dtype=torch.int16, device=dev)
    sweep_err = 0
    for dy, dx in DIRS_8:
        if (dy, dx) == (0, -1):
            continue
        S_k = torch.zeros_like(S7)
        S_p = torch.zeros_like(S7)
        kernels.sgm_sweep(C, S_k, dy, dx, p1, p2)
        sgm_sweep_plain(C, S_p, dy, dx, p1, p2)
        torch.cuda.synchronize()
        require(torch.equal(S_k, S_p), f"sgm_sweep {(dy, dx)} differs")
        sweep_err = max(sweep_err,
                        (S_k.int() - S_p.int()).abs().max().item())
        S7 += S_k
        del S_k, S_p
    err["sgm_sweep"] = sweep_err

    disp, valid, d_r = kernels.sweep_bwd_wta(C, S7, cfg)
    disp_p, valid_p, d_r_p = sweep_bwd_wta_plain(C, S7, cfg)
    torch.cuda.synchronize()
    require(torch.equal(valid, valid_p), "sweep_bwd_wta valid differs")
    require(torch.equal(d_r, d_r_p), "sweep_bwd_wta d_r differs")
    err["sweep_bwd_wta"] = (disp - disp_p).abs().max().item()
    require(err["sweep_bwd_wta"] <= DISP_TOL, "sweep_bwd_wta disp differs")
    del disp_p, valid_p, d_r_p

    ok = kernels.dr_consistency(d_r, disp, D, cfg.disp12_max_diff, d0)
    ok_p = dr_consistency_plain(d_r, disp, D, cfg.disp12_max_diff, d0)
    torch.cuda.synchronize()
    require(torch.equal(ok, ok_p), "dr_consistency differs from plain")
    err["dr_consistency"] = (ok.int() - ok_p.int()).abs().max().item()
    del ok_p

    # speckle labels and the median on the main path's own maps: the edge
    # masks of the WTA disparity over the LR-checked valid pixels
    valid_lr = valid & ok
    conn_h, conn_v = speckle_conn(disp, valid_lr, cfg)
    lab = kernels.connected_component_labels(conn_h, conn_v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lab_p = connected_component_labels(conn_h, conn_v)
    torch.cuda.synchronize()
    cc_plain_s = time.perf_counter() - t0
    require(torch.equal(lab, lab_p), "connected_component_labels differs")
    err["connected_component_labels"] = (lab - lab_p).abs().max().item()
    del lab_p
    # frame-offset labels, as speckle_frames hands them to component_big
    lab_off = lab + torch.arange(0, n_pix, H * W, dtype=torch.int32,
                                 device=dev).reshape(F, 1, 1)
    print(f"plain connected_component_labels at (F, H, W) = {(F, H, W)}: "
          f"{cc_plain_s:.3f} s; {torch.unique(lab_off).numel()} components "
          f"in the {F} frames", flush=True)
    med_in = torch.where(valid_lr & component_big(
        lab_off, cfg.speckle_window_size), disp, -1.0)
    med = kernels.median3(med_in)
    med_p = median3(med_in)
    torch.cuda.synchronize()
    require(torch.equal(med, med_p), "median3 differs from plain")
    err["median3"] = (med - med_p).abs().max().item()
    del med_p
    for name, e in err.items():
        print(f"check {name}: max abs diff to plain = {e}", flush=True)

    # --- 2. the main path, through the user's entry point
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = api.match_batch(lefts, rights, cfg)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    # the path's own peak, above what the checks above keep allocated
    peak_gib = (torch.cuda.max_memory_allocated() - resident) / 2**30
    print(f"main path launches: {launches}", flush=True)
    for name in KERNELS:
        require(launches[name] > 0, f"{name} was not launched on the main "
                f"path")
    require(out.shape == (BATCH, H, W) and np.isfinite(out).all(),
            "match_batch output has the wrong shape or non-finite values")

    ref = np.concatenate([plain_pipeline(L[i:i + F], R[i:i + F], cfg)
                          .cpu().numpy() for i in range(0, BATCH, F)])
    require(np.array_equal(out == -1.0, ref == -1.0),
            "invalid pattern differs from the plain pipeline")
    path_err = float(np.abs(out - ref).max())
    require(path_err <= DISP_TOL, "disparity differs from the plain pipeline")
    m = gts > 0
    bad2 = float(((np.abs(out - gts) > 2.0) | (out < 0))[m].mean())
    vfrac = float((out >= 0).mean())
    print(f"main path vs plain pipeline: max abs diff {path_err}; valid "
          f"fraction {vfrac:.4f}; bad-2.0 vs ground truth {bad2:.4f}",
          flush=True)
    # the bar the JAX package's drive recipe sets on synthetic pairs
    require(vfrac > 0.9 and bad2 < 0.05,
            "main path output is not a good disparity map")

    # --- 3. timing, at the main path's shapes (sweeps accumulate into a
    # scratch S, so S7 stays as checked)
    dirs7 = [r for r in DIRS_8 if r != (0, -1)]
    S_tmp = torch.zeros_like(S7)

    def sweeps():
        for dy, dx in dirs7:
            kernels.sgm_sweep(C, S_tmp, dy, dx, p1, p2)

    ms = {
        "census_cost_volume": cuda_ms(lambda: kernels.census_cost_volume(
            Lf, Rf, D, cfg.max_census_cost, cfg.census_window, d0), 20),
        "sgm_sweep": cuda_ms(sweeps, 3) / len(dirs7),
        "sweep_bwd_wta": cuda_ms(lambda: kernels.sweep_bwd_wta(C, S7, cfg),
                                 10),
        "dr_consistency": cuda_ms(lambda: kernels.dr_consistency(
            d_r, disp, D, cfg.disp12_max_diff, d0), 50),
        "connected_component_labels": cuda_ms(
            lambda: kernels.connected_component_labels(conn_h, conn_v), 20),
        "median3": cuda_ms(lambda: kernels.median3(med_in), 50),
    }
    per_dir = {f"{dy},{dx}": cuda_ms(
        lambda dy=dy, dx=dx: kernels.sgm_sweep(C, S_tmp, dy, dx, p1, p2), 3)
        for dy, dx in dirs7}
    print(f"sgm_sweep ms per direction: {per_dir}", flush=True)
    plain_ms = {
        "census_cost_volume": cuda_ms(lambda: census_cost_volume_plain(
            Lf, Rf, D, cfg.max_census_cost, cfg.census_window, d0), 2),
        "sgm_sweep": sum(cuda_ms(
            lambda dy=dy, dx=dx: sgm_sweep_plain(C, S_tmp, dy, dx, p1, p2),
            1, warmup=0) for dy, dx in dirs7) / len(dirs7),
        "sweep_bwd_wta": cuda_ms(lambda: sweep_bwd_wta_plain(C, S7, cfg), 1),
        "dr_consistency": cuda_ms(lambda: dr_consistency_plain(
            d_r, disp, D, cfg.disp12_max_diff, d0), 10),
        "connected_component_labels": cuda_ms(
            lambda: connected_component_labels(conn_h, conn_v), 2),
        "median3": cuda_ms(lambda: median3(med_in), 10),
    }
    del S_tmp

    def median_library():
        # replicate-pad, 3x3 patches, torch.median: the PyTorch route to
        # the same function (no single call computes it)
        p = torch.nn.functional.pad(med_in[:, None], (1, 1, 1, 1),
                                    mode="replicate")
        return torch.nn.functional.unfold(p, 3).median(1).values.reshape(
            med_in.shape)

    require(torch.equal(median_library(), med),
            "the library median route differs from median3")
    library_ms = {n: None for n in KERNELS}
    library_ms["median3"] = cuda_ms(median_library, 10)
    # component_big (sort + two binary searches) runs outside the kernels
    big_ms = cuda_ms(lambda: component_big(lab_off, cfg.speckle_window_size),
                     20)
    print(f"[{card}] component_big (sort + searchsorted, outside "
          f"the kernels): {big_ms:.4f} ms per set of {F} frames", flush=True)
    bounds = {
        # inputs read once, output written once; ops: xor, popcount,
        # compare, select per cost
        "census_cost_volume": bound(2 * n_pix + n_cost, 4 * n_cost),
        # C read, S read and written; ~9 integer ops per cost
        "sgm_sweep": bound(5 * n_cost, 9 * n_cost),
        # C and S7 read, disp + valid + d_r written; ~17 ops per cost
        "sweep_bwd_wta": bound(3 * n_cost + 9 * n_pix, 17 * n_cost),
        # d_r and disp read, ok written; ~8 ops per pixel
        "dr_consistency": bound(9 * n_pix, 8 * n_pix),
        # conn_h + conn_v read, labels written; ~16 integer ops per pixel
        # (init, two unions, flatten)
        "connected_component_labels": bound(
            conn_h.numel() + conn_v.numel() + 4 * n_pix, 16 * n_pix),
        # disp read, median written; 38 min/max per pixel
        "median3": bound(8 * n_pix, 38 * n_pix),
    }

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        api.match_batch(lefts, rights, cfg)
    torch.cuda.synchronize()
    api_fps = BATCH * reps / (time.perf_counter() - t0)
    dev_ms = cuda_ms(lambda: sgbm_batched(L, R, cfg), reps)
    off_ms = cuda_ms(lambda: sgbm_batched(L, R, cfg_off), reps)
    print(f"[{card}] whole path, full preset: {BATCH * 1e3 / dev_ms:.2f} "
          f"frames/s on device tensors ({dev_ms:.3f} ms per batch of "
          f"{BATCH}); {api_fps:.2f} frames/s through match_batch (numpy "
          f"in/out); peak memory {peak_gib:.2f} GiB", flush=True)
    print(f"[{card}] whole path, speckle and median off: "
          f"{BATCH * 1e3 / off_ms:.2f} frames/s on device tensors "
          f"({off_ms:.3f} ms per batch of {BATCH}); the two stages cost "
          f"{dev_ms - off_ms:.3f} ms per batch", flush=True)
    in_kernels = {n: launches[n] * ms[n] for n in KERNELS}
    print(f"[{card}] batch of {BATCH}, ms in each kernel (launches x "
          f"ms/launch): {in_kernels}; component_big "
          f"{BATCH // F * big_ms:.3f} ms; outside the six kernels "
          f"(component_big included): "
          f"{dev_ms - sum(in_kernels.values()):.3f} ms", flush=True)
    busy = device_busy(lambda: sgbm_batched(L, R, cfg))
    print(f"[{card}] profiler, one batch: {busy}", flush=True)

    rows = []
    for name, (src, replaces) in KERNELS.items():
        b_ms, b_by = bounds[name]
        print(f"[{card}] {name}: {ms[name]:.4f} ms/launch, "
              f"{launches[name]} launches per batch of {BATCH}, "
              f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms[name]:.3f} ms, "
              f"library {library_ms[name]}", flush=True)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": ms[name],
                     "plain_ms": plain_ms[name], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms[name]})
    rows += modes_path(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
