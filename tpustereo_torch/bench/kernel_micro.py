"""Time one kernel of the port in several builds of its source, on one CUDA
card: its compile-time sizes, and the source with one part cut out.

    python3 -m tpustereo_torch.bench.kernel_micro bwd_wta
    python3 -m tpustereo_torch.bench.kernel_micro census_cost

For the kernel named (`csrc/<name>.cu`) this script compiles the source once
per entry of `SIZES[name]` (`-D` macros that the source reads in place of
its shipped constants; the outputs must equal the shipped kernel's) and
once per entry of `ABLATIONS[name]` (the source with one statement
replaced, at the shipped sizes; its outputs are wrong and not checked)
into `build/kernel_micro/`. It runs each at the KITTI path's shapes (4
synthetic 375 x 1242 frames, D = 128, the `kitti_sgm8` preset), and
prints the card's name and power limit, then one JSON line: ms per launch
of each build (CUDA events, mean of 20 launches after a warm-up, in turns
shipped, builds..., shipped).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from tpustereo_torch import PRESETS, kernels
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.kernels import _build
from tpustereo_torch.kernels.cost import _SIGS as _COST_SIGS
from tpustereo_torch.kernels.sgm import _BWD_SIGS
from tpustereo_torch.ops.sgm import DIRS_8

OUT = os.path.join(_build.BUILD, "kernel_micro")
SIGS = {"bwd_wta": _BWD_SIGS, "census_cost": _COST_SIGS}
# name: {build name: -D flags}
SIZES = {
    # columns of C and S7 in flight per warp
    "bwd_wta": {f"ring{n}": [f"-DBWD_RING_DEPTH={n}"] for n in (2, 4, 8, 16)},
    # the tile: output columns x image rows
    "census_cost": {f"tile{tx}x{ty}": [f"-DCENSUS_TX={tx}",
                                       f"-DCENSUS_TY={ty}"]
                    for tx, ty in ((128, 2), (128, 4), (256, 1), (256, 4),
                                   (512, 1), (512, 2))},
}
# name: {build name: (statement of the source, what replaces it)}
ABLATIONS = {
    "bwd_wta": {
        # the selection of each chunk of 32 columns
        "no_select": ("if (lane <= hi - lo) {", "if (false) {"),
        # the column's S and lane mins stored into the chunk buffers
        "no_store_s": ("sbuf[c * Lay::SW + d0 / 2 + i] =",
                       "if (x < -1) sbuf[c * Lay::SW + d0 / 2 + i] ="),
        "no_store_lane_min": (
            "lmbuf[c * LMW + lane] = lane_min<K>(packed);", ""),
        # the d_R carry's shuffle
        "no_dr_shuffle": ("int nxt = __shfl_down_sync(FULL_MASK, A[0], 1);",
                          "int nxt = A[0];"),
        # the minLp reduce across the warp (each lane keeps its own min)
        "no_minlp_reduce": ("minLp = __reduce_min_sync(FULL_MASK, "
                            "lane_min<K>(L));", "minLp = lane_min<K>(L);"),
        # the wait for the ring's oldest group
        "no_ring_wait": ("cp_async_wait<RING - 1>();", ""),
    },
    "census_cost": {
        # the census words (the output phase reads whatever is there)
        "no_census": ("for (int i = threadIdx.x; i < TY * span;",
                      "for (int i = threadIdx.x; i < 0;"),
        # the popcount (the low byte of the XOR instead)
        "no_popc": ("uint32_t c = popc(wl ^ r[15 - j]);",
                    "uint32_t c = (uint32_t)(wl ^ r[15 - j]) & 0xff;"),
        # the streaming store as a plain store
        "plain_store": ("__stcs(reinterpret_cast<uint4*>(out), ",
                        "__stwb(reinterpret_cast<uint4*>(out), "),
        # the shared-memory reads of the right words (the left word alone)
        "no_right_reads": ("uint32_t c = popc(wl ^ r[15 - j]);",
                           "uint32_t c = popc(wl ^ (Word)j);"),
    },
}


def _compile(name: str) -> dict:
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    src = os.path.join(_build.CSRC, f"{name}.cu")
    with open(src) as f:
        text = f.read()
    builds = {b: (src, flags) for b, flags in SIZES[name].items()}
    for b, (old, new) in ABLATIONS[name].items():
        if old not in text:
            raise RuntimeError(f"ablation {b}: statement not found")
        path = os.path.join(OUT, f"{name}_{b}.cu")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        builds[b] = (path, ["-I", _build.CSRC])
    procs = {}
    for b, (path, flags) in builds.items():
        lib = os.path.join(OUT, f"lib{name}_{b}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-o", lib, path]
        procs[b] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for b, (path, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {b}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {b}: {line.strip()}")
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in SIGS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[b] = lib
    return libs


def main(name: str) -> None:
    if name not in SIGS:
        raise SystemExit(f"kernel_micro: name one of {sorted(SIGS)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_micro: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    cfg = PRESETS["kitti_sgm8"]
    dev = torch.device("cuda")
    pairs = [synthetic_pair((375, 1242), disparity=40.0, seed=s)
             for s in range(4)]
    L = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    R = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    D, d0 = cfg.num_disparities, cfg.min_disparity
    (ch, cw), bits = cfg.census_window, cfg.max_census_cost
    C = kernels.census_cost_volume(L, R, D, bits, (ch, cw), d0)
    B, H, W, _ = C.shape
    stream = _build.stream_ptr(C)
    if name == "bwd_wta":
        S7 = torch.zeros(C.shape, dtype=torch.int16, device=dev)
        for dy, dx in DIRS_8:
            if (dy, dx) != (0, -1):
                kernels.sgm_sweep(C, S7, dy, dx, cfg.p1, cfg.p2)
        ref = kernels.sweep_bwd_wta(C, S7, cfg)
        outs = tuple(torch.empty_like(t) for t in ref)

        def launch(lib):
            return lib.bwd_wta_launch(
                _build.ptr(C), _build.ptr(S7), *map(_build.ptr, outs),
                B * H, W, D, cfg.p1, cfg.p2, cfg.uniqueness_ratio,
                int(cfg.subpixel), d0, stream)
    else:
        ref = (C,)
        outs = (torch.empty_like(C),)

        def launch(lib):
            return lib.census_cost_launch(
                _build.ptr(L), _build.ptr(R), _build.ptr(outs[0]), B, H, W,
                D, ch, cw, d0, bits, stream)

    def run(lib):
        rc = launch(lib)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    libs = _compile(name)
    for b, lib in libs.items():
        run(lib)
        torch.cuda.synchronize()
        if b in SIZES[name] and not all(
                torch.equal(o, r) for o, r in zip(outs, ref)):
            raise SystemExit(f"kernel_micro: {name} build {b} differs from "
                             f"the shipped kernel")
    shipped = _build.load(name, SIGS[name])
    res = {"shipped_first": ms(lambda: run(shipped))}
    for b, lib in libs.items():
        res[b] = ms(lambda lib=lib: run(lib))
    res["shipped_last"] = ms(lambda: run(shipped))
    print(json.dumps({"card": card, "kernel": name, "shape": [B, H, W, D],
                      "ms_per_launch": res}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
