"""Time one kernel of the port in several builds of its source, on one CUDA
card: its compile-time sizes, and the source with one part cut out.

    python3 -m tpustereo_torch.bench.kernel_micro bwd_wta
    python3 -m tpustereo_torch.bench.kernel_micro census_cost
    python3 -m tpustereo_torch.bench.kernel_micro sad_wta
    python3 -m tpustereo_torch.bench.kernel_micro wta_lr
    python3 -m tpustereo_torch.bench.kernel_micro bitonic
    python3 -m tpustereo_torch.bench.kernel_micro cc_labels
    python3 -m tpustereo_torch.bench.kernel_micro sgm_bidir
    python3 -m tpustereo_torch.bench.kernel_micro median3
    python3 -m tpustereo_torch.bench.kernel_micro sgm_sweep
    python3 -m tpustereo_torch.bench.kernel_micro sgm_fused
    python3 -m tpustereo_torch.bench.kernel_micro lr_check
    python3 -m tpustereo_torch.bench.kernel_micro width_micro
    python3 -m tpustereo_torch.bench.kernel_micro NAME --against DIR
    python3 -m tpustereo_torch.bench.kernel_micro NAME --only B1,B2
    python3 -m tpustereo_torch.bench.kernel_micro NAME --cases S1,S2

For the kernel named (`csrc/<name>.cu`) this script compiles the source once
per entry of `SIZES[name]` (`-D` macros that the source reads in place of
its shipped constants; the outputs must equal the shipped kernel's) and
once per entry of `ABLATIONS[name]` (the source with one statement
replaced, at the shipped sizes; its outputs are not checked, and most
are wrong)
into `build/kernel_micro/`. It runs each at its path's shapes (`_cases`):
`bwd_wta` and `census_cost` at the KITTI path's (4 synthetic 375 x 1242
frames, D = 128, the `kitti_sgm8` preset); `sad_wta` on one 288 x 384
Tsukuba frame (`tsukuba_sad`, LR check off as in the preset, and on);
`wta_lr` on one 375 x 621 uint8 census volume (`middlebury_census_wta`)
and on 4 frames of 1988 x 2964 of the int16 aggregated volume
(`middlebury_sgm4`, LR check on); `bitonic` on the pair sort (labels,
pixel index) and the keys-only sort (index * 2 + bit) of the speckle
labels of 4 KITTI frames, 4 rows of 465,750 padded to 2^19, as
`component_big_sorted` makes them (each launch first copies the unsorted
rows into the buffers it sorts in place: `copy_ms` is that copy alone);
`cc_labels` on the speckle graph of those 4 frames (the LR-checked WTA
disparity of the `kitti_sgm8` path); `sgm_bidir` on the census volume of
those 4 frames, its three launches of column shifts (0, 1, -1) as the
`BIDIR_VERT` route runs them (s16x2 build); `median3` on the median's
input of the path, the speckle-filtered disparity of those 4 frames;
`sgm_sweep` on the census volume of those 4 frames, each of the seven
directions of `sgm_select` in the write form (S = L_r) and the add form
(S += L_r, on a partial sum of path costs), each with the scalar P2 and
with adaptive P2 (the left image of those frames, `kitti_sgm8` with
`adaptive_p2=True`), and the S direction's add form on 4 frames of
1988 x 2964 (`middlebury_sgm4`); `sgm_fused` on the census volume of the
4 KITTI frames, the fused down set written and the up set added (column
shifts (0, 1, -1), as `sgm_select` runs them), each with the scalar and
the adaptive P2; `bwd_wta` with the
scalar and the adaptive P2 the same way; `lr_check` (its hits
kernel) on the d_r and disparity of those 4 KITTI frames, and on 4 rows of
240,000 columns (D = 128; the shipped builds only: a checkout from before
the tiled design refuses such rows); `width_micro` (its sweep kernel,
the instrument of `sweep_micro`) in every mode at `chip_smoke.py` step
17's shapes, (376, 1280) and (1242, 1500), and on one warp's line at T =
376 (N = 1, two rows for the paired modes and swar's packing: the step
chain's own floor), in the sweep builds (`SWEEP_BUILDS`: ring depths 4,
8, 16 and 32 in every mode, 2 and 4 warps a block) and the checkouts,
`sweep_sm_blocks` the blocks an SM of each case at those shapes (the
`smid` build); its roll kernel (the
instrument of `roll_chain_micro` and `bf16_roll_chain_micro`) at
`chip_smoke.py` step 17's shapes and chains: (1248, 128) and (16896, 128)
int32 on both axes and bfloat16, chains 64 and 512; chain 0 (the loads
and stores alone, strided on axis 0); one line ((1, 128) axis 1,
(1248, 1) axis 0, (2, 128) bfloat16), the chain's own floor; and other
plans of the same lines (threads and values a thread, `_roll_plan`'s
candidates; the shipped build only); and its chain kernel (the
instrument of `elem_chain_micro` and `reg_chain_micro`) at the same two
shapes, both kinds and every dtype, chains 0, 64 and 512 on
`_chain_plan`'s grid, and at chains 64 and 512 on the other plans (1,
2 or 4 words a thread in blocks of 128, 4 in blocks of 256; the shipped
build only), and one warp's values at one word a thread, chains 64 and
512 (the shipped build only). From these the record's `chain_clocks`
gives `kernels.width_micro.CHAIN_CLOCKS` as this card measures it (the
clocks a warp-step takes its scheduler at (16896, 128) by words a
thread, and one warp's dependent step). A checkout from before the
blocked slots (the strided layout,
`slots` and `pad` in place of `slots` and `threads`) takes lines of at
most 2,048 values and its own plan (`_strided_roll_plan`); one from
before the chain plan its own chain grid (`AGAINST_SIGS`). Its builds
print each sweep, roll and chain kernel's registers and spills
(`ptxas`), and
the record holds each chain kernel's loop in the SASS by opcode
(`chain_sass`) and its warp-instructions a step in every build
(`chain_issue`, both from `bench/chain_sass.py`); `unroll4` and
`unroll16` are the chain's candidates and `smid` its diagnostic, whose
blocks count themselves on their SMs (`chain_sm_blocks` in the record:
blocks an SM in each chain case at chain 512); the roll cases skip the
sweep and chain builds, and the sweep and chain cases take their own
builds alone (`--cases sweep`: the sweeps alone).
Each `--against DIR` (the option may be repeated) makes the same source
of another checkout (`DIR/tpustereo_torch/csrc/<name>.cu`, the same C
interface, or the one `AGAINST_SIGS` names) one more build, named after
DIR (a parent commit unpacked into `parent/`, say), held to the shipped
outputs in the cases it takes (a checkout's `sgm_sweep` and `bwd_wta`
from before adaptive P2 take the scalar cases alone). `--only` keeps the
builds named (sizes, ablations, checkouts), and may name none (`--only
""`); `--cases` keeps the cases whose label holds one of the strings
named (`--cases elem,reg`: the chains of `width_micro`). It prints the
card's name and power limit, then one JSON line: ms per launch of each
build in each case, by CUDA events (mean of 20 launches after a warm-up)
and by CUDA-graph replay (20 launches captured in one graph: the
device's time without the host's per launch), in turns shipped,
builds..., shipped, and each build's device ms a call in each of its
kernels (`profile_ms`, by `torch.profiler`).

`sgm_fused` also runs, at 1 x 375 x 1242 with D = 256 and 512, the down
set written and the up set added (every build); and prints `anatomy`:
the shipped library's SASS of each s16x2 build by opcode class
(`cuobjdump -sass`, split at its block barriers: the segment with the
warp minimums is the row's body), each build's registers and spills
(`-Xptxas -v`), its blocks an SM (`cudaOccupancyMaxActiveBlocksPerMulti
processor`) and the card's SM clocks; with the `phases` build (the
source's `FUSED_PHASES` stamps), each case's cycles a warp a row by phase;
and `routes`, in turns by events and graph replay: the fused down and up
sets against the six one-direction launches on one 375 x 1242 frame at D
= 128, 256 and 512, and the fused carry form on one 192-row strip of a
376 x 1241 frame (`kitti_odometry`'s exact ring at 2 strips) beside the
same launch without a carry; and `pipeline`, in turns by events, the
shipped build against each `--against` build under the wrapper: a set at
KITTI F=4 (the two fused passes and E) and a `kitti_sgm8` batch of 8
frames, outputs held equal.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from tpustereo_torch import PRESETS, kernels
from tpustereo_torch.bench.chain_sass import (CHAIN_FN, DT_NAMES, ISSUE_HZ,
                                             chain_issue, chain_key,
                                             chain_sass, chain_unroll)
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.kernels import _build
from tpustereo_torch.kernels.bitonic import _SIGS as _BITONIC_SIGS
from tpustereo_torch.kernels.bitonic import IMAX, padded_log2
from tpustereo_torch.kernels.cc import _SIGS as _CC_SIGS
from tpustereo_torch.kernels.cost import _SIGS as _COST_SIGS
from tpustereo_torch.kernels.median import _SIGS as _MEDIAN_SIGS
from tpustereo_torch.kernels.sad import _SIGS as _SAD_SIGS
from tpustereo_torch.kernels.lr import _SIGS as _LR_SIGS
from tpustereo_torch.kernels.sgm import (_BIDIR_SIGS, _BWD_SIGS,
                                         _FUSED_SIGS, _SWEEP_SIGS,
                                         VERTICAL_DXS)
from tpustereo_torch.kernels.wta import _SIGS as _WTA_SIGS
from tpustereo_torch.kernels import width_micro as wm
from tpustereo_torch.ops import component_big
from tpustereo_torch.ops.postproc import speckle_conn
from tpustereo_torch.ops.sgm import DIRS_8
from tpustereo_torch.pipeline import sgbm_volume

OUT = os.path.join(_build.BUILD, "kernel_micro")
SIGS = {"bwd_wta": _BWD_SIGS, "census_cost": _COST_SIGS,
        "sad_wta": _SAD_SIGS, "wta_lr": _WTA_SIGS,
        "bitonic": {"bitonic_launch": _BITONIC_SIGS["bitonic_launch"]},
        "cc_labels": _CC_SIGS, "sgm_bidir": _BIDIR_SIGS,
        "median3": _MEDIAN_SIGS, "sgm_sweep": _SWEEP_SIGS,
        "sgm_fused": _FUSED_SIGS,
        "lr_check": {"lr_hits_launch": _LR_SIGS["lr_hits_launch"]},
        "width_micro": {f: wm._SIGS[f] for f in ("sweep_micro_launch",
                                                 "roll_micro_launch",
                                                 "chain_micro_launch")}}
# earlier C interfaces that `--against` builds keep: sgm_bidir_launch
# before its `packed` argument (one int32 build), sgm_sweep_launch and
# bwd_wta_launch before their image argument (scalar P2 alone),
# sgm_fused_launch before its carry arguments, roll_micro_launch before the
# blocked slots (the same types: `slots, pad` in place of `slots, threads`),
# chain_micro_launch before its plan (x, out, n, dtype, kind, chain, stream:
# 4 words a thread in blocks of 256)
AGAINST_SIGS = {
    "width_micro": {"roll_micro_launch": wm._SIGS["roll_micro_launch"],
                    "chain_micro_launch": (
                        [ctypes.c_void_p] * 2 + [ctypes.c_long]
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                        ctypes.c_int)},
    "sgm_fused": {"sgm_fused_launch": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
        ctypes.c_int),
        "sgm_fused_scratch": _FUSED_SIGS["sgm_fused_scratch"]},
    "sgm_bidir": {"sgm_bidir_launch": (
        _BIDIR_SIGS["sgm_bidir_launch"][0][:11] + [ctypes.c_void_p],
        ctypes.c_int)},
    "sgm_sweep": {"sgm_sweep_launch": (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
        ctypes.c_int)},
    "bwd_wta": {"bwd_wta_launch": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int)},
}
# name: {build name: -D flags}
SIZES = {
    # columns of C and S7 in flight per warp
    "bwd_wta": {f"ring{n}": [f"-DBWD_RING_DEPTH={n}"] for n in (2, 4, 8, 16)},
    # the tile: output columns x image rows
    "census_cost": {f"tile{tx}x{ty}": [f"-DCENSUS_TX={tx}",
                                       f"-DCENSUS_TY={ty}"]
                    for tx, ty in ((128, 2), (128, 4), (256, 1), (256, 4),
                                   (512, 1), (512, 2))},
    # the tile: columns x rows (one thread a pixel), and planes a chunk
    "sad_wta": {f"tile{tx}x{ty}_dc{dc}": [f"-DSAD_TX={tx}", f"-DSAD_TY={ty}",
                                          f"-DSAD_DC={dc}"]
                for tx, ty, dc in ((32, 16, 32), (64, 16, 16), (64, 8, 32),
                                   (32, 32, 32))},
    # pixels a tile, at most
    "wta_lr": {f"tile{n}": [f"-DWTA_TX={n}"] for n in (32, 64, 256)},
    # log2 of the shared-memory tile, log2 of the elements a tile thread
    # holds, substages a global launch runs (m1: one, the earlier schedule)
    "bitonic": {f"t{t}_r{r}_m{m}": [f"-DBITONIC_TILE_LOG2={t}",
                                    f"-DBITONIC_REG_LOG2={r}",
                                    f"-DBITONIC_GLOBAL_M={m}"]
                for t, r, m in ((12, 4, 5), (13, 4, 5), (13, 3, 5),
                                (14, 5, 5), (14, 4, 4), (14, 4, 3),
                                (14, 4, 2), (14, 4, 1))},
    # the tile: rows x columns
    "cc_labels": {f"tile{r}x{c}": [f"-DCC_TILE_ROWS={r}",
                                   f"-DCC_TILE_COLS={c}"]
                  for r, c in ((8, 128), (32, 128), (16, 64), (16, 256),
                               (32, 256), (4, 512))},
    # pixels in flight per warp; warps a block; line pairs a warp; the
    # int32 build at D = 128; one 2-byte store per int16
    "sgm_bidir": {
        **{f"ring{n}": [f"-DBIDIR_RING_DEPTH={n}"] for n in (1, 4, 8, 16)},
        **{f"warps{n}": [f"-DBIDIR_WARPS={n}"] for n in (2, 8)},
        "lines2": ["-DBIDIR_LINES=2"],
        "int32": ["-DBIDIR_S16X2=0"],
        "scalar_stores": ["-DBIDIR_SCALAR_STORES=1"],
    },
    # pixels in flight per warp; one 2-byte store per int16; the E and W
    # sweeps' carry as s16x2 pairs of adjacent disparities (DPX)
    "sgm_sweep": {
        **{f"ring{n}": [f"-DSWEEP_RING_DEPTH={n}"] for n in (1, 2, 4, 8, 16)},
        "scalar_stores": ["-DSWEEP_SCALAR_STORES=1"],
        "s16x2": ["-DSWEEP_S16X2=1"],
    },
    # rows in flight a warp; own columns a tile (with 8 halo columns a
    # side): wider tiles spend less on halos, and fewer fit on the card;
    # the s16x2 build compiled for 3 blocks an SM (80 registers); an s16x2
    # build at D = 512 too (the shipped one takes int32 there); the
    # shipped sizes with the phase stamps (`FUSED_PHASES`)
    "sgm_fused": {
        **{f"ring{n}": [f"-DFUSED_RING={n}"] for n in (4, 8)},
        **{f"tw{n}": [f"-DFUSED_TW={n}"] for n in (8, 16, 32)},
        "minb3": ["-DFUSED_MINB=3"],
        "s16x2_d512": ["-DFUSED_PACKED_MAXK=16"],
        "phases": ["-DFUSED_PHASES"],
    },
    # the roll kernel: its registers moved back every pair of steps (no
    # renames); lines of one warp a block at most 1 and 8 (shipped 4)
    "width_micro": {
        "moves": ["-DROLL_MOVES=1"],
        **{f"lpb{n}": [f"-DROLL_LPB={n}"] for n in (1, 8)},
        # the sweep kernel: steps in flight a warp, every mode alike
        # (shipped 16 for the i8 modes, 8 for v32 and swar); warps a block
        # (shipped 1)
        **{f"ring{n}": [f"-DMICRO_RING={n}", f"-DMICRO_RING_WIDE={n}"]
           for n in (4, 8, 16, 32)},
        **{f"warps{n}": [f"-DMICRO_WARPS={n}"] for n in (2, 4)},
        # the chain kernel: ELEM passes of 4 and 16 steps (shipped 8, REG
        # twice as many); each block counting itself on its SM
        **{f"unroll{n}": [f"-DCHAIN_UNROLL={n}"] for n in (4, 16)},
        "smid": ["-DCHAIN_SMID=1"],
    },
    # the hits kernel's tile: groups of 4 pixels a thread, threads a block
    "lr_check": {
        **{f"groups{n}": [f"-DLR_GROUPS={n}"] for n in (1, 4)},
        **{f"threads{n}": [f"-DLR_THREADS={n}"] for n in (128, 512)},
    },
    # pixels a lane (the tile's width, 32 of them); the tile's rows; the
    # taps through a tile staged in shared memory; Paeth's network on
    # every window
    "median3": {
        **{f"px{n}": [f"-DMEDIAN_PX={n}"] for n in (4, 8)},
        **{f"rows{n}": [f"-DMEDIAN_TY={n}"] for n in (4, 16)},
        "smem": ["-DMEDIAN_SMEM=1"],
        "smem_px8": ["-DMEDIAN_SMEM=1", "-DMEDIAN_PX=8"],
        "paeth": ["-DMEDIAN_PAETH=1"],
        "paeth_smem": ["-DMEDIAN_PAETH=1", "-DMEDIAN_SMEM=1"],
    },
}
# name: {build name: (statement of the source, what replaces it), or a
# list of such pairs that cut one part together}
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
        # adaptive P2 from the image bytes of the column and its
        # predecessor loaded in each step, on the carry's chain (the same
        # outputs), not a chunk ahead
        "p2_each_step": ("p2t = __shfl_sync(FULL_MASK, p2v, x - lo);",
                         "p2t = max(p1 + 1, p2 / max(1, abs(image(x) - "
                         "image(x + 1))));"),
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
    "sad_wta": {
        # the image rows staged in shared memory
        "no_staging": [("for (int i = tid; i < nrows * cw; i += THREADS)",
                        "for (int i = tid; i < 0; i += THREADS)"),
                       ("for (int i = tid; i < nrows * rw; i += THREADS)",
                        "for (int i = tid; i < 0; i += THREADS)")],
        # the vertical sums (the horizontal phase reads whatever is there)
        "no_vertical": ("for (int it = tid; it < cw * DC; it += THREADS)",
                        "for (int it = tid; it < 0; it += THREADS)"),
        # the horizontal running sums
        "no_horizontal": ("for (int it = tid; it < TY * DC; it += THREADS)",
                          "for (int it = tid; it < 0; it += THREADS)"),
        # the pixels' fold over the planes (WTA, uniqueness, neighbours)
        "no_fold": ("for (int jj = 0; jj < nj; ++jj) {\n      const int j",
                    "for (int jj = 0; jj < 0; ++jj) {\n      const int j"),
        # the right-view diagonals of each chunk (LR check on only)
        "no_right_map": ("for (int it = tid; it < TY * nd; it += THREADS)",
                         "for (int it = tid; it < 0; it += THREADS)"),
    },
    "wta_lr": {
        # the copies of the tile into shared memory
        "no_copy": ("cp_async<4>(buf + p * SW + k, g + (size_t)p * WP + k);",
                    ";"),
        # the second pass for the min over |d - d*| > 1
        "no_uniqueness": ("if (uniq > 0) {\n      // groups ga",
                          "if (false) {\n      // groups ga"),
        # the right map's diagonals and their atomicMin (LR check on only)
        "no_right_map": ("for (int t = tid; t < npix + D - 1;",
                         "for (int t = tid; t < 0;"),
        # the right map's atomicMin into the row maps (its diagonals stay)
        "no_map_atomics": ("atomicMin(&map[row * W + xr], min(m0, m1));",
                           "if (min(m0, m1) == -7) map[row * W + xr] = 0;"),
        # the LR check and d_R from the row maps (LR check on only)
        "no_finish": ("if (need_map) {\n    const size_t g",
                      "if (false) {\n    const size_t g"),
    },
    "bitonic": {
        # the global launches (they start and leave at once)
        "no_global": ("if (gid >= groups) return;", "if (gid >= 0) return;"),
        # the groups of substages in shared memory (the first stages and
        # each stage's last group stay)
        "no_smem_groups": ("smem_chunk_at<0, P>(jhi - jlo + 1, jlo, sk, sp, "
                           "t, k, g0);", ";"),
        # the swizzle (still exact: it only places elements)
        "no_swizzle": ("return i ^ (((i >> 5) & 15) | ((i >> 4) & 16));",
                       "return i;"),
    },
    "cc_labels": {
        # the vertical unions inside each tile
        "no_local_unions": ("cc_union(L, i, i + TILE_COLS);", ";"),
        # the border unions (the kernel starts and leaves at once)
        "no_border": ("if (i >= n) return;\n  const long hw",
                      "if (i >= 0) return;\n  const long hw"),
        # the flatten (it starts and leaves at once)
        "no_flatten": ("if (i >= n) return;\n  const long base",
                       "if (i >= 0) return;\n  const long base"),
        # the local pass's stores of the labels
        "no_local_store": ("    out[(long)(y0 + i / TILE_COLS)",
                           "    if (r < 0) out[(long)(y0 + i / TILE_COLS)"),
        # the local pass's loads of the edges (every edge set instead)
        "no_edge_loads": [("if (lx > 0) h = ch[y * (W - 1) + x0 + lx - 1];",
                           "if (lx > 0) h = 1;"),
                          ("if (ly < ht - 1) v = cv[y * W + x0 + lx];",
                           "if (ly < ht - 1) v = 1;")],
        # the run starts' compression before the local labels (each pixel
        # walks its own chain instead; still exact)
        "no_compress": ("const int r = L[L[i]];",
                        "const int r = cc_find(L, i);"),
    },
    "sgm_bidir": {
        # the min over D of the packed step (the carry is not renormalised)
        "no_warp_min": ("const unsigned M = warp_min_s16x2<K>(L);",
                        "const unsigned M = 0;"),
        # the wait for the ring's oldest group
        "no_ring_wait": ("cp_async_wait<RING - 1>();  // pixel t's", "//"),
        # the stores of both lines' results
        "no_stores": ("      store_line<K, ACC, VEC>(Sd +",
                      "      if (t < 0) store_line<K, ACC, VEC>(Sd +"),
    },
    "sgm_sweep": {
        # the min over D (each lane keeps its own min)
        "no_warp_min": ("minLp = __reduce_min_sync(FULL_MASK, "
                        "lane_min<K>(L));", "minLp = lane_min<K>(L);"),
        # the wait for the ring's oldest group
        "no_ring_wait": ("cp_async_wait<RING - 1>();  // pixel t's", "//"),
        # the stores of the line's results
        "no_stores": ("    store_line<K, ACC, VEC>(S + (p0",
                      "    if (t < 0) store_line<K, ACC, VEC>(S + (p0"),
        # adaptive P2 from the image bytes of the pixel and its predecessor
        # loaded in each step, on the carry's chain (the same outputs), not
        # a group of 32 pixels ahead
        "p2_each_step": ("p2t = __shfl_sync(FULL_MASK, p2v, t & 31);",
                         "p2t = max(p1 + 1, p2 / max(1, abs(image(t) - "
                         "image(max(t - 1, 0)))));"),
        # a group's loads and P2' (every P2' stays the scalar P2)
        "p2_no_group": ("if ((t & 31) == 0) {  // a group starts",
                        "if (false) {  // a group starts"),
    },
    "sgm_fused": {
        # the waits for the neighbour tiles' edges (a tile may read them
        # before they are written)
        "no_waits": ("if (threadIdx.x == 0) {\n              if (tile > 0)",
                     "if (false) {\n              if (tile > 0)"),
        # the barrier that ends each row in the s16x2 build (warps read
        # their neighbours' row buffers, and the block's ring, whenever they
        # get to them)
        "no_row_barrier": ("__syncthreads();  // row t's q and row t + 1's",
                           "//"),
        # the s16x2 build's wait for the next ring row's copies
        "no_ring_wait": ("            cp_async_wait<0>();\n            "
                         "PHASE(1);", "            PHASE(1);"),
        # the fence before a band's flag (its edges may land after it)
        "no_fence": ("              __threadfence();\n", "\n"),
        # no band exchange at all: no edge stores, flags, waits or edge
        # loads (the halos keep what they computed)
        "no_exchange": [
            ("if (a.exchange && t % FR == 0 && t > 0) {", "if (false) {"),
            ("if (a.exchange && (t + 1) % FR == 0 && t + 1 < H) {",
             "if (false) {")],
        # the s16x2 build's stores of S
        "no_s_store": ("if (j > 0 && j < SPW - 1 && inside)",
                       "if (j < 0 && inside)"),
        # the s16x2 build's warp minimums (each lane keeps its own)
        "no_warp_min": ("m[j][k] = __reduce_min_sync(FULL_MASK, m[j][k]);",
                        "m[j][k] = m[j][k];"),
    },
    "lr_check": {
        # the hits scatter (the flags stay clear)
        "no_scatter": ("for (int j = lo; j <= hi; ++j) flag[c + j] = 1;",
                       ";"),
        # the staging of d_r (the lookups read whatever is there)
        "no_staging": ("cp_async<16>(win + (c - a), d_r + i0 + c);", ";"),
    },
    "width_micro": {
        # the block lines' barrier (their edges are read whenever they
        # land: wrong outputs, the barrier's cost)
        "no_barrier": ("__syncthreads();  // one a step", "//"),
    },
    "median3": {
        # the exchanges (each pixel takes its window's centre)
        "no_network": ("res[p] = paeth_sorted(t);", "res[p] = t[4];"),
        # the loads of the taps (each takes its column's index)
        "no_loads": ("      v[r][i] = src[min(max(xs - 1 + i, 0), W - 1)];",
                     "      v[r][i] = (float)(xs - 1 + i);"),
        # the blocks start and leave at once: the launch alone
        "launch_only": ("  const int X0 = blockIdx.x * TX, y0",
                        "  if (H > 0) return;\n  const int X0 = blockIdx.x "
                        "* TX, y0"),
        # no loads and no network: the stores alone
        "stores_only": [
            ("      v[r][i] = src[min(max(xs - 1 + i, 0), W - 1)];",
             "      v[r][i] = (float)(xs - 1 + i);"),
            ("res[p] = paeth_sorted(t);", "res[p] = t[4];")],
    },
}


# the width_micro builds of the chain kernel and of the sweep kernel, which
# the roll cases skip and the chain or sweep cases alone take (with the
# checkouts)
CHAIN_BUILDS = {"unroll4", "unroll16", "smid"}
SWEEP_BUILDS = {b for b in SIZES["width_micro"]
                if b.startswith(("ring", "warps"))}


def _same_interface(name: str, src: str) -> bool:
    """Whether another checkout's source takes the current C interface
    (`sgm_fused` with its carry arguments, `width_micro` with the chain
    plan); the others take `AGAINST_SIGS`."""
    mark = {"sgm_fused": "const int* cin",
            "width_micro": "int words, int threads"}.get(name)
    if mark is None:
        return False
    with open(src) as f:
        return mark in f.read()


def _ptxas_width(log: str) -> dict:
    """Registers and spill bytes (stores, loads) of each sweep, roll and
    chain kernel in an `nvcc -Xptxas -v` log, keyed `sweep <mode>` for the
    sweeps, E<values a thread>/<exact or not>/<warp or block> for the
    rolls, `chain <kind> <dtype> W<words>` for the chains."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            fn = m.group(1)
            continue
        k = re.search(r"roll_kernelILi(\d+)ELb([01])E(?:Lb([01])E)?",
                      fn or "")
        c = CHAIN_FN.search(fn or "")
        sw = re.search(r"sweep_micro_kernelILi(\d)E", fn or "")
        if sw is not None:
            key = f"sweep {wm.MODES[int(sw.group(1))]}"
        elif c is not None:
            key = chain_key(c)
        elif k is None:
            continue
        elif k.group(3) is None:  # the strided layout's <E, PAIR16>
            key = f"E{k.group(1)}/{'bf16' if k.group(2) == '1' else 'int32'}"
        else:
            key = (f"E{k.group(1)}/"
                   f"{'exact' if k.group(2) == '1' else 'short'}/"
                   f"{'block' if k.group(3) == '1' else 'warp'}")
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        if sp:
            out.setdefault(key, {})["spill"] = [int(sp.group(1)),
                                                int(sp.group(2))]
        r = re.search(r"Used (\d+) registers", line)
        if r:
            out.setdefault(key, {})["registers"] = int(r.group(1))
    return out


def _sm_balance(lib, cases, pick) -> dict:
    """Blocks each SM took in one launch of each case whose label `pick`
    takes (the `smid` build's counts): SMs used, the most and the fewest
    blocks an SM, and how many SMs took each count."""
    take = lib.chain_sm_blocks_take
    take.argtypes, take.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    buf = (ctypes.c_uint * 1024)()
    out = {}
    for label, _, _, _, launch, *_ in cases:
        if not pick(label):
            continue
        torch.cuda.synchronize()
        take(buf, 1024)
        if launch(lib) != 0:
            raise RuntimeError(f"width_micro smid launch failed ({label})")
        torch.cuda.synchronize()
        if take(buf, 1024) != 0:
            raise RuntimeError("chain_sm_blocks_take failed")
        counts = [c for c in buf if c]
        out[label] = {"sms": len(counts), "max": max(counts),
                      "min": min(counts),
                      "hist": dict(collections.Counter(counts))}
    return out


def _compile(name: str, against: tuple = (), only=None) -> dict:
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    src = os.path.join(_build.CSRC, f"{name}.cu")
    with open(src) as f:
        text = f.read()
    builds = {b: (src, flags) for b, flags in SIZES[name].items()}
    others = set()
    for other in against:
        csrc = os.path.join(other, "tpustereo_torch", "csrc")
        b = os.path.basename(os.path.normpath(other))
        builds[b] = (os.path.join(csrc, f"{name}.cu"), ["-I", csrc])
        others.add(b)
    for b, cut in ABLATIONS[name].items():
        if only is not None and b not in only:
            continue
        cut_text = text
        for old, new in [cut] if isinstance(cut[0], str) else cut:
            if cut_text.count(old) != 1:
                raise RuntimeError(f"ablation {b}: statement not found once")
            cut_text = cut_text.replace(old, new)
        path = os.path.join(OUT, f"{name}_{b}.cu")
        with open(path, "w") as f:
            f.write(cut_text)
        builds[b] = (path, ["-I", _build.CSRC])
    if only is not None:
        builds = {b: v for b, v in builds.items() if b in only}
    procs = {}
    for b, (path, flags) in builds.items():
        lib = os.path.join(OUT, f"lib{name}_{b}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-o", lib, path]
        procs[b] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for b, (path, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {b}:\n{log}")
        if name == "width_micro":
            ptxas[b] = _ptxas_width(log)
        else:
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {b}: {line.strip()}")
        lib = ctypes.CDLL(path)
        lib.tps_path = path
        sigs = SIGS[name]
        lib.tps_checkout = b in others
        if b in others and not _same_interface(name, builds[b][0]):
            sigs = AGAINST_SIGS.get(name, sigs)
            lib.tps_against = True
        if name == "width_micro" and b in others:
            with open(builds[b][0]) as f:
                lib.tps_strided = "int slots, int threads" not in f.read()
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[b] = lib
    if ptxas:
        print(f"ptxas: {json.dumps(ptxas)}", flush=True)
    return libs


def _frames(shape, n: int, disparity: float, dev):
    pairs = [synthetic_pair(shape, disparity=disparity, seed=s)
             for s in range(n)]
    return (torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev),
            torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev))


def _kitti_speckle(dev):
    """The speckle graph (conn_h, conn_v), labels and median input of 4
    synthetic KITTI frames: the LR-checked WTA disparity of the
    `kitti_sgm8` path, and that disparity with the speckles set to -1."""
    cfg = PRESETS["kitti_sgm8"]
    L, R = _frames((375, 1242), cfg.frames_per_step, 40.0, dev)
    D, d0 = cfg.num_disparities, cfg.min_disparity
    C = kernels.census_cost_volume(L, R, D, cfg.max_census_cost,
                                   cfg.census_window, d0)
    S7 = torch.zeros(C.shape, dtype=torch.int16, device=dev)
    for dy, dx in DIRS_8:
        if (dy, dx) != (0, -1):
            kernels.sgm_sweep(C, S7, dy, dx, cfg.p1, cfg.p2)
    disp, valid, d_r = kernels.sweep_bwd_wta(C, S7, cfg)
    ok = kernels.dr_consistency(d_r, disp, D, cfg.disp12_max_diff, d0)
    conn_h, conn_v = speckle_conn(disp, valid & ok, cfg)
    lab = kernels.connected_component_labels(conn_h, conn_v)
    F, H, W = lab.shape
    lab_off = lab + torch.arange(0, F * H * W, H * W, dtype=torch.int32,
                                 device=dev).reshape(F, 1, 1)
    big = component_big(lab_off, cfg.speckle_window_size)
    return conn_h, conn_v, lab, torch.where(valid & ok & big, disp, -1.0)


def _sweep_cases(dev) -> list:
    """The `sgm_sweep` cases: each direction of `sgm_select`'s seven in
    both forms at KITTI F = 4, with the scalar P2 and with adaptive P2
    (the frames' left images), and the S direction's add form at
    Middlebury F = 4. The add form accumulates into its buffer launch after
    launch (the sums wrap; the time does not depend on them), so the check
    resets the buffer first (`reset`). `--against` builds take the scalar
    cases."""
    cases = []
    for preset, shape, disparity, dirs in (
            ("kitti_sgm8", (375, 1242), 40.0,
             [r for r in DIRS_8 if r != (0, -1)]),
            ("middlebury_sgm4", (1988, 2964), 60.0, [(1, 0)])):
        cfg = PRESETS[preset]
        L, R = _frames(shape, cfg.frames_per_step, disparity, dev)
        D, p1, p2 = cfg.num_disparities, cfg.p1, cfg.p2
        C = kernels.census_cost_volume(L, R, D, cfg.max_census_cost,
                                       cfg.census_window, cfg.min_disparity)
        del R
        B, H, W, _ = C.shape
        S0 = kernels.sgm_sweep(C, None, 1, 0, p1, p2)  # a partial sum
        kitti = preset == "kitti_sgm8"
        forms = ("write", "add") if kitti else ("add",)
        imgs = (None, L) if kitti else (None,)
        for (dy, dx), form, img in [(r, f, i) for r in dirs for f in forms
                                    for i in imgs]:
            acc = form == "add"
            ref = (kernels.sgm_sweep(C, S0.clone() if acc else None, dy, dx,
                                     p1, p2, img),)
            outs = (torch.empty_like(S0),)

            def launch(lib, C=C, outs=outs, dy=dy, dx=dx, acc=acc, p1=p1,
                       p2=p2, img=img):
                # the current interface: the image, then no carry in or out
                # and no carry row
                im = (() if getattr(lib, "tps_against", False)
                      else (None if img is None else _build.ptr(img), None,
                            None, None))
                return lib.sgm_sweep_launch(
                    _build.ptr(C), _build.ptr(outs[0]), *im, *C.shape, dy,
                    dx, p1, p2, int(acc), _build.stream_ptr(C))

            def reset(outs=outs, acc=acc, S0=S0):
                if acc:
                    outs[0].copy_(S0)
            label = (f"{'kitti' if kitti else 'middlebury'}_F4_{dy},{dx}_"
                     f"{form}{'' if img is None else '_adaptive'}")
            cases.append((label, [B, H, W, D], ref, outs, launch,
                          {"reset": reset, "skip_against": img is not None}))
    return cases


def _fused_scratch(B: int, W: int, D: int, dev):
    """Flags, edges and carries between bands for any build's tiles (edge
    buffer for tiles of 8 columns, carries for tiles of up to 32)."""
    tiles = B * -(-W // 8)
    return (torch.zeros(tiles, dtype=torch.int32, device=dev),
            torch.empty(tiles * 2 * 2 * 8 * D, dtype=torch.int16, device=dev),
            torch.empty((W + 32) * 3 * D, dtype=torch.int16, device=dev))


def _fused_cases(dev) -> list:
    """The `sgm_fused` cases at KITTI F = 4: the down set written and the up
    set added (on the down set's sum), with the scalar P2 and with
    adaptive P2 (the frames' left images); and the same pair, scalar, on
    one 375 x 1242 frame at D = 256 and 512 (the census volume of a
    synthetic frame at that D). Each launch zeroes the tiles' flags
    first, as the wrapper does."""
    cfg = PRESETS["kitti_sgm8"]
    L, R = _frames((375, 1242), cfg.frames_per_step, 40.0, dev)
    p1, p2 = cfg.p1, cfg.p2
    cases = []
    for D, F in ((cfg.num_disparities, cfg.frames_per_step), (256, 1),
                 (512, 1)):
        C = kernels.census_cost_volume(L[:F].contiguous(),
                                       R[:F].contiguous(), D,
                                       cfg.max_census_cost,
                                       cfg.census_window, cfg.min_disparity)
        B, H, W, _ = C.shape
        flags, edges, state = _fused_scratch(B, W, D, dev)
        S0 = kernels.sgm_sweep_fused(C, None, 1, VERTICAL_DXS, p1, p2)
        for (dy, form), img in [(c, i) for c in ((1, "write"), (-1, "add"))
                                for i in ((None, L) if F > 1 else (None,))]:
            acc = form == "add"
            ref = (kernels.sgm_sweep_fused(C, S0.clone() if acc else None,
                                           dy, VERTICAL_DXS, p1, p2, img),)
            outs = (torch.empty_like(S0),)

            def launch(lib, C=C, outs=outs, dy=dy, acc=acc, img=img,
                       flags=flags, edges=edges, state=state):
                flags.zero_()
                # the current interface: no carry in or out, no carry row
                carry = (() if getattr(lib, "tps_against", False)
                         else (None, None, None))
                return lib.sgm_fused_launch(
                    _build.ptr(C), _build.ptr(outs[0]),
                    None if img is None else _build.ptr(img),
                    _build.ptr(flags), _build.ptr(edges), _build.ptr(state),
                    *carry, *C.shape, dy, len(VERTICAL_DXS), *VERTICAL_DXS,
                    p1, p2, int(acc), _build.stream_ptr(C))

            def reset(outs=outs, acc=acc, S0=S0):
                if acc:
                    outs[0].copy_(S0)
            where = "kitti_F4" if F > 1 else f"d{D}_1x375x1242"
            label = (f"{where}_{'down' if dy > 0 else 'up'}_{form}"
                     f"{'' if img is None else '_adaptive'}")
            cases.append((label, [B, H, W, D], ref, outs, launch,
                          {"reset": reset}))
    return cases


def _sass_classes(sass: str, fn: str) -> dict:
    """Opcode counts of function fn in `cuobjdump -sass` text, split into
    segments at its block barriers (`BAR.SYNC`): {"segments": [{class:
    count}], "row": the index of the segment with the warp minimums
    (`REDUX`), the row's body}."""
    lines, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = line.split("Function :")[1].strip() == fn
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if inside and m:
            lines.append(m.group(1))
    segs, cur = [], collections.Counter()

    def klass(op: str) -> str:
        base = op.split(".")[0]
        if base.startswith("VI") or base in ("VHMNMX",):
            return "dpx"
        if base == "PRMT":
            return "prmt"
        if base in ("LDS", "STS", "LDSM", "ATOMS"):
            return "shared"
        if base in ("SHFL", "REDUX", "VOTE", "MATCH"):
            return "warp"
        if base in ("LDG", "STG", "LDGSTS", "LDGDEPBAR", "DEPBAR", "LD",
                    "ST", "RED", "ATOM", "ATOMG", "CCTL", "MEMBAR",
                    "FENCE", "ERRBAR"):
            return "global"
        if base in ("LEA", "IMAD") and (".WIDE" in op or ".X" in op
                                         or ".HI" in op):
            return "address"
        if base == "IADD3" and ".X" in op:
            return "address"
        if base in ("BAR", "BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL",
                    "WARPSYNC", "YIELD", "NOP", "BPT", "S2R", "S2UR", "CS2R",
                    "NANOSLEEP", "BMOV", "ELECT"):
            return "control"
        if base.startswith("U") and base not in ("UMOV",):
            return "uniform"
        return "int_alu"

    for op in lines:
        cur[klass(op)] += 1
        cur["_all"] += 1
        if op.startswith("REDUX"):
            cur["_redux"] += 1
        if op.startswith("BAR"):
            segs.append(dict(cur))
            cur = collections.Counter()
    segs.append(dict(cur))
    row = max(range(len(segs)), key=lambda i: (segs[i].get("_redux", 0),
                                                segs[i].get("_all", 0)))
    return {"segments": segs, "row": row, "total": len(lines)}


def _fused_anatomy(lib) -> dict:
    """The shipped `sgm_fused` library's SASS by opcode class for each
    s16x2 build, registers and spills from its build log, blocks an SM of
    the build each D takes (int32 at D = 512), and the SM clocks."""
    out = {}
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.lib_path("sgm_fused")],
                          capture_output=True, text=True, timeout=300).stdout
    fns = sorted(set(re.findall(r"Function : (\S*sgm_fused_kernel\S*)",
                                sass)))
    out["sass"] = {}
    for fn in fns:
        # _Z16sgm_fused_kernelILi4ELb0ELb0ELb1EEv9FusedArgs: K, ACC, ADAPT,
        # PACKED
        m = re.search(r"ILi(\d+)ELb(\d)ELb(\d)ELb(\d)E", fn)
        if not m or m.group(4) != "1":
            continue
        key = (f"K{m.group(1)}_{'add' if m.group(2) == '1' else 'write'}"
               f"{'_adaptive' if m.group(3) == '1' else ''}")
        out["sass"][key] = _sass_classes(sass, fn)
    with open(_build.log_path("sgm_fused")) as f:
        log = f.read()
    out["ptxas"] = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
    occ = {}
    lib.sgm_fused_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.sgm_fused_occupancy.restype = ctypes.c_int
    for D, packed in ((128, 1), (256, 1), (512, 0)):
        for acc in (0, 1):
            for ad in (0, 1):
                v = (ctypes.c_int * 3)()
                rc = lib.sgm_fused_occupancy(D, acc, ad, packed, v)
                occ[f"D{D}_{'add' if acc else 'write'}"
                    f"{'_adaptive' if ad else ''}"] = {
                    "rc": rc, "blocks_per_sm": v[0], "smem": v[1],
                    "registers": v[2]}
    out["occupancy"] = occ
    out["clocks"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return out


def _phase_split(lib, run) -> dict:
    """Cycles a warp a row by phase of one launch of the `phases` build."""
    names = ("xch_in", "ring_wait", "loads", "steps", "warp_min", "stores",
             "fill", "barrier", "xch_out", "other")
    buf = (ctypes.c_ulonglong * (len(names) + 1))()
    lib.sgm_fused_phases.argtypes = [ctypes.c_void_p]
    lib.sgm_fused_phases.restype = ctypes.c_int
    torch.cuda.synchronize()
    lib.sgm_fused_phases(buf)        # zero the sums
    run(lib)
    torch.cuda.synchronize()
    if lib.sgm_fused_phases(buf) != 0:
        raise RuntimeError("sgm_fused_phases failed")
    rows = max(buf[len(names)], 1)
    split = {n: buf[i] / rows for i, n in enumerate(names)}
    split["warp_rows"] = buf[len(names)]
    return split


class _CarrylessLib:
    """Another checkout's `sgm_fused` library, whose C interface predates
    the carry arguments, behind the current one, so that the wrapper (and
    the pipeline above it) can run it: calls with no carry only."""

    def __init__(self, lib):
        self._lib = lib
        lib.tps_error_string.argtypes = [ctypes.c_int]
        lib.tps_error_string.restype = ctypes.c_char_p

    def sgm_fused_launch(self, *args):
        if any(x is not None for x in args[6:9]):
            raise ValueError("this build takes no carry")
        return self._lib.sgm_fused_launch(*args[:6], *args[9:])

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _fused_pipeline(libs: dict, dev) -> dict:
    """In turns by events, the shipped build against each `--against`
    build through the wrapper: a set at KITTI F=4 (the down set written,
    the up set added, then the E sweep's add) and a `kitti_sgm8` batch of
    8 frames (`pipeline.sgbm_batched`), the batch's output held equal."""
    from tpustereo_torch.pipeline import sgbm_batched
    cfg = PRESETS["kitti_sgm8"]
    p1, p2 = cfg.p1, cfg.p2
    L, R = _frames((375, 1242), 8, 40.0, dev)
    F = cfg.frames_per_step
    C = kernels.census_cost_volume(L[:F].contiguous(), R[:F].contiguous(),
                                   cfg.num_disparities, cfg.max_census_cost,
                                   cfg.census_window, cfg.min_disparity)

    def a_set():
        S = kernels.sgm_sweep_fused(C, None, 1, VERTICAL_DXS, p1, p2)
        kernels.sgm_sweep_fused(C, S, -1, VERTICAL_DXS, p1, p2)
        kernels.sgm_sweep(C, S, 0, 1, p1, p2)

    def batch():
        return sgbm_batched(L, R, cfg)
    shipped = _build.load("sgm_fused", _FUSED_SIGS)
    others = {b: _CarrylessLib(lib) if getattr(lib, "tps_against", False)
              else lib for b, lib in libs.items() if b not in
              ABLATIONS["sgm_fused"] and b not in SIZES["sgm_fused"]}
    ref = batch()
    turns = [("shipped_first", shipped), *others.items(),
             ("shipped_last", shipped)]
    out = {"set_ms": {}, "batch_ms": {}}
    try:
        for key, lib in turns:
            _build._libs["sgm_fused"] = lib
            if not torch.equal(batch(), ref):
                raise SystemExit(f"kernel_micro: the kitti_sgm8 batch with "
                                 f"build {key} differs from the shipped one")
            out["set_ms"][key] = _ms(a_set)
            out["batch_ms"][key] = _ms(batch, 10)
    finally:
        _build._libs["sgm_fused"] = shipped
    return out


def _fused_routes(dev) -> dict:
    """In turns, events and graph replay: on one 375 x 1242 frame at D =
    128, 256 and 512 the fused down and up sets (a write and an add)
    against the six one-direction launches (S written, the others added);
    and the fused carry form, in and out, on one 192-row strip of a 376 x
    1241 frame against the same launch without a carry."""
    cfg = PRESETS["kitti_sgm8"]
    p1, p2 = cfg.p1, cfg.p2
    L, R = _frames((375, 1242), 1, 40.0, dev)
    out = {}
    for D in (128, 256, 512):
        C = kernels.census_cost_volume(L, R, D, cfg.max_census_cost,
                                       cfg.census_window, cfg.min_disparity)

        def fused(C=C):
            S = kernels.sgm_sweep_fused(C, None, 1, VERTICAL_DXS, p1, p2)
            return kernels.sgm_sweep_fused(C, S, -1, VERTICAL_DXS, p1, p2)

        def six(C=C):
            S = None
            for dy in (1, -1):
                for dx in VERTICAL_DXS:
                    S = kernels.sgm_sweep(C, S, dy, dx, p1, p2)
            return S
        if not torch.equal(fused(), six()):
            raise SystemExit(f"kernel_micro: the fused sets differ from the "
                             f"six launches at D = {D}")
        res = {}
        for key, fn in (("six_first", six), ("fused_first", fused),
                        ("fused_last", fused), ("six_last", six)):
            res[key] = {"ms": _ms(fn), "graph_ms": _graph_ms(fn)}
        out[f"d{D}_1x375x1242"] = res
    ocfg = PRESETS["kitti_odometry"]
    L, R = _frames((376, 1241), 1, 45.0, dev)
    D = ocfg.num_disparities
    C = kernels.census_cost_volume(L, R, D, ocfg.max_census_cost,
                                   ocfg.census_window,
                                   ocfg.min_disparity)[:, :192].contiguous()
    _, _, W, _ = C.shape
    q = torch.zeros((3, 1, W, D), dtype=torch.int32, device=dev)
    S = kernels.sgm_sweep_fused(C, None, 1, VERTICAL_DXS, p1, p2)
    with_carry = (lambda: kernels.sgm_sweep_fused(
        C, S, 1, VERTICAL_DXS, p1, p2, carry=q, return_carry=True))
    without = (lambda: kernels.sgm_sweep_fused(C, S, 1, VERTICAL_DXS, p1,
                                               p2))
    res = {}
    for key, fn in (("without_first", without), ("carry_first", with_carry),
                    ("carry_last", with_carry), ("without_last", without)):
        res[key] = {"ms": _ms(fn), "graph_ms": _graph_ms(fn)}
    out["carry_add_1x192x1241"] = res
    return out


def _hits_cases(dev) -> list:
    """The hits kernel on the KITTI path's d_r and disparity of 4 frames,
    and on 4 rows of 240,000 columns."""
    cfg = PRESETS["kitti_sgm8"]
    L, R = _frames((375, 1242), cfg.frames_per_step, 40.0, dev)
    D, d0, md = cfg.num_disparities, cfg.min_disparity, cfg.disp12_max_diff
    C = kernels.census_cost_volume(L, R, D, cfg.max_census_cost,
                                   cfg.census_window, d0)
    disp, _, d_r = kernels.sgm_select(C, cfg)
    del C
    rng = np.random.default_rng(5)
    wide = (torch.from_numpy(rng.integers(-3, D + 3, (4, 240000),
                                          dtype=np.int32)).to(dev),
            torch.from_numpy(rng.uniform(d0 - 0.5, d0 + D - 0.5, (4, 240000))
                             .astype(np.float32)).to(dev))
    cases = []
    for label, (dr, dv), extra in (("hits_kitti_F4", (d_r, disp), {}),
                                   ("hits_4x240000", wide,
                                    {"skip_against": True})):
        ref = kernels.dr_consistency_hits(dr, dv, D, md, d0)
        outs = tuple(torch.empty_like(t) for t in ref)
        W = dr.shape[-1]

        def launch(lib, dr=dr, dv=dv, outs=outs, W=W):
            return lib.lr_hits_launch(
                _build.ptr(dr), _build.ptr(dv), *map(_build.ptr, outs),
                dr.numel() // W, W, D, md, d0, _build.stream_ptr(dr))
        cases.append((label, list(dr.shape), ref, outs, launch, extra))
    return cases


def _strided_roll_plan(length: int):
    """The plan of the roll kernel before the blocked slots: (slots a
    lane, pad) of its strided layout."""
    slots = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 40, 48, 56, 64, 65)
    if length % 32 == 0 and length // 32 in slots:
        return length // 32, 0
    return next(e for e in slots if 32 * e >= length + 2), 1


def _roll_cases(dev) -> list:
    """The roll kernel at `chip_smoke.py` step 17's shapes and chains (both
    axes, bfloat16), chain 0, one line, and other plans of the same lines.
    A checkout of the strided kernel (`--against`) takes lines of at most
    2,048 values."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []

    def case(label, x, chain, axis, plan=None):
        bf16 = x.dtype == torch.bfloat16
        N, D = x.shape
        if bf16:
            ref = wm.bf16_roll_chain_micro_plain(x, chain)
            geo = (N // 2, D, 2 * D, 1, 1)
        else:
            ref = wm.roll_chain_micro_plain(x, chain, axis)
            geo = (N, D, D, 1, 0) if axis == 1 else (D, N, 1, D, 0)
        outs = (torch.empty_like(x),)
        length = geo[1]

        def launch(lib, x=x, outs=outs, geo=geo, chain=chain, plan=plan):
            if getattr(lib, "tps_strided", False):
                a, b = _strided_roll_plan(length)
            else:
                a, b = plan or wm._roll_plan(length)
            return lib.roll_micro_launch(
                _build.ptr(x), _build.ptr(outs[0]), *geo, a, b, chain,
                _build.stream_ptr(x))
        strided_ok = plan is None and length <= 2048
        extra = {"takes": lambda b, lib, ok=strided_ok: (
            b not in CHAIN_BUILDS and b not in SWEEP_BUILDS
            and (ok or not getattr(lib, "tps_strided", False)))}
        cases.append((label, [*x.shape, chain, axis, *(plan or ())],
                      (ref,), outs, launch, extra))

    for key, shape in (("r43b", (1248, 128)), ("fill", (16896, 128))):
        xi = torch.randint(0, 200, shape, generator=gen, device=dev,
                           dtype=torch.int32)
        xb = xi.bfloat16()
        for chain in (0, 64, 512):
            for axis in (1, 0):
                case(f"{key}_axis{axis}_c{chain}", xi, chain, axis)
            if chain:
                case(f"{key}_bf16_c{chain}", xb, chain, 1)
        plans = ((24, 52), (12, 104)) if key == "r43b" else ((48, 352),)
        for plan in plans:
            case(f"{key}_axis0_c512_plan{plan[0]}x{plan[1]}", xi, 512, 0,
                 plan)
    for label, shape, axis in (("line_axis1", (1, 128), 1),
                               ("line_axis0", (1248, 1), 0),
                               ("line_bf16", (2, 128), 1)):
        xi = torch.randint(0, 200, shape, generator=gen, device=dev,
                           dtype=torch.int32)
        x = xi.bfloat16() if label == "line_bf16" else xi
        for chain in (64, 512):
            case(f"{label}_c{chain}", x, chain, axis)
    return cases


def _chain_cases(dev) -> list:
    """The chain kernel at `chip_smoke.py` step 17's shapes, both kinds and
    every dtype: chains 0 (the loads and stores alone), 64 and 512 on
    `_chain_plan`'s grid, and at chains 64 and 512 each other plan (1,
    2 or 4 words a thread in blocks of 128, and 4 in blocks of 256, the
    grid before the plan; the shipped build only); and one warp's values
    at one word a thread ("warp", chains 64 and 512, the shipped build
    only), whose steps wait on one another. A checkout from before the
    plan runs its own grid. A case's extra "clock" is (kind and dtype,
    words and threads of its plan, chain, warps), which `_chain_clocks`
    reads."""
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = wm._sm_count(dev)
    cases = []
    candidates = [(w, wm.CHAIN_THREADS) for w in wm.CHAIN_WORDS] + [(4, 256)]
    for key, shape in (("r43b", (1248, 128)), ("fill", (16896, 128)),
                       ("warp", None)):
        for kind, dt in wm.CHAIN_CLOCKS:
            per = wm._values_per_word(dt)
            xi = torch.randint(0, 200, shape or (1, 32 * per), generator=gen,
                               device=dev, dtype=torch.int32)
            x, n = xi.to(dt), xi.numel()
            plain = (wm.elem_chain_micro_plain if kind == wm._ELEM
                     else wm.reg_chain_micro_plain)
            shipped = wm._chain_plan(n, dt, kind, sms)
            others = [(w, t, -(-n // (per * w * t))) for w, t in candidates]
            others = [p for p in others if p != shipped]
            what = (f"{'elem' if kind == wm._ELEM else 'reg'}_"
                    f"{DT_NAMES[wm._DT[dt]]}")
            for chain in (0, 64, 512) if shape else (64, 512):
                plans = ([None] + (others if chain else []) if shape
                         else [(1, wm.CHAIN_THREADS, 1)])
                for plan in plans:
                    outs = (torch.empty_like(x),)

                    def launch(lib, x=x, outs=outs, chain=chain, kind=kind,
                               plan=plan or shipped):
                        if getattr(lib, "tps_against", False):
                            return lib.chain_micro_launch(
                                _build.ptr(x), _build.ptr(outs[0]),
                                x.numel(), wm._DT[x.dtype], kind, chain,
                                _build.stream_ptr(x))
                        return lib.chain_micro_launch(
                            _build.ptr(x), _build.ptr(outs[0]), x.numel(),
                            wm._DT[x.dtype], kind, *plan, chain,
                            _build.stream_ptr(x))
                    label = f"{key}_{what}_c{chain}" + (
                        f"_plan{plan[0]}x{plan[1]}" if plan and shape else "")
                    only_shipped = plan is not None
                    w, t, b = plan or shipped
                    extra = {"takes": lambda b, lib, o=only_shipped: (
                        not o and (b in CHAIN_BUILDS or lib.tps_checkout)),
                        "clock": (what.replace("_", " "), w, t, chain,
                                  b * t // 32)}
                    cases.append((label, [*xi.shape, chain, w, t, b],
                                  (plain(x, chain),), outs, launch, extra))
    return cases


def _chain_clocks(cases, result: dict, sms: int) -> dict:
    """`kernels.width_micro.CHAIN_CLOCKS` as this run measured it, from the
    shipped build's device time a launch (`profile_ms`, which leaves out
    the gaps between launches), by kind and dtype: "step", by words a
    thread, the clocks a warp's step takes its scheduler at (16896, 128)
    in blocks of `CHAIN_THREADS`, where every scheduler holds the same
    warps (the ms between chains 64 and 512 x `ISSUE_HZ` x the card's
    schedulers, over the warps and the 448 steps); "latency", the clocks
    of one warp's dependent step (the "warp" cases: their ms between
    chains 64 and 512 x `ISSUE_HZ` over the 448 steps)."""
    ms = {}
    for label, *rest in cases:
        extra = rest[4] if len(rest) > 4 else {}
        if "clock" in extra and label in result and (
                label.startswith(("fill_", "warp_"))):
            what, w, t, chain, warps = extra["clock"]
            if t == wm.CHAIN_THREADS:
                ms[label.split("_")[0], what, w, chain] = (
                    sum(result[label]["profile_ms"]["shipped"].values()),
                    warps)
    out = {}
    for (key, what, w, chain), (t512, warps) in ms.items():
        if chain != 512 or (key, what, w, 64) not in ms:
            continue
        clocks = ((t512 - ms[key, what, w, 64][0]) * 1e-3 * ISSUE_HZ
                  / (512 - 64))
        entry = out.setdefault(what, {"step": {}, "latency": None})
        if key == "warp":
            entry["latency"] = round(clocks, 2)
        elif warps % (sms * wm.SCHEDULERS) == 0:
            entry["step"][w] = round(
                clocks * sms * wm.SCHEDULERS / warps, 2)
    return out


# `chip_smoke.py` step 17's sweep shapes, (T, N): the JAX script's and
# the E sweep's at KITTI F = 4 (1,500 lines of 1,242 steps); "line" is one
# warp's line (two rows for the paired modes), the step chain's own floor
SWEEP_MICRO_SHAPES = {"r43b": (376, 1280), "kitti_E": (1242, 1500),
                      "line": (376, None)}


def _sweep_micro_cases(dev) -> list:
    """The sweep kernel in every mode at `SWEEP_MICRO_SHAPES` (p1 = 10,
    p2 = 120, costs in [0, 25), as step 17 makes them), each build held
    to the plain version; taken by the sweep builds and the checkouts."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for key, (T, N) in SWEEP_MICRO_SHAPES.items():
        for mode in wm.MODES:
            rows = N or (1 if mode in ("v32", "v32_i8") else 2)
            C8 = torch.randint(0, 25, (T, rows, wm.D_MICRO), generator=gen,
                               device=dev, dtype=torch.int8)
            C = (C8 if mode in wm.I8_MODES else C8.int() if mode == "v32"
                 else wm.pack_rows(C8.int()))
            ref = wm.sweep_micro_plain(C, mode, 10, 120)
            outs = (torch.empty_like(ref),)

            def launch(lib, C=C, outs=outs, mode=mode):
                return lib.sweep_micro_launch(
                    _build.ptr(C), _build.ptr(outs[0]), C.shape[0],
                    C.shape[1], wm.MODES.index(mode), 10, 120,
                    _build.stream_ptr(C))
            extra = {"takes": lambda b, lib: (b in SWEEP_BUILDS
                                              or lib.tps_checkout)}
            cases.append((f"sweep_{key}_{mode}", list(C.shape), (ref,),
                          outs, launch, extra))
    return cases


def _cases(name: str, dev) -> list:
    """[(label, shape, reference outputs, output buffers, launch(lib),
    optional {"copy": fn, "reset": fn, "skip_against": bool, "takes":
    fn(build, lib)})] at the
    path's shapes; launch passes the current stream, so that a CUDA graph
    can capture it. `copy` is a part of each launch timed alone, `reset`
    runs before each build's check, `skip_against` leaves the `--against`
    builds out of the case."""
    if name == "sgm_sweep":
        return _sweep_cases(dev)
    if name == "sgm_fused":
        return _fused_cases(dev)
    if name == "lr_check":
        return _hits_cases(dev)
    if name == "width_micro":
        return _sweep_micro_cases(dev) + _roll_cases(dev) + _chain_cases(dev)
    cases = []

    def stream():
        return _build.stream_ptr(torch.empty(0, device=dev))

    if name in ("bwd_wta", "census_cost"):
        cfg = PRESETS["kitti_sgm8"]
        L, R = _frames((375, 1242), 4, 40.0, dev)
        D, d0 = cfg.num_disparities, cfg.min_disparity
        (ch, cw), bits = cfg.census_window, cfg.max_census_cost
        C = kernels.census_cost_volume(L, R, D, bits, (ch, cw), d0)
        B, H, W, _ = C.shape
        if name == "bwd_wta":
            # the scalar and the adaptive P2 (`kitti_sgm8` with
            # adaptive_p2=True: its S7 and the left images)
            for label, img in (("kitti_F4", None),
                               ("kitti_F4_adaptive", L)):
                S7 = None
                for dy, dx in DIRS_8:
                    if (dy, dx) != (0, -1):
                        S7 = kernels.sgm_sweep(C, S7, dy, dx, cfg.p1,
                                               cfg.p2, img)
                ref = kernels.sweep_bwd_wta(C, S7, cfg, img)
                outs = tuple(torch.empty_like(t) for t in ref)

                def launch(lib, S7=S7, outs=outs, img=img):
                    im = (() if getattr(lib, "tps_against", False)
                          else (None if img is None else _build.ptr(img),))
                    return lib.bwd_wta_launch(
                        _build.ptr(C), _build.ptr(S7), *im,
                        *map(_build.ptr, outs), B * H, W, D, cfg.p1, cfg.p2,
                        cfg.uniqueness_ratio, int(cfg.subpixel), d0,
                        stream())
                cases.append((label, [B, H, W, D], ref, outs, launch,
                              {"skip_against": img is not None}))
        else:
            outs = (torch.empty_like(C),)
            cases.append(("kitti_F4", [B, H, W, D], (C,), outs, lambda lib: (
                lib.census_cost_launch(
                    _build.ptr(L), _build.ptr(R), _build.ptr(outs[0]), B, H,
                    W, D, ch, cw, d0, bits, stream()))))
    elif name == "bitonic":
        _, _, lab, _ = _kitti_speckle(dev)
        F, H, W = lab.shape
        n = H * W
        n2 = 1 << padded_log2(n)
        keys = lab.reshape(F, n)
        idx = torch.arange(n, dtype=torch.int32, device=dev).expand(F, n)
        sk, sp = kernels.bitonic_sort(keys, idx)
        packed = sp * 2 + (sk & 1)
        for label, k, p in (("pair_F4", keys, idx),
                            ("keys_F4", packed, None)):
            src = [torch.full((F, n2), IMAX, dtype=torch.int32, device=dev)]
            src[0][:, :n] = k
            if p is not None:
                src.append(torch.zeros((F, n2), dtype=torch.int32,
                                       device=dev))
                src[1][:, :n] = p
            outs = tuple(torch.empty_like(t) for t in src)
            ref = tuple(t.clone() for t in src)
            lib = _build.load("bitonic", _BITONIC_SIGS)
            _build.check(lib, lib.bitonic_launch(
                _build.ptr(ref[0]), _build.ptr(ref[1]) if p is not None
                else None, F, padded_log2(n), stream()), "bitonic_sort")

            def launch(lib, src=src, outs=outs):
                for o, s in zip(outs, src):
                    o.copy_(s)
                return lib.bitonic_launch(
                    _build.ptr(outs[0]),
                    _build.ptr(outs[1]) if len(outs) > 1 else None,
                    F, padded_log2(n), stream())

            def copy(src=src, outs=outs):
                for o, s in zip(outs, src):
                    o.copy_(s)
            cases.append((label, [F, n], ref, outs, launch, {"copy": copy}))
    elif name == "cc_labels":
        conn_h, conn_v, lab, _ = _kitti_speckle(dev)
        F, H, W = lab.shape
        outs = (torch.empty_like(lab),)
        cases.append(("kitti_F4", [F, H, W], (lab,), outs, lambda lib: (
            lib.cc_labels_launch(_build.ptr(conn_h), _build.ptr(conn_v),
                                 _build.ptr(outs[0]), F, H, W, stream()))))
    elif name == "median3":
        *_, med_in = _kitti_speckle(dev)
        F, H, W = med_in.shape
        outs = (torch.empty_like(med_in),)
        cases.append(("kitti_F4", [F, H, W], (kernels.median3(med_in),),
                      outs, lambda lib: lib.median3_launch(
                          _build.ptr(med_in), _build.ptr(outs[0]), F, H, W,
                          stream())))
    elif name == "sgm_bidir":
        cfg = PRESETS["kitti_sgm8"]
        L, R = _frames((375, 1242), 4, 40.0, dev)
        D, p1, p2 = cfg.num_disparities, cfg.p1, cfg.p2
        C = kernels.census_cost_volume(L, R, D, cfg.max_census_cost,
                                       cfg.census_window, cfg.min_disparity)
        B, H, W, _ = C.shape
        dxs = (0, 1, -1)
        outs = (torch.empty(C.shape, dtype=torch.int16, device=dev),
                torch.empty(C.shape, dtype=torch.int16, device=dev))

        def launch(lib):
            packed = () if getattr(lib, "tps_against", False) else (1,)
            for i, dx in enumerate(dxs):
                rc = lib.sgm_bidir_launch(
                    _build.ptr(C), *map(_build.ptr, outs), B, H, W, D, dx,
                    p1, p2, int(i > 0), *packed, stream())
                if rc != 0:
                    return rc
            return 0
        cases.append(("kitti_F4_dx3", [B, H, W, D],
                      kernels.sgm_sweep_bidir(C, dxs, p1, p2), outs, launch))
    elif name == "sad_wta":
        base = PRESETS["tsukuba_sad"]
        L, R = _frames((288, 384), 1, 20.0, dev)
        B, H, W = L.shape
        for label, cfg in (("tsukuba_F1", base),
                           ("tsukuba_F1_lr", base.replace(disp12_max_diff=1))):
            ref = tuple(t for t in kernels.sad_wta(L, R, cfg)
                        if t is not None)
            outs = tuple(torch.empty_like(t) for t in ref)
            with_dr = cfg.disp12_max_diff >= 0

            def launch(lib, cfg=cfg, outs=outs, with_dr=with_dr):
                d_r = _build.ptr(outs[2]) if with_dr else None
                return lib.sad_wta_launch(
                    _build.ptr(L), _build.ptr(R), _build.ptr(outs[0]),
                    _build.ptr(outs[1]), d_r, B, H, W, cfg.num_disparities,
                    cfg.sad_block, cfg.min_disparity, cfg.uniqueness_ratio,
                    int(cfg.subpixel), int(with_dr), stream())
            cases.append((label, [B, H, W, base.num_disparities], ref, outs,
                          launch))
    else:
        cw_cfg = PRESETS["middlebury_census_wta"]
        L, R = _frames((375, 621), 1, 40.0, dev)
        C = kernels.census_cost_volume(L, R, cw_cfg.num_disparities,
                                       cw_cfg.max_census_cost,
                                       cw_cfg.census_window,
                                       cw_cfg.min_disparity)
        del L, R
        m_cfg = PRESETS["middlebury_sgm4"]
        L, R = _frames((1988, 2964), m_cfg.frames_per_step, 60.0, dev)
        S = sgbm_volume(L, R, m_cfg)
        del L, R
        for label, vol, cfg in (("census_wta_F1", C, cw_cfg),
                                ("middlebury_F4_lr", S, m_cfg)):
            ref = kernels.wta_lr(vol, cfg)
            outs = tuple(torch.empty_like(t) for t in ref)
            B, H, W, D = vol.shape
            need_map = cfg.disp12_max_diff >= 0
            dmap = torch.empty(ref[0].shape, dtype=torch.int32, device=dev)

            def launch(lib, vol=vol, cfg=cfg, outs=outs, dmap=dmap,
                       need_map=need_map):
                return lib.wta_lr_launch(
                    _build.ptr(vol), _build.ptr(outs[0]), _build.ptr(outs[1]),
                    None, _build.ptr(dmap) if need_map else None,
                    vol.shape[0] * vol.shape[1], vol.shape[2], vol.shape[3],
                    vol.element_size(), cfg.uniqueness_ratio,
                    int(cfg.subpixel), cfg.min_disparity,
                    cfg.disp12_max_diff, stream())
            cases.append((label, [B, H, W, D], ref, outs, launch))
    return cases


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal outputs, float32 bit for bit (so -0.0 differs from +0.0)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _graph_ms(fn, reps: int = 20) -> float:
    """Mean device ms of fn() by replay of `reps` calls in one CUDA graph."""
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
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def _split(fn, reps: int = 20) -> dict:
    """Mean device ms a call of fn() spends in each kernel, by name
    (`torch.profiler`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        # the pipeline's spans also appear there, as annotations
        if e.device_type == DeviceType.CUDA and not e.name.startswith("tps."):
            name = e.name.split("(")[0][:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / (
                1e3 * reps)
    return out


def _ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(name: str, against: tuple = (), only=None, cases=None) -> None:
    if name not in SIGS:
        raise SystemExit(f"kernel_micro: name one of {sorted(SIGS)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_micro: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    picked = cases
    cases = [c for c in _cases(name, dev)
             if picked is None or any(p in c[0] for p in picked)]
    libs = _compile(name, against, only)
    shipped = _build.load(name, SIGS[name])
    result, differs = {}, []
    for label, shape, ref, outs, launch, *extra in cases:
        extra = extra[0] if extra else {}

        def run(lib, launch=launch):
            rc = launch(lib)
            if rc != 0:
                raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

        takes = extra.get("takes", lambda b, lib: True)
        builds = {b: lib for b, lib in libs.items()
                  if takes(b, lib) and not (
                      extra.get("skip_against")
                      and getattr(lib, "tps_against", False))}
        for b, lib in list(builds.items()):
            if "reset" in extra:
                extra["reset"]()
            run(lib)
            torch.cuda.synchronize()
            if b not in ABLATIONS[name] and not all(
                    _same(o, r) for o, r in zip(outs, ref)):
                # reported, left out of the timings, and the run fails
                print(f"kernel_micro: {name} build {b} differs from the "
                      f"shipped kernel ({label})", flush=True)
                differs.append((b, label))
                del builds[b]
        res, gres = {}, {}
        for key, lib in [("shipped_first", shipped), *builds.items(),
                         ("shipped_last", shipped)]:
            res[key] = _ms(lambda lib=lib: run(lib))
            gres[key] = _graph_ms(lambda lib=lib: run(lib))
        result[label] = {"shape": shape, "ms_per_launch": res,
                         "graph_ms_per_launch": gres}
        result[label]["profile_ms"] = {
            key: _split(lambda lib=lib: run(lib))
            for key, lib in [("shipped", shipped), *builds.items()]}
        if "copy" in extra:
            result[label]["copy_ms"] = _ms(extra["copy"])
            result[label]["copy_graph_ms"] = _graph_ms(extra["copy"])
        if "phases" in builds:
            result[label]["phase_cycles_per_warp_row"] = _phase_split(
                builds["phases"], run)
        print(f"{label}: {json.dumps(result[label])}", flush=True)
    record = {"card": card, "kernel": name, "cases": result}
    if name == "width_micro" and os.path.exists(_build.log_path(name)):
        with open(_build.log_path(name)) as f:
            record["ptxas_shipped"] = _ptxas_width(f.read())
        # each build's chain loop: warp-instructions a step by kernel
        sass = {"shipped": (_build.lib_path(name), shipped)}
        sass.update({b: (lib.tps_path, lib) for b, lib in libs.items()
                     if b in CHAIN_BUILDS or lib.tps_checkout})
        record["chain_sass"] = {b: chain_sass(path)
                                for b, (path, _) in sass.items()}
        record["chain_issue"] = {
            b: chain_issue(record["chain_sass"][b], chain_unroll(lib))
            for b, (path, lib) in sass.items()}
        print(f"chain_sass: {json.dumps(record['chain_sass'])}\n"
              f"chain_issue: {json.dumps(record['chain_issue'])}",
              flush=True)
        record["chain_clocks"] = _chain_clocks(cases, result,
                                               wm._sm_count(dev))
        print(f"chain_clocks: {json.dumps(record['chain_clocks'])}",
              flush=True)
        if "smid" in libs:
            # each chain case at chain 512; each sweep case at its shapes
            record["chain_sm_blocks"] = _sm_balance(
                libs["smid"], cases, lambda label: "_c512" in label and (
                    "elem" in label or "reg" in label))
            record["sweep_sm_blocks"] = _sm_balance(
                libs["smid"], cases, lambda label: label.startswith(
                    "sweep_") and "_line_" not in label)
            print(f"chain_sm_blocks: "
                  f"{json.dumps(record['chain_sm_blocks'])}\n"
                  f"sweep_sm_blocks: "
                  f"{json.dumps(record['sweep_sm_blocks'])}", flush=True)
    if name == "sgm_fused":
        record["anatomy"] = _fused_anatomy(shipped)
        print(f"anatomy: {json.dumps(record['anatomy'])}", flush=True)
        record["routes"] = _fused_routes(dev)
        print(f"routes: {json.dumps(record['routes'])}", flush=True)
        record["pipeline"] = _fused_pipeline(libs, dev)
        print(f"pipeline: {json.dumps(record['pipeline'])}", flush=True)
    record["differs"] = differs
    print(json.dumps(record))
    if differs:
        raise SystemExit(f"kernel_micro: builds differ from the shipped "
                         f"kernel: {differs}")


if __name__ == "__main__":
    args = sys.argv[1:]
    against, only = [], None
    while "--against" in args:
        at = args.index("--against")
        against.append(args[at + 1])
        del args[at:at + 2]
    if "--only" in args:
        at = args.index("--only")
        only = {b for b in args[at + 1].split(",") if b}
        del args[at:at + 2]
    cases = None
    if "--cases" in args:
        at = args.index("--cases")
        cases = args[at + 1].split(",")
        del args[at:at + 2]
    main(args[0] if args else "", tuple(against), only, cases)
