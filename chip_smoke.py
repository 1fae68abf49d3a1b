#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`tpustereo_torch`) on one CUDA card.

    python3 chip_smoke.py

Builds the nineteen CUDA kernels (thirteen libraries) from
`tpustereo_torch/csrc/` with nvcc, then runs the port's paths.

The KITTI 8-path SGM preset as it stands (`PRESETS["kitti_sgm8"]`: speckle
window 100, range 2, the 3x3 median), at full KITTI size (375 x 1242,
D = 128, 8 frames, 4 per set of kernel launches):

1. builds the kernels and prints what ptxas says of each;
2. runs each of the path's seven kernels and its plain PyTorch version on the
   card at the main path's shapes (the speckle and median kernels on the
   main path's own disparity maps) and requires integer and bool outputs
   to be equal, the median bit for bit (also on a map of signed zeros) and
   the float disparity to agree within 1e-6, the census kernel also on
   one 2 x 9,000 frame (past the width its earlier design took), the
   sweep in both forms (S = L_r and S += L_r) in all eight directions,
   and the fused sweep (`sgm_sweep_fused`: the down set {S, SE, SW} or
   the up set {N, NE, NW} in one pass) written in one order and added in
   the other, also on one 375 x 1242 frame at D = 256 and 512 (at 512 its
   tiles outnumber the blocks the card holds), where it times the 8-path
   vertical sets as `sgm_select` runs them (past `FUSED_MAX_D` = 256 the
   six one-direction launches, decided from D) beside the fused pair, in
   turns;
3. drives `api.match_batch` on 8 synthetic pairs with every launch counter
   set to 0 just before, requires every kernel of the path to have
   launched, the sweeps as a fused write, a fused add and the one-direction
   E add a set of frames (2, 2 and 2 a batch, no other one-direction
   sweep), and holds the output against the plain PyTorch pipeline
   (the JAX package's jnp formulation, ported) run on the card;
4. times each kernel, its plain version, `component_big`, the whole path,
   and the whole path with speckle and the median off, with CUDA events,
   and the LR check, labelling and median kernels also by CUDA-graph
   replay (the device's time, without the host's per launch), and the
   sweep in each direction and form by both, beside its byte bound; the
   fused launches by both beside theirs; a set's sweeps (the fused
   schedule against the seven one-direction launches, beside the set's
   bound of one read of C) and `sgm_select` (against the seven launches
   and `sweep_bwd_wta`) by events in turns, each fused one required
   faster; counts
   the labelling's kernel launches a call (profiler); requires that no
   fill of a tensor the size of S7 runs in a batch (profiler, with
   shapes); prints them beside the card's name and power limit.

The SAD and census_wta modes, each preset as it stands
(`PRESETS["tsukuba_sad"]` at Tsukuba's 288 x 384, D = 64, block 9;
`PRESETS["middlebury_census_wta"]` at Middlebury half size, 375 x 621,
D = 128), on 8 synthetic pairs each:

5. holds `sad_wta` and `wta_lr` against their plain versions at those
   geometries, with the presets' LR check off and with it on
   (disp12_max_diff = 1), on 8 frames in one launch and on one, and
   `wta_lr` also on the int32 SAD volume of block 13 at Tsukuba's; then
   `sad_wta` on one 288 x 4096 frame (the widest `sad_wta_fits` admits at
   block 9) and `wta_lr` on the census volume of 8 rows of 30,000 columns
   (past the 25,827 of its earlier design), LR off and on;
6. drives `api.match_batch` on each preset, and on tsukuba_sad with the LR
   check on, with the launch counters set to 0 just before each; requires
   `sad_wta` (and `dr_consistency` with the LR check), `census_cost_volume`
   and `wta_lr` to have launched; holds each output against the plain
   pipeline on the card; and requires a valid fraction and bad-2.0 against
   the synthetic ground truth within bars set below the plain pipeline's
   own figures (`MODES`); then drives tsukuba_sad at block 13 with the LR
   check through `sgbm_volume` + `select_and_refine` (an int32 volume),
   requires `wta_lr` to have launched and the plain pipeline's output;
7. times both kernels per launch, by CUDA events and by CUDA-graph
   replay (the device's time, without the host's per launch), their plain
   versions and bounds, each path at one frame per launch (the presets)
   and at 8, through `match_batch`, and the profiler's busy share.

The SGM volume route and the relayout kernels:

8. holds `transpose_hw` against its plain version on the volume route's
   full shapes (4 frames of 1988 x 2964, D = 128: the uint8 C and the int16
   S after the vertical sweeps), and `transpose_sum_hw` and
   `sgm_sweep_bidir` (column shifts (0, 1, -1) and (0,)) at the KITTI
   path's (4 frames of 375 x 1242), all `torch.equal`; times
   `sgm_sweep_bidir` by events and by CUDA-graph replay beside the
   function's byte bound and the floor of its one launch per shift;
9. drives `pipeline.sgbm_volume` + `select_and_refine` on 8 synthetic
   1988 x 2964 pairs under the unmodified `PRESETS["middlebury_sgm4"]`
   (4 paths, D = 128, speckle, median, 4 frames per set of launches) with
   the launch counters set to 0 just before; requires the census, sweep,
   transpose, `wta_lr`, labelling and median kernels to have launched and
   `sweep_bwd_wta` not; holds the output against the port's fused route on
   the same frames and against the plain pipeline on 2 frames (one at a
   time); requires a valid fraction and bad-2.0 within bars (`MIDDLEBURY`);
   prints both routes' ms per batch, the profiler's kernel times and the
   route's peak memory; times `census_cost_volume` and `sweep_bwd_wta`
   alone on one set of 4 frames, and `wta_lr` on the route's S of those
   frames (int16, LR check on), beside their byte bounds;
10. drives `kitti_sgm8` through `api.match_batch` with
   `kernels.sgm.BIDIR_VERT = True`, requires `sgm_sweep_bidir` (its s16x2
   build alone), `transpose_sum_hw` and `transpose_hw` to have launched and
   the output to equal the default route's (step 3), and times both
   routes;
11. drives `middlebury_sgm4` with P2 = 1000 (past the fused bound:
   paths * (census_bits + P2) >= 4096) at KITTI size through
   `api.match_batch`, requires the volume route (`transpose_hw` launched,
   `sweep_bwd_wta` not) and the plain pipeline's output; runs the same
   frames through the fused route, requires the same output (the bound is
   the JAX package's, not a limit of the port's fused route) and times
   both routes.

The gap fills and the bitonic speckle sort:

12. holds `dr_consistency_hits` (the LR check with the Hirschmueller fill's
   hits map) against its plain version on step 1's d_r and disparity (4
   frames of 375 x 1242, D = 128), and `bitonic_sort` on step 1's speckle
   labels of those frames (4 rows of 465,750, padded to 2^19): the pair
   sort (labels, pixel index) and the keys-only sort of index * 2 + bit,
   all `torch.equal`; times both by events and by CUDA-graph replay, and
   the hits kernel too; requires one sort of those rows to make at most
   15 kernel launches (the source's schedule, and the profiler's count of
   bitonic kernels in one call where it records device kernels);
13. drives `kitti_sgm8` with `fill_mode="hirschmuller"` and with
   `"background"` through `api.match_batch` on step 3's 8 pairs, with the
   launch counters set to 0 just before each; requires
   `dr_consistency_hits` (for "hirschmuller") to have launched, the plain
   pipeline's output (one volume per set of frames for both fills) and an
   invalid fraction below the unfilled run's; times both beside the
   unfilled path and each fill alone, and prints the fill's share of the
   batch; then holds the hits kernel against its plain version on 4 rows
   of 240,000 columns (`WIDE`, past the 232,448 its earlier design took)
   and drives `kitti_sgm8` with P2 = 1000 and "hirschmuller" on one frame
   that wide through `match_batch` (the volume route) and the fused
   route, each equal to the plain pipeline;
14. drives `tsukuba_sad` with `disp12_max_diff=1, fill_mode="hirschmuller"`
   (its 8 pairs of step 6's size) and `middlebury_sgm4` with P2 = 1000 and
   "hirschmuller" at KITTI size through `api.match_batch`: both take the
   volume route; requires `wta_lr` and the hits kernel to have launched
   and `sad_wta` / `sweep_bwd_wta` not, and the plain pipeline's output;
15. drives `kitti_sgm8` through `api.match_batch` with
   `ops.postproc.BITONIC_SPECKLE = True`, requires `bitonic_sort` to have
   launched and the output to equal the default route's (step 3), and
   times both routes, the two sorts and `torch.sort` of the same keys.

The SAD route past `sad_wta`'s limits and the width micro-benchmarks:

16. drives `tsukuba_sad` at block 37 on one 1988 x 2964 frame through
   `api.match_batch` (past `sad_wta`'s shared memory at that width, so
   the volume route), requires `wta_lr` to have launched and `sad_wta`
   not, and the plain pipeline's output; times it;
17. runs each of kernel 13's five micro-benchmarks once per mode or dtype
   with the counters set to 0 (their only path), holds every kernel
   against its plain version at the timing shapes (`torch.equal`), and
   times them by CUDA-graph replay: `sweep_micro` at `SWEEP_SHAPES` (µs
   per step, each mode's byte bound and whether it reaches half of it,
   the ratios of `swar_i8` and `bf16_i8` to `v32_i8`), on one warp's
   line at T = 376 (N = 1, two rows for the paired modes: the step
   chain's own floor, ns a step), and `v32_i8` at (1242, 1500) in turns
   with `sgm_sweep`'s E write form at KITTI F = 4, the same step and
   bytes; the chains at `CHAIN_SHAPES` (the rolls on both axes at
   both), lengths 64 and 512 differenced into ns per operation; the
   rolls' own floor, the same wrappers on one line ((1, 128) axis 1,
   (1248, 1) axis 0, (2, 128) bfloat16), whose marginal ns a step must
   reach `ROLL_FLOOR_NS` (a chain folded into one roll reads about 0);
   the add/min chains' floor, each on one warp's values, whose marginal
   ns a step must reach `CHAIN_FLOOR_NS`; each add/min chain kernel's
   loop in the SASS of the library built here, which must issue at least
   the JAX body's operations a step on its words (`chain_sass.CHAIN_OPS`:
   a chain folded across steps issues fewer), and each chain's issue
   bound at (1248, 128) (those warp-instructions a step, times the plan's
   warps and the chain, over the card's SMs x 4 schedulers at one a
   clock); times each chain's library call,
   one `torch.roll` by the chain's sum (in turns with the kernel, medians
   of 3) or one `torch.add` of its closed form, held `torch.equal` to
   the kernel; prints the two axes that row 13c averages. Prints the
   share of the run both steps take (`steps 16-17: ... s`).

Adaptive P2 (`adaptive_p2=True`, the per-pixel P2' of the left image):

18. holds the adaptive `sgm_sweep` (both forms, all eight directions) and
   the adaptive `sweep_bwd_wta` against their plain versions at the KITTI
   path's shapes (`torch.equal`; disparity within 1e-6); drives
   `kitti_sgm8` with `adaptive_p2=True` through `api.match_batch` on step
   3's 8 pairs with the counters set to 0 just before, and again under
   `BIDIR_VERT`: requires the seven kernels, the adaptive builds alone (2
   adaptive writes and 2 adaptive adds of `sgm_sweep_fused`, 2 adaptive
   adds of `sgm_sweep`, the E sweep, 2 adaptive `sweep_bwd_wta`) and no
   `sgm_sweep_bidir` or transpose in either run,
   the same output, the plain pipeline's output and step 3's bar against
   the synthetic truth (valid > 0.9, bad-2.0 < 0.05, which the plain
   pipeline meets); times each direction and form by CUDA-graph replay,
   adaptive beside scalar (in turns) and beside its byte bound with the
   image byte, `sweep_bwd_wta` adaptive and scalar at KITTI and Middlebury
   F = 4, and the batch of 8 both ways; drives `middlebury_sgm4` with
   `adaptive_p2=True` on step 9's 8 frames of 1988 x 2964 through
   `sgbm_volume` + `select_and_refine` (adaptive builds alone, E and W on
   the transposed image), against the fused route on the same frames and
   the plain pipeline on one, with `MIDDLEBURY`'s bar, and times both
   routes adaptive and scalar. Prints `step 18: ... s`.

Stereo odometry over `PRESETS["kitti_odometry"]` with `strips=1` (D = 128,
8 paths, speckle 100, range 2, the median) at KITTI odometry size,
376 x 1241, with sequence 00's focal length and baseline:

19. drives `api.run_sequence` over a straight 32-frame synthetic sequence
   with the counters set to 0 just before, requires the seven kernels' counts
   of one set of frames (step 3) times the 32 matcher calls and no other
   kernel, and the JAX unit test's bars (final position error < 0.2 x the
   distance travelled, final x > 0.6 x the true x); repeats the JAX
   out-and-back loop-closure test at this size (a closure with a gap of at
   least 6 keyframes, and an endpoint within max(0.05, 1.05 x) of the run
   without closures); holds `fused_track_from_disp` on the card against
   the CPU on 3 frames (the same inputs: corners to 1e-6 px, descriptors
   1e-5, T 1e-4, equal match counts), `optimize_poses` on the straight
   run's graph, and `fused_track_frames` at F = 4 against 4 single steps;
   counts the host synchronisations of one tracked step (none from
   `odometry/` but its one transfer); times a tracked frame (matcher and
   tracking core), the run's host clock, `fused_track_frames` per frame,
   one `PoseGraph.optimize` and the busy share. Prints `step 19: ... s`.

The strip-tiled matcher (`dist/`, BASELINE config 5) with
`PRESETS["kitti_odometry"]` as shipped (halo mode, 2 strips, halo 32) and
in exact mode, at 376 x 1241, D = 128:

20. holds `sgm_sweep`'s carry forms against their plain version on two
   frames' census volume (the six y-scanning directions, write and add,
   scalar and adaptive P2, random q carries), and the kernel chained over
   2 and 4 strips against one launch, bit for bit; the same for
   `sgm_sweep_fused`'s carry forms (the down and up sets, random (3, B,
   W, D) q carries); drives
   `dist.sgbm_tiled_batched` on 8 synthetic pairs of that size in halo
   mode against the plain composition on the card (`plain_tiled`; no
   kernel runs in it), with step 3's bar, and `api.match_pair_tiled` on
   one; exact mode at 2 and 4 strips against the untiled `sgbm` (invalid
   pattern exact, disparity within 1e-6) with the ring on the fused carry
   forms (exactly one launch a scan order a strip, the down set written
   and the up set added, and E the one `sgm_sweep`); `api.run_sequence`
   over step 19's straight run with the preset as shipped, with the
   counters set to 0 just before (the seven kernels'
   counts of one set of frames times 32, nothing else), the bars of step
   19 and, against its strips=1 run, 0.02 m and 0.01 (the JAX
   `test_odometry_tiled.py` bars), and one host synchronisation of a
   tracked step (from `odometry/`; none from `dist/`); times one frame
   through each mode and the untiled `sgbm` by events, with its launches
   and the profiler's busy share, and the carry forms of a launch (the
   one-direction add and the fused down set's) on one 192-row strip by
   graph replay beside the same launch without one. Prints `step 20:
   ... s`.

The user's entry points (`cli`, `eval.bench`, `eval.roofline`,
`eval.runner`, `bench`, `data.io`), at full width:

21. writes 8 synthetic pairs of 375 x 1242 as PNGs with the port's codec
   (decoded equal to the arrays written) and runs `match --preset
   kitti_sgm8` on each through `cli.main`, to a .pfm (equal to
   `api.match_pair` on the decoded arrays bit for bit) and a .png (the
   KITTI encoding of it); runs `eval.bench.run_benchmark` on the four
   presets at their BASELINE shapes (kitti_sgm8 375 x 1242 with the
   stage table, middlebury_sgm4 1988 x 2964, tsukuba_sad 288 x 384,
   middlebury_census_wta 375 x 621) at B = 8, and
   `run_odometry_benchmark` on `kitti_odometry` untiled and tiled over
   `make_mesh(1, 2)`, each in three turns (the last profiled), and
   `python -m tpustereo_torch.bench`'s `main` at its defaults; prints
   each record beside the card's name, requires every roofline share in
   (0, 1], a busy share from kitti_sgm8's profile (`device_busy_fraction`
   of its Chrome trace, held to the wrappers' launch count), and each
   record's ms a frame (the turns' median) within a factor of 2 of the
   same work on the same inputs timed by the host clock beside it and
   of its path's events time in its earlier step (4, 7, 9, 19 or 19 +
   20; the median of three loops there), both ratios printed; holds
   `evaluate(synthetic=True)` on the card against the CPU's plain
   pipeline on the same 192 x 320 cases (equal per-pair metrics); runs
   `odometry` through `cli.main` over a KITTI tree of step 19's first 10
   frames, stopped after 5 and resumed from its checkpoint, against the
   uninterrupted run (within the JAX resume test's 1e-5) and against
   `api.run_sequence`; times `read_image_gray` on the committed libpng
   adaptive-filter frame (`tests/data/adaptive_image_0.png`, Paeth rows)
   beside the port's filter-None copy of it, and the CLI's ms a frame
   with prefetch 0 and 2 over that tree and over a static tree of the
   committed pair (30 frames), beside `api.run_sequence` on the arrays
   (each CLI run equal to the arrays' run), over the files decoded by
   `prefetch_pairs` (a thread) and by a forked worker process, and on the
   arrays beside the C unfilter looping in a thread and in a process of
   its own (the median of 3 rounds in turns), with the host's usable CPUs
   and CPU quota and the forked worker's first pair; requires the
   adaptive tree at prefetch 2 to be no slower than at prefetch 0 and
   prints the ratios to the arrays; the CLI at prefetch 2 and
   `run_sequence` over `prefetch_pairs` of the same files also stamp each
   tracked step, and the CLI's surplus prints split into a per-run part
   (up to the first step and after the last) and a per-frame part (in the
   steps and between them), each case beside the cyclic collector's
   pauses in it.
   Prints `step 21: ... s`.

Several ranks, one process each (`torch.distributed`; the kernels are
built before any rank starts):

22. on the one card, `gloo` ranks sharing it: 2 ranks run `kitti_odometry`
   as shipped (halo mode, 2 strips) and in exact mode on step 20's 8 pairs
   of 376 x 1241, `kitti_sgm8` data-parallel on step 3's 8 pairs over
   (data 2, strip 1), `wta_disparity_sharded` with
   `middlebury_census_wta` over 2 strips on one of them, and
   `api.run_sequence` over step 19's 32 frames on a 2-rank mesh; 4 ranks
   run exact mode over 4 strips and halo mode over (data 2, strip 2).
   Every rank's output equals the one-process port's bit for bit (step
   20's halo output, the untiled output, step 3's output, the
   one-process sharded WTA, step 20's tiled trajectory). Prints, per
   call, rank 0's `dist.comm` messages and kB a frame and each rank's ms
   a frame (CUDA events; the odometry by the host clock), labelled as
   ranks sharing one card, not scaling; requires the seven KITTI kernels
   on the 2-rank halo path and, on each exact call, one (3, F, W, D)
   carry message from rank 0. Where the machine has two cards, the 2-rank
   checks run again under `nccl`, one rank a card; else one line says
   that phase needs two cards. Then `eval.multihost.run_multihost_bench(2,
   tiled=True)` at 376 x 1241 (2 ranks a host, so 2 then 4 ranks on the
   card), its record's arithmetic checked. Prints `step 22: ... s`.

The evaluation surface, against the golden SGBM (`golden.sgbm_numpy`, on
the host) and the JAX package's stored records, read and never written:

23. (a) `eval.matrix.run_matrix` on the card: the 13 rows of
   `scripts/gen_eval_md.py`, 3 pairs each. On every pair the card's
   invalid pattern equals the golden's and max |card - golden| <= 1e-6
   (printed whether exactly 0.0); each row's mean equals
   `scripts/eval_head.json`'s (D1-all, bad-2.0 and bad-1.0 at its 5
   decimals, EPE within 1e-4; where one differs, the pixels where card and
   golden fall on either side of a threshold are printed). Prints each
   row's kernel launches and the table; requires the ten kernels the rows
   reach to have launched. (b) The 10 points of
   `tests/test_pinned_metrics.py`'s `SUITE`, read from its source, through
   `api.match_pair`: within its `RATE_TOL` / `EPE_TOL` of
   `tests/data/pinned_metrics.json`, the CPU's invalid pattern and
   disparity within 1e-6. (c) The `EVAL.md` KITTI 2015 recipe, `cli eval
   --preset kitti_sgm8 --kitti2015 ROOT --indices 0-1 --golden --record`,
   over a tree of 2 PNG pairs and uint16 x 256 truths at 375 x 1242: each
   pair within 1e-6 of the golden with its invalid pattern, its metrics
   the golden's. (d) The Middlebury recipe over one 1988 x 2964 scene
   (`im0.png`, `im1.png`, `disp0GT.pfm`): the disparity equal to
   `api.match_pair` on the decoded arrays bit for bit, then `--half-res
   --golden` held as in (c). (e) `python -m tpustereo_torch.cli odometry`
   over a 60-frame KITTI tree at 376 x 1241, SIGKILLed as soon as its
   first checkpoint exists, resumed: the trajectory within 1e-5 of the
   uninterrupted run. Prints each part's seconds and `step 23: ... s`.

The timers (`cuda_ms`, `graph_ms`), the profiler's busy share
(`device_busy`) and each kernel's bound (`bound`: bytes over 3.35 TB/s or
integer operations over 67e12/s, the larger) are the harness's and the
roofline's (`eval/bench.py`, `eval/roofline.py`).

Prints a `{"kernels": [...]}` line with all nineteen kernels, every TPU
kernel's port (the launches of the KITTI seven from step 3, those of
`sad_wta` and `wta_lr` from their presets' runs in step 6,
`transpose_hw`'s from step 9, `transpose_sum_hw`'s and `sgm_sweep_bidir`'s
from step 10, `dr_consistency_hits`'s from step 13, `bitonic_sort`'s from
step 15 and kernel 13's five from step 17; `sgm_sweep`,
`sgm_sweep_fused` and `sweep_bwd_wta` also carry `adaptive_launches` and
`adaptive_ms` from step 18, the KITTI seven `odometry_launches` from step
19 and
`tiled_launches` from step 20, and `sgm_sweep` and `sgm_sweep_fused`
their carry forms' `carry_launches` (exact mode, 2 strips, 8 frames:
the fused ones with 8 paths), `carry_ms`, `carry_bound_ms` and
`carry_max_abs_err` from step 20, and the KITTI
six `multirank_launches_per_frame`, rank 0's launches a frame on step
22's 2-rank halo path), then
`{"ok": true, "device": ...}` as the last line. Exits non-zero, with no
result, on any failure or when CUDA is absent. Needs no network; imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the timers, the busy share and the H100 bound (3.35 TB/s, 67e12
# operations/s) are the harness's and the roofline's own
from tpustereo_torch.eval.bench import cuda_ms, device_busy, graph_ms
from tpustereo_torch.eval.roofline import bound

SHAPE = (375, 1242)
BATCH = 8
DISP_TOL = 1e-6

KERNELS = {
    "census_cost_volume": ("tpustereo_torch/csrc/census_cost.cu",
                           "tpustereo/kernels/cost_pallas.py:164"),
    "sgm_sweep": ("tpustereo_torch/csrc/sgm_sweep.cu",
                  "tpustereo/kernels/sgm_pallas.py:664"),
    "sgm_sweep_fused": ("tpustereo_torch/csrc/sgm_fused.cu",
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
# the volume route's kernels that no earlier path launches
VOLUME_KERNELS = {
    "transpose_hw": ("tpustereo_torch/csrc/transpose.cu",
                     "tpustereo/kernels/transpose_pallas.py:61"),
    "transpose_sum_hw": ("tpustereo_torch/csrc/transpose.cu",
                         "tpustereo/kernels/transpose_pallas.py:33"),
    "sgm_sweep_bidir": ("tpustereo_torch/csrc/sgm_bidir.cu",
                        "tpustereo/kernels/sgm_pallas.py:955"),
}
# the kernels of the fill and bitonic speckle paths
FILL_KERNELS = {
    "dr_consistency_hits": ("tpustereo_torch/csrc/lr_check.cu",
                            "tpustereo/kernels/lr_pallas.py:60"),
    "bitonic_sort": ("tpustereo_torch/csrc/bitonic.cu",
                     "tpustereo/kernels/bitonic_pallas.py:218"),
}
# kernel 13, the data-width micro-benchmarks: one row per JAX function
MICRO_KERNELS = {
    "sweep_micro": ("tpustereo_torch/csrc/width_micro.cu",
                    "tpustereo/kernels/width_micro.py:141"),
    "elem_chain_micro": ("tpustereo_torch/csrc/width_micro.cu",
                         "tpustereo/kernels/width_micro.py:198"),
    "roll_chain_micro": ("tpustereo_torch/csrc/width_micro.cu",
                         "tpustereo/kernels/width_micro.py:222"),
    "reg_chain_micro": ("tpustereo_torch/csrc/width_micro.cu",
                        "tpustereo/kernels/width_micro.py:253"),
    "bf16_roll_chain_micro": ("tpustereo_torch/csrc/width_micro.cu",
                              "tpustereo/kernels/width_micro.py:281"),
}
# (T, N) of the sweep micro: the JAX scripts' vertical-sweep slab
# (scripts/tpu_batch_r43b.py:79) and the KITTI path's E sweep (1,242
# columns of 4 frames x 375 rows)
SWEEP_SHAPES = {"r43b": (376, 1280), "kitti_E": (1242, 1500)}
# the chains' (N, D): the JAX scripts' slab (r43b.py:42), and one whose
# int32 chain fills every SM (132 x 2,048 threads of 4 values, twice over)
CHAIN_SHAPES = {"r43b": (1248, 128), "fill": (16896, 128)}
CHAINS = (64, 512)
# the least marginal ns a roll step of one line may read (step 17): the
# step's 1.5 shuffles (a roll by 1, then by 2) at the H100's published rate
# of one warp-wide shuffle a clock an SM, at its highest clock of 1.98 GHz;
# a chain folded into one roll reads about 0
ROLL_FLOOR_NS = 1.5 / 1.98
# the least marginal ns a step of an add/min chain on one warp's values may
# read (step 17): one warp-instruction, at one a clock a scheduler at 1.98
# GHz; a folded chain reads about 0
CHAIN_FLOOR_NS = 1 / 1.98
# middlebury_sgm4 at full size: (frame shape, synthetic disparity,
# valid-fraction floor, bad-2.0 ceiling), the bar the KITTI path keeps,
# below the plain pipeline's valid 0.980, bad-2.0 0.0023 on these pairs
MIDDLEBURY = ((1988, 2964), 60.0, 0.9, 0.05)
# (rows, columns) past the 232,448 bytes of shared memory a block may use,
# one byte a column in the hits kernel's earlier design
WIDE = (4, 240000)
# step 19: KITTI odometry sequences 00-02's frame size, sequence 00's focal
# length and baseline (calib.txt P0/P1), over a textured plane 8 m away and
# slanted by 0.35, so true disparities run about 33-62 px, inside D = 128;
# the camera moves 8 cm a frame along x
ODO_SHAPE = (376, 1241)
ODO_CAM = dict(depth=8.0, fx=718.856, baseline=0.537, slant=0.35)
ODO_STEP = 0.08
ODO_FRAMES = 32
# card against CPU on the same inputs: corners (the same elementwise float32
# operations and a stable sort on both), descriptors (a mean and a norm
# reduced in another order), T and 3D points (m and rad)
ODO_TOL = dict(pts=1e-6, desc=1e-5, X=1e-4, T=1e-4)
# step 23: the JAX package's stored evaluation records (read, never
# written), and the test file whose suite of pinned points is read
EVAL_RECORD = "scripts/eval_head.json"
PINNED_TESTS = "tests/test_pinned_metrics.py"
PINNED_RECORD = "tests/data/pinned_metrics.json"
# the kernels that the evaluation matrix's rows reach, each required to
# have launched
EVAL_KERNELS = ("census_cost_volume", "sgm_sweep", "sgm_sweep_fused",
                "sweep_bwd_wta", "dr_consistency", "dr_consistency_hits",
                "connected_component_labels", "median3", "wta_lr", "sad_wta")
# a row's mean EPE against the record's (its rates equal at 5 decimals)
EPE_MEAN_TOL = 1e-4
# the killed odometry's frames, the JAX test's 60: a shorter sequence
# could end before the kill lands
KILL_FRAMES = 60


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_kernels(fn) -> list:
    """Names of the device kernels that one call of fn() runs, in order,
    from `torch.profiler` (fn is called once untraced first). Two small
    fills run first in the traced span, because the profiler can miss the
    span's first kernel; their names are dropped. Empty when the profiler
    records no device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    pad = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        pad.fill_(0)
        pad.fill_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    # the pipeline's spans (`tpustereo_torch/trace.py`) also appear on the
    # device's timeline, as annotations that are no kernels
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("tps.")),
                 key=lambda e: e.time_range.start)
    names = [e.name for e in evs]
    while names and "fill" in names[0].lower():
        names.pop(0)
    return names


def volume_fills(fn, numel: int) -> list:
    """(op, shape) of each fill (`aten::fill_`, `aten::zero_`) that one
    call of fn() makes of a tensor of `numel` elements, from
    `torch.profiler`'s CPU ops with their shapes (fn is called once
    untraced first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) \
            as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.input_shapes[0]) for e in prof.events()
            if e.name in ("aten::fill_", "aten::zero_") and e.input_shapes
            and e.input_shapes[0]
            and int(np.prod(e.input_shapes[0])) == numel]


def host_ms(fn, reps: int) -> float:
    """Mean ms of fn() by the host clock around reps calls that end in
    `torch.cuda.synchronize()` (after one warm-up call): a timer of the
    work that shares nothing with the events'."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def median_ms(fn, reps: int, turns: int = 3) -> float:
    """The median of `turns` `cuda_ms` loops of reps calls: an events time
    of a host-bound path, whose loops a second apart differ up to 1.6x,
    as step 21 holds a harness record to it."""
    return float(np.median([cuda_ms(fn, reps) for _ in range(turns)]))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def int_err(a, b) -> int:
    """max |a - b| of two integer volumes, one frame at a time (int32 copies
    of a whole full-size volume would take tens of GB)."""
    return max(int((a[f].int() - b[f].int()).abs().max().item())
               for f in range(a.shape[0]))


def quality(out: np.ndarray, gts: np.ndarray):
    """(valid fraction, bad-2.0 over the ground truth's valid pixels)."""
    m = gts > 0
    bad2 = float(((np.abs(out - gts) > 2.0) | (out < 0))[m].mean())
    return float((out >= 0).mean()), bad2


def synthetic_pairs(shape, disparity: float, n: int):
    """n synthetic pairs of seeds 0..n-1 as (lefts, rights, gts) arrays,
    gts -1 where the truth is undefined; made in threads (a full-size
    Middlebury pair takes seconds of numpy)."""
    from tpustereo_torch.data import synthetic_pair
    with ThreadPoolExecutor(8) as ex:
        ps = list(ex.map(lambda s: synthetic_pair(shape, disparity=disparity,
                                                  seed=s), range(n)))
    return (np.stack([p[0] for p in ps]), np.stack([p[1] for p in ps]),
            np.stack([np.where(p[3], p[2], -1.0) for p in ps]))


def plain_pipeline(L, R, cfg, fills=None):
    """(F, H, W) frames through the JAX package's jnp formulation, ported:
    the mode's full cost volume (SGM: aggregated), `ops.wta`,
    `ops.lr_check` (true-unit d_R of the volume), plain speckle, the fill
    (hits by `ops.lr_hits_from_volume`) and the median. No kernel runs.
    With `fills`, a tuple of fill modes, returns {fill: output} for each,
    from one volume."""
    import torch
    from tpustereo_torch.kernels.cost import census_cost_volume_plain
    from tpustereo_torch.ops import (aggregate, fill_background,
                                     fill_hirschmuller, lr_check,
                                     lr_hits_from_volume, median3,
                                     sad_volume, speckle_frames, wta)
    D, d0 = cfg.num_disparities, cfg.min_disparity
    if cfg.mode == "sad":
        S = sad_volume(L, R, D, cfg.sad_block, d0)
    else:
        S = census_cost_volume_plain(L, R, D, cfg.max_census_cost,
                                     cfg.census_window, d0)
        if cfg.mode == "sgm":
            S = aggregate(S, cfg, L)
    disp, _, valid = wta(S, cfg)
    valid &= lr_check(S, disp, cfg)
    modes = (cfg.fill_mode,) if fills is None else fills
    hits = (lr_hits_from_volume(S, cfg) if "hirschmuller" in modes
            else None)
    del S
    gaps = torch.where(speckle_frames(disp, valid, cfg), disp, -1.0)
    outs = {}
    for fill in modes:
        out = gaps
        if fill == "background":
            out = fill_background(gaps)
        elif fill == "hirschmuller":
            out = fill_hirschmuller(gaps, hits)
        outs[fill] = median3(out) if cfg.median_filter else out
    return outs[cfg.fill_mode] if fills is None else outs


def modes_path(card: str, refs: dict) -> list:
    """The SAD and census_wta paths: each new kernel against its plain
    version at its preset's geometry, LR check off (the presets) and on;
    `api.match_batch` on each unmodified preset (and tsukuba_sad with the
    LR check) against the plain pipeline; then times. Records each
    preset's ms a frame by events in `refs`. Returns the two kernels' rows
    of the `kernels` line."""
    import torch
    from tpustereo_torch import PRESETS, api, kernels
    from tpustereo_torch.kernels.sad import sad_wta_plain
    from tpustereo_torch.kernels.wta import wta_lr_plain
    from tpustereo_torch.kernels.cost import census_cost_volume_plain
    from tpustereo_torch.ops import sad_volume
    from tpustereo_torch.pipeline import (select_and_refine, sgbm_batched,
                                          sgbm_volume)

    dev = torch.device("cuda")
    data = {}
    for name, (shape, d_true, _, _) in MODES.items():
        lefts, rights, gts = synthetic_pairs(shape, d_true, BATCH)
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
    # the int32 SAD volume of block 13 (costs up to 255 * 169), the volume
    # route's input in the sad mode
    sad13 = sad_cfg.replace(sad_block=13)
    L, R = data["tsukuba_sad"][3:]
    S32 = sad_volume(L, R, sad13.num_disparities, 13, sad13.min_disparity)
    for cfg in (sad13, sad13.replace(**lr_on)):
        disp, valid = kernels.wta_lr(S32, cfg)
        disp_p, valid_p = wta_lr_plain(S32, cfg)
        torch.cuda.synchronize()
        what = f"wta_lr (int32, max_diff {cfg.disp12_max_diff})"
        require(torch.equal(valid, valid_p), f"{what} valid differs")
        e = (disp - disp_p).abs().max().item()
        require(e <= DISP_TOL, f"{what} disp differs by {e}")
        err["wta_lr"] = max(err["wta_lr"], e)
    del disp_p, valid_p, S32
    # the widths of the earlier designs' limits: sad_wta at the widest that
    # sad_wta_fits admits at block 9, wta_lr past 25,827 columns
    Lw, Rw, _ = synthetic_pairs((288, 4096), 20.0, 1)
    Lw, Rw = torch.from_numpy(Lw).to(dev), torch.from_numpy(Rw).to(dev)
    for cfg in (sad_cfg, sad_cfg.replace(**lr_on)):
        disp, valid, d_r = kernels.sad_wta(Lw, Rw, cfg)
        disp_p, valid_p, d_r_p = sad_wta_plain(Lw, Rw, cfg)
        torch.cuda.synchronize()
        what = f"sad_wta (288 x 4096, max_diff {cfg.disp12_max_diff})"
        require(torch.equal(valid, valid_p), f"{what} valid differs")
        require((d_r is None and d_r_p is None)
                or torch.equal(d_r, d_r_p), f"{what} d_r differs")
        e = (disp - disp_p).abs().max().item()
        require(e <= DISP_TOL, f"{what} disp differs by {e}")
        err["sad_wta"] = max(err["sad_wta"], e)
    Lw, Rw, _ = synthetic_pairs((8, 30000), 40.0, 1)
    Lw, Rw = torch.from_numpy(Lw).to(dev), torch.from_numpy(Rw).to(dev)
    Cw = kernels.census_cost_volume(Lw, Rw, D, cw_cfg.max_census_cost,
                                    cw_cfg.census_window, d0)
    for cfg in (cw_cfg, cw_cfg.replace(**lr_on)):
        disp, valid = kernels.wta_lr(Cw, cfg)
        disp_p, valid_p = wta_lr_plain(Cw, cfg)
        torch.cuda.synchronize()
        what = f"wta_lr (8 x 30000, max_diff {cfg.disp12_max_diff})"
        require(torch.equal(valid, valid_p), f"{what} valid differs")
        e = (disp - disp_p).abs().max().item()
        require(e <= DISP_TOL, f"{what} disp differs by {e}")
        err["wta_lr"] = max(err["wta_lr"], e)
    del Lw, Rw, Cw, disp_p, valid_p, d_r_p
    for name, e in err.items():
        also = ("; also on an int32 volume and 8 x 30000" if name == "wta_lr"
                else "; also 288 x 4096")
        print(f"check {name}: max abs diff to plain = {e} (LR off and on, "
              f"{BATCH} frames and 1{also})", flush=True)

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
        vfrac, bad2 = quality(out, gts)
        print(f"{label} vs plain pipeline: max abs diff {path_err}; valid "
              f"fraction {vfrac:.4f}; bad-2.0 vs ground truth {bad2:.4f}",
              flush=True)
        _, _, v_min, bad_max = MODES[name]
        require(vfrac > v_min and bad2 < bad_max,
                f"{label} output is not a good disparity map")

    # the SAD volume route: block 13's int32 volume through wta_lr
    vcfg = sad13.replace(**lr_on)
    lefts, rights, gts, L, R = data["tsukuba_sad"]
    kernels.reset_launch_counts()
    out = select_and_refine(sgbm_volume(L, R, vcfg), vcfg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"tsukuba_sad block 13 volume route launches: {counts}", flush=True)
    require(counts["wta_lr"] > 0 and counts["sad_wta"] == 0,
            "the SAD volume route did not run wta_lr")
    ref = plain_pipeline(L, R, vcfg)
    require(torch.equal(out == -1.0, ref == -1.0),
            "SAD volume route invalid pattern differs from the plain pipeline")
    path_err = (out - ref).abs().max().item()
    require(path_err <= DISP_TOL, "SAD volume route disparity differs from "
            "the plain pipeline")
    print(f"tsukuba_sad block 13 volume route vs plain pipeline: max abs "
          f"diff {path_err}; valid fraction, bad-2.0: "
          f"{quality(out.cpu().numpy(), gts)}", flush=True)

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
    # device time of one-frame launches, which the event loop above hides
    # behind the host's time per launch
    g_ms = {"sad_wta": graph_ms(lambda: kernels.sad_wta(L1, R1, sad_cfg), 50),
            "wta_lr": graph_ms(lambda: kernels.wta_lr(C1, cw_cfg), 50)}
    g_lr = {
        "sad_wta": graph_ms(lambda: kernels.sad_wta(
            L1, R1, sad_cfg.replace(**lr_on)), 50),
        "wta_lr": graph_ms(lambda: kernels.wta_lr(
            C1, cw_cfg.replace(**lr_on)), 50)}
    print(f"[{card}] ms per launch of one frame by CUDA-graph replay: "
          f"{g_ms}; with the LR check on: {g_lr} (by events: {ms})",
          flush=True)
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
        refs[name] = median_ms(lambda: sgbm_batched(L, R, cfg), reps) / BATCH
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


def volume_path(card: str, kitti: dict) -> list:
    """Steps 8-11: the relayout kernels against their plain versions, the
    SGM volume route at full Middlebury size, the `BIDIR_VERT` route and
    the dispatch past the fused bound. `kitti` holds the KITTI path's
    frames, ground truth and output (step 3). Returns the three new
    kernels' rows of the `kernels` line."""
    import importlib

    import torch
    from tpustereo_torch import PRESETS, api, kernels
    from tpustereo_torch.kernels.sgm import sgm_sweep_bidir_plain
    from tpustereo_torch.kernels.transpose import (transpose_hw_plain,
                                                   transpose_sum_hw_plain)
    from tpustereo_torch.ops.sgm import DIRS_4
    from tpustereo_torch.pipeline import (select_and_refine, sgbm_batched,
                                          sgbm_volume)
    ksgm = importlib.import_module("tpustereo_torch.kernels.sgm")
    psgbm = importlib.import_module("tpustereo_torch.pipeline.sgbm")

    dev = torch.device("cuda")
    cfg = PRESETS["middlebury_sgm4"]
    kcfg = PRESETS["kitti_sgm8"]
    D, F, d0 = cfg.num_disparities, cfg.frames_per_step, cfg.min_disparity
    (H, W), d_true, v_min, bad_max = MIDDLEBURY
    t0 = time.perf_counter()
    lefts, rights, gts = synthetic_pairs((H, W), d_true, BATCH)
    print(f"{BATCH} synthetic {H}x{W} pairs made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kitti["middlebury"] = (lefts, rights, gts)   # for step 18
    L = torch.from_numpy(lefts).to(dev)
    R = torch.from_numpy(rights).to(dev)
    n = F * H * W * D
    err = dict.fromkeys(VOLUME_KERNELS, 0)
    ms, plain_ms, library_ms, bounds = {}, {}, {}, {}

    # --- 8. transpose_hw at the volume route's full shapes: the uint8 C and
    # the int16 S after the vertical sweeps
    C = kernels.census_cost_volume(L[:F], R[:F], D, cfg.max_census_cost,
                                   cfg.census_window, d0)
    S = kernels.sgm_sweep(C, None, 1, 0, cfg.p1, cfg.p2)
    kernels.sgm_sweep(C, S, -1, 0, cfg.p1, cfg.p2)
    tr = {}
    for name, x in (("C", C), ("S", S)):
        got, ref = kernels.transpose_hw(x), transpose_hw_plain(x)
        torch.cuda.synchronize()
        require(torch.equal(got, ref), f"transpose_hw differs from plain "
                f"on {name} {x.dtype} {tuple(x.shape)}")
        err["transpose_hw"] = max(err["transpose_hw"], int_err(got, ref))
        del got, ref
        tr[name] = (cuda_ms(lambda: kernels.transpose_hw(x), 5),
                    cuda_ms(lambda: transpose_hw_plain(x), 3),
                    cuda_ms(lambda: x.transpose(1, 2).contiguous(), 3),
                    bound(2 * x.numel() * x.element_size(), 0)[0])
    del C, S
    print(f"[{card}] transpose_hw at (F, H, W, D) = {(F, H, W, D)}, ms "
          f"(kernel, plain, .contiguous(), bound): uint8 C {tr['C']}; "
          f"int16 S {tr['S']}", flush=True)
    # the route's three launches per set of frames: C once, S twice
    ms["transpose_hw"], plain_ms["transpose_hw"], \
        library_ms["transpose_hw"], _ = (
            (c + 2 * s) / 3 for c, s in zip(tr["C"], tr["S"]))
    bounds["transpose_hw"] = bound((2 * n + 2 * 4 * n) / 3, 0)

    # transpose_sum_hw and sgm_sweep_bidir at the KITTI path's shapes
    p1, p2 = kcfg.p1, kcfg.p2
    Ck = kernels.census_cost_volume(kitti["L"][:F], kitti["R"][:F], D,
                                    kcfg.max_census_cost,
                                    kcfg.census_window, kcfg.min_disparity)
    nk, Ck_shape = Ck.numel(), Ck.shape
    dxs8 = (0, 1, -1)
    for dxs in ((0,), dxs8):   # the 8-path pair stays for transpose_sum_hw
        Sd, Su = kernels.sgm_sweep_bidir(Ck, dxs, p1, p2)
        Sd_p, Su_p = sgm_sweep_bidir_plain(Ck, dxs, p1, p2)
        torch.cuda.synchronize()
        require(torch.equal(Sd, Sd_p) and torch.equal(Su, Su_p),
                f"sgm_sweep_bidir {dxs} differs from plain")
        err["sgm_sweep_bidir"] = max(err["sgm_sweep_bidir"],
                                     int_err(Sd, Sd_p), int_err(Su, Su_p))
        del Sd_p, Su_p
    St = kernels.transpose_sum_hw(Sd, Su)
    St_p = transpose_sum_hw_plain(Sd, Su)
    torch.cuda.synchronize()
    require(torch.equal(St, St_p), "transpose_sum_hw differs from plain")
    err["transpose_sum_hw"] = int_err(St, St_p)
    del St_p
    for name, e in err.items():
        print(f"check {name}: max abs diff to plain = {e}", flush=True)

    # one PyTorch call computing transpose_sum_hw: an add of the two
    # transposed views into a contiguous output
    St_lib = torch.empty_like(St)
    ms["transpose_sum_hw"] = cuda_ms(
        lambda: kernels.transpose_sum_hw(Sd, Su), 10)
    plain_ms["transpose_sum_hw"] = cuda_ms(
        lambda: transpose_sum_hw_plain(Sd, Su), 5)
    library_ms["transpose_sum_hw"] = cuda_ms(
        lambda: torch.add(Sd.transpose(1, 2), Su.transpose(1, 2),
                          out=St_lib), 5)
    require(torch.equal(St_lib, St), "the library route of transpose_sum_hw "
            "differs")
    del St, St_lib
    # per launch: a call of three launches reads C once and writes Sd and
    # Su once (5 bytes per cost); ~9 integer ops per cost and chain
    ms["sgm_sweep_bidir"] = cuda_ms(
        lambda: kernels.sgm_sweep_bidir(Ck, dxs8, p1, p2), 5) / len(dxs8)
    # one call a replay: each call allocates Sd and Su, and a graph of
    # several would hold a set of them per call
    bidir_graph_ms = graph_ms(
        lambda: kernels.sgm_sweep_bidir(Ck, dxs8, p1, p2), 1) / len(dxs8)
    plain_ms["sgm_sweep_bidir"] = cuda_ms(
        lambda: sgm_sweep_bidir_plain(Ck, dxs8, p1, p2), 1,
        warmup=0) / len(dxs8)
    library_ms["sgm_sweep_bidir"] = None
    del Ck, Sd, Su
    # two int16 volumes read, one written; one add per cost
    bounds["transpose_sum_hw"] = bound(6 * nk, nk)
    bounds["sgm_sweep_bidir"] = bound(5 * nk / len(dxs8), 2 * 9 * nk)
    # the floor of one launch per dx: the first writes Sd and Su, each
    # later one also reads them, and each of the two lines reads all of C
    # (6, then 10 bytes per cost; 5 and 9 if C were read once a launch)
    def floor_ms(c_reads):
        return (bound((c_reads + 4) * nk, 0)[0]
                + (len(dxs8) - 1) * bound((c_reads + 8) * nk, 0)[0]
                ) / len(dxs8)
    print(f"[{card}] sgm_sweep_bidir at (B, H, W, D) = {tuple(Ck_shape)}, "
          f"dxs {dxs8}, ms per launch: events {ms['sgm_sweep_bidir']:.4f}, "
          f"graph replay {bidir_graph_ms:.4f}; the function's byte bound "
          f"{bounds['sgm_sweep_bidir'][0]:.4f}, the one-launch-per-dx "
          f"floor {floor_ms(2):.4f} ({floor_ms(1):.4f} with C read once a "
          f"launch)", flush=True)

    # --- 9. the volume route at full width, through the user's entry points
    def volume_route():
        return torch.cat([select_and_refine(
            sgbm_volume(L[i:i + F], R[i:i + F], cfg), cfg)
            for i in range(0, BATCH, F)])

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = volume_route()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak_gib = (torch.cuda.max_memory_allocated() - resident) / 2**30
    print(f"middlebury_sgm4 volume route launches: {launches}", flush=True)
    for k in ("census_cost_volume", "sgm_sweep", "transpose_hw", "wta_lr",
              "connected_component_labels", "median3"):
        require(launches[k] > 0, f"{k} was not launched on the volume route")
    require(launches["sweep_bwd_wta"] == 0,
            "the volume route ran the fused backward sweep")
    out = out.cpu().numpy()
    require(out.shape == (BATCH, H, W) and np.isfinite(out).all(),
            "volume route output has the wrong shape or non-finite values")
    torch.cuda.reset_peak_memory_stats()
    fused = sgbm_batched(L, R, cfg).cpu().numpy()
    fused_peak_gib = (torch.cuda.max_memory_allocated() - resident) / 2**30
    require(np.array_equal(out == -1.0, fused == -1.0),
            "volume route invalid pattern differs from the fused route")
    fused_err = float(np.abs(out - fused).max())
    require(fused_err <= DISP_TOL, "volume route disparity differs from "
            "the fused route")
    del fused
    t0 = time.perf_counter()
    ref = np.concatenate([plain_pipeline(L[i:i + 1], R[i:i + 1], cfg)
                          .cpu().numpy() for i in range(2)])
    plain_s = time.perf_counter() - t0
    require(np.array_equal(out[:2] == -1.0, ref == -1.0),
            "volume route invalid pattern differs from the plain pipeline")
    plain_err = float(np.abs(out[:2] - ref).max())
    require(plain_err <= DISP_TOL, "volume route disparity differs from the "
            "plain pipeline")
    vfrac, bad2 = quality(out, gts)
    p_vfrac, p_bad2 = quality(ref, gts[:2])
    print(f"middlebury_sgm4 volume route vs fused route: max abs diff "
          f"{fused_err}; vs plain pipeline (2 frames, {plain_s:.1f} s): "
          f"{plain_err}; valid fraction {vfrac:.4f}, bad-2.0 {bad2:.4f} "
          f"(plain pipeline's 2 frames: {p_vfrac:.4f}, {p_bad2:.4f})",
          flush=True)
    require(vfrac > v_min and bad2 < bad_max,
            "volume route output is not a good disparity map")
    vol_ms = cuda_ms(volume_route, 3)
    fused_ms = cuda_ms(lambda: sgbm_batched(L, R, cfg), 3)
    kitti["refs"]["middlebury_sgm4"] = fused_ms / BATCH
    # bytes per cost each route must move: census 1, 3 for the first
    # sweep (it writes S) and 5 for each later one, then the volume
    # route's three transposes (C 2, S 4 + 4) and wta_lr's read of S (2),
    # or the fused route's bwd+WTA read of C and S7 (3)
    costs = BATCH * H * W * D
    vol_bound = bound(costs * (1 + 3 + 3 * 5 + 10 + 2), 0)[0]
    fused_bound = bound(costs * (1 + 3 + 2 * 5 + 3), 0)[0]
    print(f"[{card}] middlebury_sgm4 {H}x{W}, D={D}, F={F}, batch of "
          f"{BATCH} on device tensors: volume route {vol_ms:.3f} ms "
          f"({BATCH * 1e3 / vol_ms:.2f} frames/s; byte bound "
          f"{vol_bound:.3f}), fused route {fused_ms:.3f} ms "
          f"({BATCH * 1e3 / fused_ms:.2f} frames/s; byte bound "
          f"{fused_bound:.3f}), ratio {vol_ms / fused_ms:.3f}; peak memory "
          f"{peak_gib:.2f} GiB (volume) and {fused_peak_gib:.2f} GiB "
          f"(fused)", flush=True)
    print(f"[{card}] volume route profiler, one batch: "
          f"{device_busy(volume_route)}", flush=True)
    print(f"[{card}] fused route profiler, one batch: "
          f"{device_busy(lambda: sgbm_batched(L, R, cfg))}", flush=True)
    counts = {"transpose_hw": launches["transpose_hw"]}

    # the census and the fused backward sweep alone at this size (one set
    # of F frames; S7 from the other three paths), beside their byte bounds
    def census_m():
        return kernels.census_cost_volume(L[:F], R[:F], D, cfg.max_census_cost,
                                          cfg.census_window, d0)

    Cm = census_m()
    S7m = None
    for dy, dx in DIRS_4:
        if (dy, dx) != (0, -1):
            S7m = kernels.sgm_sweep(Cm, S7m, dy, dx, cfg.p1, cfg.p2)
    m_census = cuda_ms(census_m, 5)
    m_bwd = cuda_ms(lambda: kernels.sweep_bwd_wta(Cm, S7m, cfg), 3)
    del Cm, S7m
    # wta_lr on the volume route's S of one set of F frames (int16, the
    # preset's LR check on): S read once, disp and valid written
    Sm = sgbm_volume(L[:F], R[:F], cfg)
    m_wta = cuda_ms(lambda: kernels.wta_lr(Sm, cfg), 5)
    del Sm
    print(f"[{card}] middlebury_sgm4 {H}x{W}, D={D}, F={F}, ms per launch: "
          f"census_cost_volume {m_census:.4f} (byte bound "
          f"{bound(2 * F * H * W + n, 0)[0]:.4f}), sweep_bwd_wta "
          f"{m_bwd:.4f} (byte bound {bound(3 * n + 9 * F * H * W, 0)[0]:.4f}),"
          f" wta_lr {m_wta:.4f} (byte bound "
          f"{bound(2 * n + 5 * F * H * W, 0)[0]:.4f})", flush=True)
    del L, R

    # --- 10. the BIDIR_VERT route of kitti_sgm8 through match_batch
    Lk, Rk = kitti["L"], kitti["R"]
    kernels.reset_launch_counts()
    ksgm.BIDIR_VERT = True
    try:
        out_b = api.match_batch(kitti["lefts"], kitti["rights"], kcfg)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        bidir_builds = dict(kernels.sgm_sweep_bidir.builds)
        bidir_ms = cuda_ms(lambda: sgbm_batched(Lk, Rk, kcfg), 5)
    finally:
        ksgm.BIDIR_VERT = False
    default_ms = cuda_ms(lambda: sgbm_batched(Lk, Rk, kcfg), 5)
    print(f"kitti_sgm8 BIDIR_VERT route launches: {launches}; "
          f"sgm_sweep_bidir builds: {bidir_builds}", flush=True)
    for k in ("sgm_sweep_bidir", "transpose_sum_hw", "transpose_hw"):
        require(launches[k] > 0, f"{k} was not launched on the BIDIR_VERT "
                f"route")
    require(bidir_builds["s16x2"] == launches["sgm_sweep_bidir"],
            f"the BIDIR_VERT route did not run the s16x2 build of "
            f"sgm_sweep_bidir alone: {bidir_builds}")
    require(np.array_equal(out_b, kitti["out"]),
            "the BIDIR_VERT route's output differs from the default route's")
    print(f"[{card}] kitti_sgm8 batch of {BATCH}: BIDIR_VERT route "
          f"{bidir_ms:.3f} ms, default route {default_ms:.3f} ms; outputs "
          f"equal", flush=True)
    counts.update(sgm_sweep_bidir=launches["sgm_sweep_bidir"],
                  transpose_sum_hw=launches["transpose_sum_hw"])

    # --- 11. past the fused bound: middlebury_sgm4 with P2 = 1000 at KITTI
    # size, through match_batch
    pcfg = cfg.replace(p2=1000)
    kernels.reset_launch_counts()
    out_p = api.match_batch(kitti["lefts"], kitti["rights"], pcfg)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"middlebury_sgm4 P2=1000 launches: {launches}", flush=True)
    require(launches["transpose_hw"] > 0 and launches["sweep_bwd_wta"] == 0,
            "P2=1000 did not take the volume route")
    ref = np.concatenate([plain_pipeline(Lk[i:i + F], Rk[i:i + F], pcfg)
                          .cpu().numpy() for i in range(0, BATCH, F)])
    require(np.array_equal(out_p == -1.0, ref == -1.0),
            "P2=1000 invalid pattern differs from the plain pipeline")
    p_err = float(np.abs(out_p - ref).max())
    require(p_err <= DISP_TOL, "P2=1000 disparity differs from the plain "
            "pipeline")
    print(f"middlebury_sgm4 P2=1000 at KITTI size vs plain pipeline: max abs "
          f"diff {p_err}; valid fraction, bad-2.0: "
          f"{quality(out_p, kitti['gts'])}", flush=True)

    # the same frames through the fused route, which the dispatch leaves
    # only to keep the JAX package's route: same output, and what the
    # volume route costs here
    def fused_p():
        return torch.cat([psgbm._postproc(*psgbm._select(
            Lk[i:i + F], Rk[i:i + F], pcfg), pcfg)
            for i in range(0, BATCH, F)])

    kernels.reset_launch_counts()
    out_f = fused_p().cpu().numpy()
    launches = kernels.launch_counts()
    require(launches["sweep_bwd_wta"] > 0 and launches["transpose_hw"] == 0,
            "P2=1000 forced onto the fused route did not run it")
    require(np.array_equal(out_f, out_p), "P2=1000 fused route differs from "
            "the volume route")
    vol_p_ms = cuda_ms(lambda: sgbm_batched(Lk, Rk, pcfg), 5)
    fused_p_ms = cuda_ms(fused_p, 5)
    print(f"[{card}] middlebury_sgm4 P2=1000 at KITTI size, batch of "
          f"{BATCH}: volume route {vol_p_ms:.3f} ms, fused route "
          f"{fused_p_ms:.3f} ms (ratio {vol_p_ms / fused_p_ms:.3f}); outputs "
          f"equal", flush=True)

    rows = []
    for name, (src, replaces) in VOLUME_KERNELS.items():
        b_ms, b_by = bounds[name]
        print(f"[{card}] {name}: {ms[name]:.4f} ms/launch, {counts[name]} "
              f"launches per batch of {BATCH}, bound {b_ms:.4f} ms ({b_by}), "
              f"plain {plain_ms[name]:.3f} ms, library {library_ms[name]}",
              flush=True)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": err[name], "ms": ms[name],
                     "plain_ms": plain_ms[name], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms[name]})
    return rows


def fills_path(card: str, kitti: dict) -> list:
    """Steps 12-15: the hits kernel and the bitonic sort against their
    plain versions, `kitti_sgm8` with each fill, the volume route with the
    Hirschmueller fill, and `BITONIC_SPECKLE`. `kitti` holds the KITTI
    path's frames, ground truth and output (step 3), step 1's d_r,
    disparity, speckle labels and speckled map of the first set of frames,
    and the default route's ms per batch. Returns the two new kernels'
    rows of the `kernels` line."""
    import importlib

    import torch
    from tpustereo_torch import PRESETS, api, kernels
    from tpustereo_torch.kernels.bitonic import (bitonic_sort_plain,
                                                 kernel_launches, padded_log2)
    from tpustereo_torch.kernels.lr import dr_consistency_hits_plain
    from tpustereo_torch.ops import (component_big, component_big_sorted,
                                     fill_background, fill_hirschmuller)
    from tpustereo_torch.pipeline import sgbm_batched
    post = importlib.import_module("tpustereo_torch.ops.postproc")
    psgbm = importlib.import_module("tpustereo_torch.pipeline.sgbm")

    t_steps = time.perf_counter()
    dev = torch.device("cuda")
    cfg = PRESETS["kitti_sgm8"]
    D, F, d0 = cfg.num_disparities, cfg.frames_per_step, cfg.min_disparity
    md = cfg.disp12_max_diff
    H, W = SHAPE
    n_pix = F * H * W
    L, R = kitti["L"], kitti["R"]
    d_r, disp = kitti["d_r"], kitti["disp"]
    err = dict.fromkeys(FILL_KERNELS, 0)

    # --- 12. the hits kernel and the bitonic sort against their plain
    # versions at the KITTI path's shapes
    ok, hits = kernels.dr_consistency_hits(d_r, disp, D, md, d0)
    ok_p, hits_p = dr_consistency_hits_plain(d_r, disp, D, md, d0)
    torch.cuda.synchronize()
    require(torch.equal(ok, ok_p) and torch.equal(hits, hits_p),
            "dr_consistency_hits differs from plain")
    require(torch.equal(ok, kernels.dr_consistency(d_r, disp, D, md, d0)),
            "dr_consistency_hits' ok differs from dr_consistency")
    err["dr_consistency_hits"] = max(
        (ok.int() - ok_p.int()).abs().max().item(),
        (hits.int() - hits_p.int()).abs().max().item())
    n = H * W
    keys = kitti["lab"].reshape(F, n)
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(F, n)
    sk, sp = kernels.bitonic_sort(keys, idx)
    sk_p, sp_p = bitonic_sort_plain(keys, idx)
    torch.cuda.synchronize()
    require(torch.equal(sk, sk_p) and torch.equal(sp, sp_p),
            "bitonic_sort (pair) differs from plain")
    require(torch.equal(sk, keys.sort(dim=1).values),
            "bitonic_sort keys are not sorted")
    packed = sp * 2 + (sk & 1)     # distinct keys, as component_big makes
    out_k = kernels.bitonic_sort(packed)
    out_kp = bitonic_sort_plain(packed)
    torch.cuda.synchronize()
    require(torch.equal(out_k, out_kp), "bitonic_sort (keys) differs from "
            "plain")
    err["bitonic_sort"] = max(int((sp - sp_p).abs().max().item()),
                              int((out_k - out_kp).abs().max().item()))
    del sk_p, sp_p, out_kp
    for name, e in err.items():
        print(f"check {name}: max abs diff to plain = {e}", flush=True)

    ms = {"dr_consistency_hits": cuda_ms(
        lambda: kernels.dr_consistency_hits(d_r, disp, D, md, d0), 50)}
    plain_ms = {"dr_consistency_hits": cuda_ms(
        lambda: dr_consistency_hits_plain(d_r, disp, D, md, d0), 5)}
    library_ms = {"dr_consistency_hits": None}
    sort_ms = {
        "pair": (cuda_ms(lambda: kernels.bitonic_sort(keys, idx), 20),
                 cuda_ms(lambda: bitonic_sort_plain(keys, idx), 2),
                 cuda_ms(lambda: keys.sort(dim=1), 20)),
        "keys": (cuda_ms(lambda: kernels.bitonic_sort(packed), 20),
                 cuda_ms(lambda: bitonic_sort_plain(packed), 2),
                 cuda_ms(lambda: packed.sort(dim=1).values, 20))}
    # component_big_sorted makes one call of each: the row is their mean
    ms["bitonic_sort"], plain_ms["bitonic_sort"], \
        library_ms["bitonic_sort"] = (
            (a + b) / 2 for a, b in zip(sort_ms["pair"], sort_ms["keys"]))
    print(f"[{card}] bitonic_sort of ({F}, {n}) int32 keys, padded to "
          f"2^{padded_log2(n)}, ms (kernel, plain, torch.sort): pair "
          f"{sort_ms['pair']}; keys only {sort_ms['keys']}", flush=True)
    g_ms = {"dr_consistency_hits": graph_ms(
                lambda: kernels.dr_consistency_hits(d_r, disp, D, md, d0), 50),
            "bitonic_sort pair": graph_ms(
                lambda: kernels.bitonic_sort(keys, idx), 20),
            "bitonic_sort keys": graph_ms(
                lambda: kernels.bitonic_sort(packed), 20)}
    print(f"[{card}] ms per call by CUDA-graph replay (the sorts with "
          f"their pads): {g_ms}; the hits kernel by events "
          f"{ms['dr_consistency_hits']:.4f}", flush=True)
    n_launch = kernel_launches(n)
    traced = [k for k in device_kernels(
        lambda: kernels.bitonic_sort(keys, idx)) if "bitonic" in k]
    print(f"bitonic_sort of rows of {n}: {n_launch} kernel launches a sort "
          f"(the source's schedule); {len(traced)} bitonic kernels in one "
          f"traced call", flush=True)
    require(0 < n_launch <= 15, "one bitonic sort of the speckle rows makes "
            "more than 15 kernel launches")
    require(not traced or len(traced) == n_launch, "the traced bitonic "
            "kernels differ from the source's schedule")
    # what any sort of these rows needs, not the network's n2/2 * L(L+1)/2
    # exchanges (the mask `component_big_sorted` builds does not depend on
    # the network's tie order): each array read and written once, against
    # n * log2(n) compares a row, each a compare and a select per array;
    # the row is the mean of the pair sort (16 bytes, 5 ops) and the
    # keys-only sort (8 bytes, 3 ops)
    cmp = F * n * float(np.log2(n))
    bounds = {
        # d_r and disp read, ok and hits written; ~8 ops for the check and
        # 2 * max_diff + 1 flag stores per pixel
        "dr_consistency_hits": bound(10 * n_pix, (9 + 2 * md) * n_pix),
        "bitonic_sort": bound(12 * F * n, 4 * cmp),
    }
    lab = kitti["lab"]
    big_ms = cuda_ms(lambda: component_big(
        lab + torch.arange(0, n_pix, n, dtype=torch.int32,
                           device=dev).reshape(F, 1, 1),
        cfg.speckle_window_size), 20)
    def big_bitonic():
        return component_big_sorted(lab, cfg.speckle_window_size,
                                    kernels.bitonic_sort)

    big_bitonic_ms = cuda_ms(big_bitonic, 10)
    big_torch_ms = cuda_ms(lambda: component_big_sorted(
        lab, cfg.speckle_window_size), 10)
    print(f"[{card}] component_big per set of {F} frames: default (one "
          f"sort + searchsorted) {big_ms:.4f} ms; the sort formulation "
          f"with bitonic_sort {big_bitonic_ms:.4f} ms, with torch.sort "
          f"{big_torch_ms:.4f} ms", flush=True)
    print(f"[{card}] the sort formulation with bitonic_sort, profiler: "
          f"{device_busy(big_bitonic)}", flush=True)

    # --- 13. kitti_sgm8 with each fill, through the user's entry point
    t0 = time.perf_counter()
    refs = [plain_pipeline(L[i:i + F], R[i:i + F], cfg,
                           fills=("hirschmuller", "background"))
            for i in range(0, BATCH, F)]
    plain_s = time.perf_counter() - t0
    base_inv = float((kitti["out"] == -1.0).mean())
    base_ms = cuda_ms(lambda: sgbm_batched(L, R, cfg), 5)
    counts = {}
    for fill in ("hirschmuller", "background"):
        fcfg = cfg.replace(fill_mode=fill)
        kernels.reset_launch_counts()
        out = api.match_batch(kitti["lefts"], kitti["rights"], fcfg)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        print(f"kitti_sgm8 {fill} fill launches: {launches}", flush=True)
        lr_name = ("dr_consistency_hits" if fill == "hirschmuller"
                   else "dr_consistency")
        for k in (*KERNELS.keys() - {"dr_consistency"}, lr_name):
            require(launches[k] > 0, f"{k} was not launched on the kitti_sgm8 "
                    f"{fill} path")
        if fill == "hirschmuller":
            require(launches["dr_consistency"] == 0, "the hirschmuller path "
                    "ran the plain LR kernel")
            counts["dr_consistency_hits"] = launches["dr_consistency_hits"]
        require(out.shape == (BATCH, H, W) and np.isfinite(out).all(),
                f"{fill} output has the wrong shape or non-finite values")
        ref = np.concatenate([r[fill].cpu().numpy() for r in refs])
        require(np.array_equal(out == -1.0, ref == -1.0),
                f"{fill} invalid pattern differs from the plain pipeline")
        f_err = float(np.abs(out - ref).max())
        require(f_err <= DISP_TOL, f"{fill} disparity differs from the plain "
                f"pipeline")
        inv = float((out == -1.0).mean())
        require(inv < base_inv, f"the {fill} fill left no fewer invalid "
                f"pixels ({inv} against {base_inv})")
        f_ms = cuda_ms(lambda: sgbm_batched(L, R, fcfg), 5)
        print(f"[{card}] kitti_sgm8 {fill} fill vs plain pipeline: max abs "
              f"diff {f_err}; invalid fraction {inv:.5f} (unfilled "
              f"{base_inv:.5f}); valid fraction, bad-2.0: "
              f"{quality(out, kitti['gts'])}; {f_ms:.3f} ms per batch of "
              f"{BATCH} against {base_ms:.3f} unfilled: the fill stage's "
              f"share {(f_ms - base_ms) / f_ms:.4f}", flush=True)
    gaps = kitti["gaps"]
    fill_ms = {"hirschmuller": cuda_ms(lambda: fill_hirschmuller(gaps, hits),
                                       10),
               "background": cuda_ms(lambda: fill_background(gaps), 10)}
    print(f"[{card}] the fills alone per set of {F} frames: {fill_ms} ms; "
          f"plain pipeline for both fills: {plain_s:.1f} s", flush=True)
    print(f"[{card}] fill_hirschmuller profiler, one set of {F} frames: "
          f"{device_busy(lambda: fill_hirschmuller(gaps, hits))}", flush=True)
    hcfg = cfg.replace(fill_mode="hirschmuller")
    print(f"[{card}] kitti_sgm8 hirschmuller profiler, one batch: "
          f"{device_busy(lambda: sgbm_batched(L, R, hcfg))}", flush=True)

    # past the 232,448 columns of shared memory that the hits kernel's
    # earlier design kept a row in: the kernel on WIDE, then the fill on a
    # frame that wide through both routes (P2 = 1000 sends match_batch to
    # the volume route; the fused route runs the same frame)
    rng = np.random.default_rng(13)
    d_rw = torch.from_numpy(rng.integers(-3, D + 3, WIDE, dtype=np.int32)
                            ).to(dev)
    dispw = torch.from_numpy(rng.uniform(d0 - 0.5, d0 + D - 0.5, WIDE)
                             .astype(np.float32)).to(dev)
    okw, hitsw = kernels.dr_consistency_hits(d_rw, dispw, D, md, d0)
    okw_p, hitsw_p = dr_consistency_hits_plain(d_rw, dispw, D, md, d0)
    torch.cuda.synchronize()
    require(torch.equal(okw, okw_p) and torch.equal(hitsw, hitsw_p),
            f"dr_consistency_hits differs from plain at {WIDE}")
    wide_g = graph_ms(lambda: kernels.dr_consistency_hits(d_rw, dispw, D,
                                                          md, d0), 20)
    print(f"[{card}] dr_consistency_hits at {WIDE}: equal to plain; "
          f"{wide_g:.4f} ms by graph replay (byte bound "
          f"{bound(10 * d_rw.numel(), 0)[0]:.4f})", flush=True)
    del d_rw, dispw, okw, hitsw, okw_p, hitsw_p
    wcfg = hcfg.replace(p2=1000)
    lw, rw, _ = synthetic_pairs(WIDE, 40.0, 1)
    kernels.reset_launch_counts()
    out_v = api.match_batch(lw, rw, wcfg)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require(launches["dr_consistency_hits"] > 0 and launches["wta_lr"] > 0
            and launches["sweep_bwd_wta"] == 0, f"the fill at {WIDE} did "
            f"not take the volume route with the hits kernel: {launches}")
    Lw, Rw = torch.from_numpy(lw).to(dev), torch.from_numpy(rw).to(dev)
    kernels.reset_launch_counts()
    out_f = psgbm._postproc(*psgbm._select(Lw, Rw, wcfg), wcfg).cpu().numpy()
    launches = kernels.launch_counts()
    require(launches["dr_consistency_hits"] > 0
            and launches["sweep_bwd_wta"] > 0, f"the fill at {WIDE} did not "
            f"take the fused route with the hits kernel: {launches}")
    t0 = time.perf_counter()
    ref = plain_pipeline(Lw, Rw, wcfg).cpu().numpy()
    plain_s = time.perf_counter() - t0
    for route, o in (("volume", out_v), ("fused", out_f)):
        require(np.array_equal(o == -1.0, ref == -1.0), f"the fill at {WIDE} "
                f"on the {route} route: invalid pattern differs from plain")
        require(float(np.abs(o - ref).max()) <= DISP_TOL, f"the fill at "
                f"{WIDE} on the {route} route differs from plain")
    print(f"kitti_sgm8 P2=1000 hirschmuller at {WIDE}: volume and fused "
          f"routes equal to the plain pipeline ({plain_s:.1f} s); invalid "
          f"fraction {float((out_v == -1.0).mean()):.5f}", flush=True)
    del Lw, Rw

    # --- 14. the volume route with the Hirschmueller fill: tsukuba_sad with
    # the LR check, middlebury_sgm4 past the fused bound at KITTI size
    (Hs, Ws), d_sad = MODES["tsukuba_sad"][:2]
    lefts_s, rights_s, gts_s = synthetic_pairs((Hs, Ws), d_sad, BATCH)
    runs = [("tsukuba_sad", PRESETS["tsukuba_sad"], lefts_s, rights_s,
             gts_s, "sad_wta"),
            ("middlebury_sgm4 P2=1000", PRESETS["middlebury_sgm4"].replace(
                p2=1000), kitti["lefts"], kitti["rights"], kitti["gts"],
             "sweep_bwd_wta")]
    for label, vcfg, lefts, rights, gts, fused in runs:
        vcfg = vcfg.replace(disp12_max_diff=1, fill_mode="hirschmuller")
        kernels.reset_launch_counts()
        out = api.match_batch(lefts, rights, vcfg)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        print(f"{label} hirschmuller launches: {launches}", flush=True)
        require(launches["wta_lr"] > 0 and launches["dr_consistency_hits"] > 0
                and launches[fused] == 0, f"{label} hirschmuller did not "
                f"take the volume route")
        Lv = torch.from_numpy(lefts).to(dev)
        Rv = torch.from_numpy(rights).to(dev)
        step = vcfg.frames_per_step
        ref = np.concatenate([plain_pipeline(Lv[i:i + step], Rv[i:i + step],
                                             vcfg).cpu().numpy()
                              for i in range(0, BATCH, step)])
        require(np.array_equal(out == -1.0, ref == -1.0),
                f"{label} hirschmuller invalid pattern differs from the "
                f"plain pipeline")
        v_err = float(np.abs(out - ref).max())
        require(v_err <= DISP_TOL, f"{label} hirschmuller disparity differs "
                f"from the plain pipeline")
        print(f"{label} hirschmuller (volume route) vs plain pipeline: max "
              f"abs diff {v_err}; valid fraction, bad-2.0: "
              f"{quality(out, gts)}", flush=True)
        del Lv, Rv

    # --- 15. speckle through the bitonic sort
    kernels.reset_launch_counts()
    post.BITONIC_SPECKLE = True
    try:
        out_b = api.match_batch(kitti["lefts"], kitti["rights"], cfg)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        bitonic_ms = cuda_ms(lambda: sgbm_batched(L, R, cfg), 5)
    finally:
        post.BITONIC_SPECKLE = False
    default_ms = cuda_ms(lambda: sgbm_batched(L, R, cfg), 5)
    print(f"kitti_sgm8 BITONIC_SPECKLE launches: {launches}", flush=True)
    require(launches["bitonic_sort"] > 0, "bitonic_sort was not launched "
            "under BITONIC_SPECKLE")
    require(np.array_equal(out_b, kitti["out"]), "the BITONIC_SPECKLE "
            "route's output differs from the default route's")
    counts["bitonic_sort"] = launches["bitonic_sort"]
    print(f"[{card}] kitti_sgm8 batch of {BATCH}: BITONIC_SPECKLE "
          f"{bitonic_ms:.3f} ms, default route {default_ms:.3f} ms; outputs "
          f"equal", flush=True)

    rows = []
    for name, (src, replaces) in FILL_KERNELS.items():
        b_ms, b_by = bounds[name]
        print(f"[{card}] {name}: {ms[name]:.4f} ms/launch, {counts[name]} "
              f"launches per batch of {BATCH}, bound {b_ms:.4f} ms ({b_by}), "
              f"plain {plain_ms[name]:.3f} ms, library {library_ms[name]}",
              flush=True)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": err[name], "ms": ms[name],
                     "plain_ms": plain_ms[name], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms[name]})
    print(f"steps 12-15: {time.perf_counter() - t_steps:.1f} s", flush=True)
    return rows


def sad_wide_path(card: str) -> None:
    """Step 16: `tsukuba_sad` at block 37 on one Middlebury full-size frame,
    past `sad_wta`'s shared-memory limit, through `api.match_batch`: the
    volume route (`wta_lr` on the int32 SAD volume), equal to the plain
    pipeline."""
    import torch
    from tpustereo_torch import PRESETS, api, kernels
    from tpustereo_torch.kernels.sad import sad_wta_fits
    from tpustereo_torch.pipeline import sgbm_batched

    (H, W) = MIDDLEBURY[0]
    cfg = PRESETS["tsukuba_sad"].replace(sad_block=37)
    require(not sad_wta_fits(W, cfg.sad_block), "block 37 at the full "
            "Middlebury width should be past sad_wta's limit")
    lefts, rights, gts = synthetic_pairs((H, W), 30.0, 1)
    kernels.reset_launch_counts()
    out = api.match_batch(lefts, rights, cfg)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"tsukuba_sad block 37 at {H}x{W} launches: {launches}", flush=True)
    require(launches["wta_lr"] > 0 and launches["sad_wta"] == 0,
            "tsukuba_sad block 37 at full width did not take the volume route")
    require(out.shape == (1, H, W) and np.isfinite(out).all(),
            "tsukuba_sad block 37 output has the wrong shape or non-finite "
            "values")
    L = torch.from_numpy(lefts).cuda()
    R = torch.from_numpy(rights).cuda()
    ref = plain_pipeline(L, R, cfg).cpu().numpy()
    require(np.array_equal(out == -1.0, ref == -1.0), "tsukuba_sad block 37 "
            "invalid pattern differs from the plain pipeline")
    err = float(np.abs(out - ref).max())
    require(err <= DISP_TOL, "tsukuba_sad block 37 disparity differs from "
            "the plain pipeline")
    ms = cuda_ms(lambda: sgbm_batched(L, R, cfg), 3)
    print(f"[{card}] tsukuba_sad block 37 at {H}x{W} (volume route) vs plain "
          f"pipeline: max abs diff {err}; valid fraction, bad-2.0: "
          f"{quality(out, gts)}; {ms:.3f} ms a frame on device tensors",
          flush=True)


def micro_path(card: str) -> list:
    """Step 17: kernel 13. Drives each width micro-benchmark once per mode
    or dtype through its wrapper with the counters set to 0 (their only
    run: they are on no user's path), holds each kernel against its plain
    version at the timing shapes (`torch.equal`), then times them: the
    sweep at both `SWEEP_SHAPES`, µs per step and its byte bound, and the
    ratios of `swar_i8` and `bf16_i8` to `v32_i8`; the chains at both
    `CHAIN_SHAPES`, lengths 64 and 512 differenced into ns per operation,
    the rolls on one line (their floor, required above `ROLL_FLOOR_NS`),
    the add/min chains on one warp's values (theirs, above
    `CHAIN_FLOOR_NS`) and their issue bounds from the SASS, and each
    chain's library call (`torch.roll` in turns with the kernel); the
    sweep's one-line floor in each mode, and `v32_i8` in turns with
    `sgm_sweep`'s E write form. Returns the five rows of the `kernels`
    line (the sweep row with each mode's ms, byte bound and floor and
    the E comparison, the chain rows with their floors,
    `roll_chain_micro`'s with the ms of each axis, the add/min rows with
    their issue bounds and the ms of each dtype)."""
    import torch
    from tpustereo_torch import kernels
    from tpustereo_torch.bench.chain_sass import (ISSUE_HZ, chain_folds,
                                                  chain_issue, chain_least,
                                                  chain_sass, chain_unroll)
    from tpustereo_torch.kernels import _build
    from tpustereo_torch.kernels import width_micro as wm

    dev = torch.device("cuda")
    sms = wm._sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    p1, p2 = 10, 120
    sweeps = {}
    for key, (T, N) in SWEEP_SHAPES.items():
        C8 = torch.randint(0, 25, (T, N, wm.D_MICRO), generator=gen,
                           device=dev, dtype=torch.int8)
        C32 = C8.int()
        sweeps[key] = {"v32": C32, "swar": wm.pack_rows(C32), "v32_i8": C8,
                       "swar_i8": C8, "bf16_i8": C8}
    chains = {}
    for key, shape in CHAIN_SHAPES.items():
        xi = torch.randint(0, 200, shape, generator=gen, device=dev,
                           dtype=torch.int32)
        chains[key] = {torch.int32: xi, torch.int16: xi.short(),
                       torch.bfloat16: xi.bfloat16(),
                       torch.float32: xi.float()}
    elem_dts = (torch.int32, torch.int16, torch.bfloat16)

    def dname(dt):
        return str(dt).removeprefix("torch.")

    reg_dts = (torch.int32, torch.float32, torch.bfloat16, torch.int16)
    ch = CHAINS[-1]

    # the run: every mode and dtype once at the JAX scripts' shapes
    x = chains["r43b"]
    kernels.reset_launch_counts()
    for mode, C in sweeps["r43b"].items():
        wm.sweep_micro(C, mode, p1, p2)
    for dt in elem_dts:
        wm.elem_chain_micro(x[dt], ch)
    for dt in reg_dts:
        wm.reg_chain_micro(x[dt], ch)
    for axis in (1, 0):
        wm.roll_chain_micro(x[torch.int32], ch, axis=axis)
    wm.bf16_roll_chain_micro(x[torch.bfloat16], ch)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items()
              if k in MICRO_KERNELS}
    print(f"width micro launches: {counts}", flush=True)
    for k in MICRO_KERNELS:
        require(counts[k] > 0, f"{k} was not launched")

    # each kernel against its plain version at the timing shapes
    err = dict.fromkeys(MICRO_KERNELS, 0.0)

    def hold(name, got, ref, what):
        torch.cuda.synchronize()
        require(torch.equal(got, ref), f"{name} {what} differs from plain")
        err[name] = max(err[name], float((got.float() - ref.float())
                                         .abs().max().item()))

    for key, modes in sweeps.items():
        for mode, C in modes.items():
            ref = wm.sweep_micro_plain(C, mode, p1, p2)
            hold("sweep_micro", wm.sweep_micro(C, mode, p1, p2), ref,
                 f"{mode} at {key}")
            del ref
        a = wm.sweep_micro(modes["v32_i8"], "v32_i8", p1, p2)
        require(torch.equal(a, wm.sweep_micro(modes["bf16_i8"], "bf16_i8",
                                              p1, p2))
                and torch.equal(a, wm.sweep_micro(modes["swar_i8"],
                                                  "swar_i8", p1, p2)),
                f"the i8 modes disagree at {key}")
        del a
    for key, x in chains.items():
        for dt in elem_dts:
            hold("elem_chain_micro", wm.elem_chain_micro(x[dt], ch),
                 wm.elem_chain_micro_plain(x[dt], ch), f"{dt} at {key}")
        for dt in reg_dts:
            hold("reg_chain_micro", wm.reg_chain_micro(x[dt], ch),
                 wm.reg_chain_micro_plain(x[dt], ch), f"{dt} at {key}")
        for axis in (1, 0):
            hold("roll_chain_micro", wm.roll_chain_micro(
                x[torch.int32], ch, axis=axis), wm.roll_chain_micro_plain(
                x[torch.int32], ch, axis), f"axis {axis} at {key}")
        hold("bf16_roll_chain_micro",
             wm.bf16_roll_chain_micro(x[torch.bfloat16], ch),
             wm.bf16_roll_chain_micro_plain(x[torch.bfloat16], ch),
             f"at {key}")
    for name, e in err.items():
        print(f"check {name}: max abs diff to plain = {e}", flush=True)

    # --- timing, of device time (`graph_ms`): the sweep kernel alone (the
    # wrapper's domain check is a reduction and a sync)
    sw_ms, sw_bytes, sw_bound = {}, {}, {}
    for key, modes in sweeps.items():
        T = SWEEP_SHAPES[key][0]
        for mode, C in modes.items():
            sw_ms[key, mode] = graph_ms(
                lambda C=C, m=mode: wm._sweep_launch(C, m, p1, p2), 20)
            # C read once, L written once: 3 bytes a cost for the i8 modes,
            # 8 for v32, 4 for swar (two costs a word)
            sw_bytes[key, mode] = C.numel() * (
                C.element_size() + (2 if mode in wm.I8_MODES else 4))
            sw_bound[key, mode] = bound(sw_bytes[key, mode], 0)[0]
        line = "; ".join(
            f"{m} {ms:.4f} ms ({ms * 1e3 / T:.3f} us/step)"
            for (k, m), ms in sw_ms.items() if k == key)
        byte_ms = "; ".join(f"{m} {b:.4f}"
                            for (k, m), b in sw_bound.items() if k == key)
        print(f"[{card}] sweep_micro at (T, N, D) = "
              f"{(*SWEEP_SHAPES[key], wm.D_MICRO)}: {line}; byte bounds, "
              f"ms: {byte_ms}", flush=True)
    for key in sweeps:
        base = sw_ms[key, "v32_i8"]
        print(f"[{card}] width ratios at {key} {SWEEP_SHAPES[key]}: swar_i8 "
              f"(s16x2 + DPX) / v32_i8 = {sw_ms[key, 'swar_i8'] / base:.4f}; "
              f"bf16_i8 / v32_i8 = {sw_ms[key, 'bf16_i8'] / base:.4f}; "
              f"swar / v32 = {sw_ms[key, 'swar'] / sw_ms[key, 'v32']:.4f}",
              flush=True)
        print(f"[{card}] sweep_micro at {key}, ms over twice the byte bound "
              f"(at most 1 reaches half of it): " + "; ".join(
                  f"{m} {sw_ms[key, m] / (2 * sw_bound[key, m]):.4f}"
                  for m in sweeps[key]), flush=True)

    # the step chain's own floor: each mode on one warp's line (one row,
    # or two for the paired modes and swar's packing) at T = 376, whose
    # ns a step is one dependent step once the ring hides the loads (the
    # launch and the first load are in it too)
    T1 = SWEEP_SHAPES["r43b"][0]
    sw_floor = {}
    for mode in sweeps["r43b"]:
        rows = 1 if mode in ("v32", "v32_i8") else 2
        C8 = torch.randint(0, 25, (T1, rows, wm.D_MICRO), generator=gen,
                           device=dev, dtype=torch.int8)
        C = (C8 if mode in wm.I8_MODES else C8.int() if mode == "v32"
             else wm.pack_rows(C8.int()))
        hold("sweep_micro", wm.sweep_micro(C, mode, p1, p2),
             wm.sweep_micro_plain(C, mode, p1, p2), f"{mode} on one line")
        sw_floor[mode] = graph_ms(
            lambda C=C, m=mode: wm._sweep_launch(C, m, p1, p2), 20) * 1e6 / T1
    print(f"[{card}] sweep_micro on one warp's line, T = {T1}, ns a step: "
          + "; ".join(f"{m} {ns:.2f}" for m, ns in sw_floor.items())
          + "; T x floor, ms: " + "; ".join(
              f"{k} {m} {SWEEP_SHAPES[k][0] * sw_floor[m] * 1e-6:.4f}"
              for k in sweeps for m in sw_floor), flush=True)

    # v32_i8 at (1242, 1500) beside the shipped E sweep's write form at
    # KITTI F = 4 (1,500 lines of 1,242 pixels, D = 128: the same step,
    # sgm_step<4>, and the same 3 bytes a cost), in turns (micro, E, E,
    # micro), by graph replay
    Ck = torch.randint(0, 25, (4, 375, 1242, wm.D_MICRO), generator=gen,
                       device=dev, dtype=torch.uint8)
    C_e = sweeps["kitti_E"]["v32_i8"]
    e_turns = [graph_ms(fn, 20) for fn in (
        lambda: wm._sweep_launch(C_e, "v32_i8", p1, p2),
        lambda: kernels.sgm_sweep(Ck, None, 0, 1, p1, p2),
        lambda: kernels.sgm_sweep(Ck, None, 0, 1, p1, p2),
        lambda: wm._sweep_launch(C_e, "v32_i8", p1, p2))]
    del Ck
    e_cmp = {"v32_i8": (e_turns[0] + e_turns[3]) / 2,
             "sgm_sweep_E_write": (e_turns[1] + e_turns[2]) / 2}
    print(f"[{card}] v32_i8 at {SWEEP_SHAPES['kitti_E']} against sgm_sweep's "
          f"E write form at KITTI F = 4, in turns (micro, E, E, micro): "
          f"{[round(t, 4) for t in e_turns]} ms; ratio "
          f"{e_cmp['v32_i8'] / e_cmp['sgm_sweep_E_write']:.4f}", flush=True)

    def chain_ns(fn, x, ops):
        """(ms of each chain length, marginal ns per slab-wide operation)."""
        t = {c: graph_ms(lambda c=c: fn(x, c), 200) for c in CHAINS}
        lo, hi = CHAINS
        return t, (t[hi] - t[lo]) * 1e6 / ((hi - lo) * ops)

    ch_ms = {}
    for key, x in chains.items():
        res = {}
        for dt in elem_dts:
            res[f"elem {dname(dt)}"] = chain_ns(wm.elem_chain_micro, x[dt], 3)
        for dt in reg_dts:
            res[f"reg {dname(dt)}"] = chain_ns(wm.reg_chain_micro, x[dt], 3)
        for axis in (1, 0):
            res[f"roll axis {axis}"] = chain_ns(
                lambda v, c, a=axis: wm.roll_chain_micro(v, c, axis=a),
                x[torch.int32], 1)
        res["bf16 roll"] = chain_ns(wm.bf16_roll_chain_micro,
                                    x[torch.bfloat16], 1)
        ch_ms[key] = res
        print(f"[{card}] chains at (N, D) = {CHAIN_SHAPES[key]}, ms at "
              f"chain {CHAINS} and marginal ns per operation: "
              + "; ".join(f"{k} {tuple(round(v, 5) for v in t.values())} "
                          f"{ns:.4f} ns" for k, (t, ns) in res.items()),
              flush=True)
        ns = {k: v[1] for k, v in res.items()}
        ratios = {
            "elem int16/int32": ns["elem int16"] / ns["elem int32"],
            "elem bf16/int32": ns["elem bfloat16"] / ns["elem int32"],
            "reg int16/int32": ns["reg int16"] / ns["reg int32"],
            "reg bf16/int32": ns["reg bfloat16"] / ns["reg int32"],
            "roll/elem int32": ns["roll axis 1"] / ns["elem int32"],
            "bf16 roll/int32 roll": ns["bf16 roll"] / ns["roll axis 1"]}
        print(f"[{card}] chain ratios at {key}: "
              + ", ".join(f"{k} {r:.4f}" for k, r in ratios.items()),
              flush=True)

    # the chain's own floor: the same wrappers on one line, whose marginal
    # ns a step is what one line's dependent steps cost, a shuffle's
    # latency every E / 1.5 steps or one warp's issue of its 1.5 shuffles,
    # whichever is longer (a chain folded into one roll reads about 0)
    floor_ns = {}
    for label, shape, fn in (
            ("roll axis 1", (1, 128),
             lambda v, c: wm.roll_chain_micro(v, c, axis=1)),
            ("roll axis 0", (1248, 1),
             lambda v, c: wm.roll_chain_micro(v, c, axis=0)),
            ("bf16 roll", (2, 128), wm.bf16_roll_chain_micro)):
        xi = torch.randint(0, 200, shape, generator=gen, device=dev,
                           dtype=torch.int32)
        v = xi.bfloat16() if label == "bf16 roll" else xi
        t, ns = chain_ns(fn, v, 1)
        floor_ns[label] = ns
        print(f"[{card}] {label} on one line {shape}: ms at chain {CHAINS} "
              f"{tuple(round(ms, 5) for ms in t.values())}, marginal "
              f"{ns:.4f} ns a step", flush=True)
    for label, ns in floor_ns.items():
        require(ns >= ROLL_FLOOR_NS, f"{label} on one line: {ns:.4f} ns a "
                f"step < {ROLL_FLOOR_NS:.3f}: the chain does not step")

    # the add/min chains' floor: each on one warp's values (the plan's
    # words a thread x 32), whose marginal ns a step is one dependent
    # step's latency; a folded chain reads about 0
    chain_fns = {"elem": (wm.elem_chain_micro, elem_dts),
                 "reg": (wm.reg_chain_micro, reg_dts)}
    kinds = {"elem": wm._ELEM, "reg": wm._REG}
    chain_floor = {}
    for kname, (fn, dts) in chain_fns.items():
        for dt in dts:
            per = wm._values_per_word(dt)
            n = next(32 * w * per for w in wm.CHAIN_WORDS
                     if wm._chain_plan(32 * w * per, dt, kinds[kname],
                                       sms)[0] == w)
            v = torch.randint(0, 200, (1, n), generator=gen, device=dev,
                              dtype=torch.int32).to(dt)
            t, ns = chain_ns(fn, v, 1)
            chain_floor[f"{kname} {dname(dt)}"] = ns
            plan = wm._chain_plan(n, dt, kinds[kname], sms)
            print(f"[{card}] {kname} {dname(dt)} on one warp's values (1, "
                  f"{n}), plan {plan}: ms at chain {CHAINS} "
                  f"{tuple(round(ms, 5) for ms in t.values())}"
                  f", marginal {ns:.4f} ns a step", flush=True)
    for label, ns in chain_floor.items():
        require(ns >= CHAIN_FLOOR_NS, f"{label} on one warp: {ns:.4f} ns a "
                f"step < {CHAIN_FLOOR_NS:.3f}: the chain does not step")

    # each chain kernel's loop in the SASS of the library built here: every
    # one of them built, none issuing fewer warp-instructions a step than
    # the JAX body's operations on its words (a partial fold, which keeps
    # the outputs exact and may still pass the floor, issues fewer)
    lib = _build.load("width_micro", wm._SIGS)
    issue = chain_issue(chain_sass(_build.lib_path("width_micro")),
                        chain_unroll(lib))
    built = {f"chain {k} {dname(dt)} W{w}" for k, (_, dts) in chain_fns.items()
             for dt in dts for w in wm.CHAIN_WORDS}
    require(set(issue) == built, f"the chain kernels in the SASS "
            f"{sorted(issue)} are not those built {sorted(built)}")
    folds = chain_folds(issue)
    print(f"[{card}] chain loops, warp-instructions a step (the least): "
          + ", ".join(f"{k.removeprefix('chain ')} {v:g} ({chain_least(k)})"
                      for k, v in sorted(issue.items())), flush=True)
    require(not folds, f"chain loops issue fewer warp-instructions a step "
            f"than the JAX body's operations (a step, the least): {folds}")

    # each chain's issue bound at (1248, 128): those warp-instructions a
    # step x the warps of the plan x the chain, over the card's schedulers
    # at one a clock
    schedulers = sms * wm.SCHEDULERS
    x = chains["r43b"]
    n = x[torch.int32].numel()
    issue_ms = {}
    for kname, (fn, dts) in chain_fns.items():
        for dt in dts:
            words, threads, blocks = wm._chain_plan(n, dt, kinds[kname],
                                                    sms)
            per = wm._values_per_word(dt)
            warps = -(-n // (32 * words * per))
            step = issue[f"chain {kname} {dname(dt)} W{words}"]
            label = f"{kname} {dname(dt)}"
            issue_ms[label] = warps * ch * step / schedulers / ISSUE_HZ * 1e3
            b_ms, _ = bound(2 * n * x[dt].element_size(), 3 * ch * n)
            print(f"[{card}] {label} at {CHAIN_SHAPES['r43b']}, chain {ch}: "
                  f"{ch_ms['r43b'][label][0][ch]:.5f} ms; plan (words, "
                  f"threads, blocks) {(words, threads, blocks)}; issue bound "
                  f"{issue_ms[label]:.5f} ms ({step:g} warp-instructions a "
                  f"step x {warps} warps); 67e12 bound {b_ms:.5f} ms",
                  flush=True)

    # --- the rows: each function at the JAX scripts' shapes (the sweep
    # at r43b's, the mean of its five modes; a chain's at (1248, 128),
    # chain 512, the mean of its dtypes or axes)
    x = chains["r43b"]
    n = x[torch.int32].numel()
    mean = lambda vals: sum(vals) / len(vals)  # noqa: E731

    def chain_plain_ms(fn, *args):
        return cuda_ms(lambda: fn(*args), 1, warmup=0)

    sweep_modes = list(sweeps["r43b"])
    ms = {
        "sweep_micro": mean([sw_ms["r43b", m] for m in sweep_modes]),
        "elem_chain_micro": mean([ch_ms["r43b"][f"elem {dname(dt)}"][0][ch]
                                  for dt in elem_dts]),
        "reg_chain_micro": mean([ch_ms["r43b"][f"reg {dname(dt)}"][0][ch]
                                 for dt in reg_dts]),
        "roll_chain_micro": mean([ch_ms["r43b"][f"roll axis {a}"][0][ch]
                                  for a in (1, 0)]),
        "bf16_roll_chain_micro": ch_ms["r43b"]["bf16 roll"][0][ch],
    }
    plain_ms = {
        "sweep_micro": mean([chain_plain_ms(
            wm.sweep_micro_plain, sweeps["r43b"][m], m, p1, p2)
            for m in sweep_modes]),
        "elem_chain_micro": mean([chain_plain_ms(
            wm.elem_chain_micro_plain, x[dt], ch) for dt in elem_dts]),
        "reg_chain_micro": mean([chain_plain_ms(
            wm.reg_chain_micro_plain, x[dt], ch) for dt in reg_dts]),
        "roll_chain_micro": mean([chain_plain_ms(
            wm.roll_chain_micro_plain, x[torch.int32], ch, a)
            for a in (1, 0)]),
        "bf16_roll_chain_micro": chain_plain_ms(
            wm.bf16_roll_chain_micro_plain, x[torch.bfloat16], ch),
    }
    # a chain of rolls is one roll by their sum: torch.roll computes it,
    # timed in turns with the kernel (kernel, torch.roll, three rounds; the
    # medians)
    shift = sum(1 + (i & 1) for i in range(ch))
    library_ms = dict.fromkeys(MICRO_KERNELS)
    roll_turns = {}
    for label, v, a, fn in (
            ("axis 1", x[torch.int32], 1,
             lambda: wm.roll_chain_micro(x[torch.int32], ch, axis=1)),
            ("axis 0", x[torch.int32], 0,
             lambda: wm.roll_chain_micro(x[torch.int32], ch, axis=0)),
            ("bf16", x[torch.bfloat16], 1,
             lambda: wm.bf16_roll_chain_micro(x[torch.bfloat16], ch))):
        require(torch.equal(torch.roll(v, shift, dims=a), fn()),
                f"the roll chain ({label}) is not one roll by its sum")
        rounds = [(graph_ms(fn, 200), graph_ms(
            lambda v=v, a=a: torch.roll(v, shift, dims=a), 200))
            for _ in range(3)]
        roll_turns[label] = tuple(statistics.median(r[i] for r in rounds)
                                  for i in (0, 1))
        print(f"[{card}] {label} at {CHAIN_SHAPES['r43b']}, chain {ch}, in "
              f"turns (kernel, torch.roll by {shift}) x 3: "
              f"{[tuple(round(t, 5) for t in r) for r in rounds]}; medians "
              f"{roll_turns[label][0]:.5f} / {roll_turns[label][1]:.5f} ms",
              flush=True)
    library_ms["roll_chain_micro"] = mean([roll_turns["axis 1"][1],
                                          roll_turns["axis 0"][1]])
    library_ms["bf16_roll_chain_micro"] = roll_turns["bf16"][1]
    axis_ms = {a: ch_ms["r43b"][f"roll axis {a}"][0][ch] for a in (1, 0)}
    print(f"[{card}] roll_chain_micro at {CHAIN_SHAPES['r43b']}, chain {ch}: "
          f"axis 1 {axis_ms[1]:.5f} ms, axis 0 {axis_ms[0]:.5f} ms (the row "
          f"is their mean); at {CHAIN_SHAPES['fill']}: axis 1 "
          f"{ch_ms['fill']['roll axis 1'][0][ch]:.5f}, axis 0 "
          f"{ch_ms['fill']['roll axis 0'][0][ch]:.5f}, bf16 "
          f"{ch_ms['fill']['bf16 roll'][0][ch]:.5f}", flush=True)
    # the add/min chains in closed form, one torch.add each, where the
    # dtype's steps are exact: from i = 1 on both terms of the min are
    # equal, so elem is x + (chain - 1) (int32, int16) and reg is
    # 2x + 2 chain + 1 (int32, int16, float32); bf16 rounds, so has none
    elem_closed, reg_closed = elem_dts[:2], (torch.int32, torch.int16,
                                             torch.float32)
    reg_const = {dt: torch.full_like(x[dt], 2 * ch + 1) for dt in reg_closed}
    library = {
        "elem_chain_micro": [(lambda dt=dt: torch.add(x[dt], ch - 1),
                              wm.elem_chain_micro(x[dt], ch))
                             for dt in elem_closed],
        "reg_chain_micro": [(lambda dt=dt: torch.add(reg_const[dt], x[dt],
                                                     alpha=2),
                             wm.reg_chain_micro(x[dt], ch))
                            for dt in reg_closed]}
    for name, calls in library.items():
        for call, got in calls:
            require(torch.equal(call(), got),
                    f"{name} differs from its closed form")
        library_ms[name] = mean([graph_ms(call, 200) for call, _ in calls])
    print(f"chain libraries in closed form: elem over "
          f"{[dname(d) for d in elem_closed]}, reg over "
          f"{[dname(d) for d in reg_closed]}", flush=True)
    T, N = SWEEP_SHAPES["r43b"]
    bounds = {
        # each input read once and each output written once; the
        # recurrence's ~12 integer operations a cost
        "sweep_micro": bound(mean([sw_bytes["r43b", m] for m in sweep_modes]),
                             12 * T * N * wm.D_MICRO),
        # 3 operations an iteration a value; one value read and written
        "elem_chain_micro": bound(mean([2 * n * x[dt].element_size()
                                        for dt in elem_dts]), 3 * ch * n),
        "reg_chain_micro": bound(mean([2 * n * x[dt].element_size()
                                       for dt in reg_dts]), 3 * ch * n),
        # one move a value a roll
        "roll_chain_micro": bound(8 * n, ch * n),
        "bf16_roll_chain_micro": bound(4 * n, ch * n),
    }

    floors = {"sweep_micro": sw_floor,
              "roll_chain_micro": {a: floor_ns[f"roll axis {a}"]
                                   for a in (1, 0)},
              "bf16_roll_chain_micro": floor_ns["bf16 roll"],
              "elem_chain_micro": {k: v for k, v in chain_floor.items()
                                   if k.startswith("elem")},
              "reg_chain_micro": {k: v for k, v in chain_floor.items()
                                  if k.startswith("reg")}}
    rows = []
    for name, (src, replaces) in MICRO_KERNELS.items():
        b_ms, b_by = bounds[name]
        floor = (f", one-line floor {floors[name]} ns a step"
                 if name in floors else "")
        print(f"[{card}] {name}: {ms[name]:.4f} ms/launch, {counts[name]} "
              f"launches in the micro's run (none on any user path), bound "
              f"{b_ms:.4f} ms ({b_by}), plain {plain_ms[name]:.3f} ms, "
              f"library {library_ms[name]}{floor}", flush=True)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": err[name], "ms": ms[name],
                     "plain_ms": plain_ms[name], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms[name]})
        if name in floors:
            rows[-1]["floor_ns_per_step"] = floors[name]
        if name == "sweep_micro":
            rows[-1]["mode_ms"] = {m: sw_ms["r43b", m] for m in sweep_modes}
            rows[-1]["mode_bound_ms"] = {m: sw_bound["r43b", m]
                                         for m in sweep_modes}
            rows[-1]["kitti_E_write_ms"] = e_cmp
        if name == "roll_chain_micro":
            rows[-1]["axis_ms"] = axis_ms
        if name in ("elem_chain_micro", "reg_chain_micro"):
            kname = name.split("_")[0]
            rows[-1]["issue_bound_ms"] = mean(
                [v for k, v in issue_ms.items() if k.startswith(kname)])
            rows[-1]["dtype_ms"] = {
                k: t[0][ch] for k, t in ch_ms["r43b"].items()
                if k.startswith(kname)}
    return rows


def adaptive_path(card: str, kitti: dict) -> dict:
    """Step 18: adaptive P2. Holds the adaptive sweep (both forms, all
    eight directions) and the adaptive `sweep_bwd_wta` against their plain
    versions at the KITTI path's shapes; drives `kitti_sgm8` with
    `adaptive_p2=True` through `api.match_batch` on step 3's 8 pairs, with
    the counters set to 0 just before, also under `BIDIR_VERT`, against
    the plain pipeline and the synthetic truth; times each adaptive launch
    beside the scalar one and its byte bound, and the batch beside the
    scalar batch; drives `middlebury_sgm4` with `adaptive_p2=True` at full
    size through `sgbm_volume` + `select_and_refine`, against the fused
    route and the plain pipeline. `kitti` holds the KITTI path's frames,
    ground truth, census volume of the first set of frames (step 1) and
    the Middlebury frames of step 9. Returns {kernel: (launches on the
    adaptive path, ms per adaptive launch by events)} for `sgm_sweep` and
    `sweep_bwd_wta`."""
    import importlib

    import torch
    from tpustereo_torch import PRESETS, api, kernels
    from tpustereo_torch.kernels.sgm import (VERTICAL_DXS,
                                             sgm_sweep_fused_plain,
                                             sgm_sweep_plain,
                                             sweep_bwd_wta_plain)
    from tpustereo_torch.ops.sgm import DIRS_4, DIRS_8
    from tpustereo_torch.pipeline import (select_and_refine, sgbm_batched,
                                          sgbm_volume)
    ksgm = importlib.import_module("tpustereo_torch.kernels.sgm")

    t_step = time.perf_counter()
    cfg_s = PRESETS["kitti_sgm8"]
    cfg = cfg_s.replace(adaptive_p2=True)
    D, F, p1, p2 = cfg.num_disparities, cfg.frames_per_step, cfg.p1, cfg.p2
    H, W = SHAPE
    L, R, C = kitti["L"], kitti["R"], kitti["C"]
    Lf = L[:F].contiguous()
    n_pix = F * H * W
    n_cost = n_pix * D
    forms0 = dict.fromkeys(kernels.sgm_sweep.builds, 0)

    # --- the adaptive kernels against their plain versions: each direction
    # in both forms (the add form on the adaptive S7 of the directions
    # before it), then sweep_bwd_wta on the adaptive S7 of all but W
    S7 = None
    sweep_err = 0
    for dy, dx in DIRS_8:
        L_k = kernels.sgm_sweep(C, None, dy, dx, p1, p2, Lf)
        L_p = sgm_sweep_plain(C, None, dy, dx, p1, p2, Lf)
        torch.cuda.synchronize()
        require(torch.equal(L_k, L_p),
                f"adaptive sgm_sweep {(dy, dx)} write form differs")
        base = L_k if S7 is None else S7
        S_k = kernels.sgm_sweep(C, base.clone(), dy, dx, p1, p2, Lf)
        S_p = sgm_sweep_plain(C, base.clone(), dy, dx, p1, p2, Lf)
        torch.cuda.synchronize()
        require(torch.equal(S_k, S_p),
                f"adaptive sgm_sweep {(dy, dx)} add form differs")
        sweep_err = max(sweep_err, int_err(L_k, L_p), int_err(S_k, S_p))
        if (dy, dx) != (0, -1):
            S7 = L_k if S7 is None else S_k
        del L_k, L_p, S_k, S_p, base
    disp, valid, d_r = kernels.sweep_bwd_wta(C, S7, cfg, Lf)
    disp_p, valid_p, d_r_p = sweep_bwd_wta_plain(C, S7, cfg, Lf)
    torch.cuda.synchronize()
    require(torch.equal(valid, valid_p) and torch.equal(d_r, d_r_p),
            "adaptive sweep_bwd_wta valid or d_r differs")
    bwd_err = (disp - disp_p).abs().max().item()
    require(bwd_err <= DISP_TOL, "adaptive sweep_bwd_wta disp differs")
    del disp, valid, d_r, disp_p, valid_p, d_r_p
    fused_err = 0
    for first in (1, -1):
        S_k = kernels.sgm_sweep_fused(C, None, first, VERTICAL_DXS, p1, p2,
                                      Lf)
        S_p = sgm_sweep_fused_plain(C, None, first, VERTICAL_DXS, p1, p2, Lf)
        kernels.sgm_sweep_fused(C, S_k, -first, VERTICAL_DXS, p1, p2, Lf)
        S_q = sgm_sweep_fused_plain(C, S_p.clone(), -first, VERTICAL_DXS, p1,
                                    p2, Lf)
        kernels.sgm_sweep_fused(C, S_p, first, VERTICAL_DXS, p1, p2, Lf)
        torch.cuda.synchronize()
        require(torch.equal(S_k, S_q), f"adaptive sgm_sweep_fused differs "
                f"(dy={first} written, {-first} added)")
        fused_err = max(fused_err, int_err(S_k, S_q))
        del S_k, S_p, S_q
    print(f"check adaptive sgm_sweep (8 directions, both forms): max abs "
          f"diff to plain = {sweep_err}; adaptive sgm_sweep_fused (both "
          f"orders and forms): {fused_err}; adaptive sweep_bwd_wta: "
          f"{bwd_err}", flush=True)

    # --- the path, through the user's entry point, also under BIDIR_VERT
    runs = {}
    for bidir in (False, True):
        ksgm.BIDIR_VERT = bidir
        try:
            kernels.reset_launch_counts()
            out = api.match_batch(kitti["lefts"], kitti["rights"], cfg)
            torch.cuda.synchronize()
            runs[bidir] = (out, kernels.launch_counts(),
                           dict(kernels.sgm_sweep.builds),
                           dict(kernels.sweep_bwd_wta.builds),
                           dict(kernels.sgm_sweep_fused.builds))
        finally:
            ksgm.BIDIR_VERT = False
    out, launches, forms, bwd_builds, fused_forms = runs[False]
    print(f"kitti_sgm8 + adaptive_p2 launches: {launches}; sgm_sweep forms: "
          f"{forms}; sgm_sweep_fused forms: {fused_forms}; sweep_bwd_wta "
          f"builds: {bwd_builds}", flush=True)
    for bidir, (o, la, fo, bb, ff) in runs.items():
        for name in KERNELS:
            require(la[name] > 0, f"{name} was not launched on the adaptive "
                    f"path (BIDIR_VERT {bidir})")
        require(ff == dict(forms0, write_adaptive=BATCH // F,
                           add_adaptive=BATCH // F)
                and fo == dict(forms0, add_adaptive=BATCH // F),
                f"the adaptive path's sweeps ran {ff} fused and {fo} one "
                f"direction a launch, not an adaptive fused write and add "
                f"and the adaptive E add a set of frames (BIDIR_VERT "
                f"{bidir})")
        require(bb == {"scalar": 0, "adaptive": BATCH // F},
                f"the adaptive path's sweep_bwd_wta ran {bb} (BIDIR_VERT "
                f"{bidir})")
        require(la["sgm_sweep_bidir"] == 0 and la["transpose_hw"] == 0,
                f"the adaptive path ran sgm_sweep_bidir or a transpose "
                f"(BIDIR_VERT {bidir})")
        require(np.array_equal(o, out), "the adaptive path's output differs "
                "under BIDIR_VERT")
    require(out.shape == (BATCH, H, W) and np.isfinite(out).all(),
            "adaptive match_batch output has the wrong shape or non-finite "
            "values")
    ref = np.concatenate([plain_pipeline(L[i:i + F], R[i:i + F], cfg)
                          .cpu().numpy() for i in range(0, BATCH, F)])
    require(np.array_equal(out == -1.0, ref == -1.0),
            "adaptive invalid pattern differs from the plain pipeline")
    path_err = float(np.abs(out - ref).max())
    require(path_err <= DISP_TOL, "adaptive disparity differs from the plain "
            "pipeline")
    require(not np.array_equal(out, kitti["out"]),
            "the adaptive path gave the scalar path's output")
    vfrac, bad2 = quality(out, kitti["gts"])
    p_vfrac, p_bad2 = quality(ref, kitti["gts"])
    print(f"kitti_sgm8 + adaptive_p2 vs plain pipeline: max abs diff "
          f"{path_err}; valid fraction {vfrac:.4f}, bad-2.0 {bad2:.4f} "
          f"(plain pipeline {p_vfrac:.4f}, {p_bad2:.4f})", flush=True)
    # step 3's bar, which the plain pipeline meets on these pairs
    require(vfrac > 0.9 and bad2 < 0.05,
            "adaptive path output is not a good disparity map")

    # --- each launch by CUDA-graph replay beside the scalar one and its
    # byte bound (the image adds one byte a pixel)
    S_tmp = S7.clone()
    for dy, dx in DIRS_8:
        for form, nbytes in (("write", 3), ("add", 5)):
            S_in = None if form == "write" else S_tmp
            g = {}
            for kind, img in (("scalar", None), ("adaptive", Lf),
                              ("adaptive2", Lf), ("scalar2", None)):
                g[kind] = graph_ms(
                    lambda dy=dy, dx=dx, S_in=S_in, img=img:
                    kernels.sgm_sweep(C, S_in, dy, dx, p1, p2, img), 5)
            b_s = bound(nbytes * n_cost, 9 * n_cost)[0]
            b_a = bound(nbytes * n_cost + n_pix, 9 * n_cost)[0]
            ratio = ((g["adaptive"] + g["adaptive2"])
                     / (g["scalar"] + g["scalar2"]))
            print(f"[{card}] sgm_sweep {dy},{dx} {form}, graph replay: "
                  f"adaptive {g['adaptive']:.4f}, {g['adaptive2']:.4f} ms "
                  f"(bound {b_a:.4f}); scalar {g['scalar']:.4f}, "
                  f"{g['scalar2']:.4f} ms (bound {b_s:.4f}); adaptive / "
                  f"scalar {ratio:.4f}", flush=True)
    del S_tmp
    dirs7 = [r for r in DIRS_8 if r != (0, -1)]

    def sweeps(img):
        S = kernels.sgm_sweep(C, None, *dirs7[0], p1, p2, img)
        for dy, dx in dirs7[1:]:
            kernels.sgm_sweep(C, S, dy, dx, p1, p2, img)

    set_ms = {k: cuda_ms(lambda img=img: sweeps(img), 3) / len(dirs7)
              for k, img in (("scalar", None), ("adaptive", Lf))}
    # the fused launches, adaptive beside scalar, by graph replay, and the
    # main path's adaptive launches by events: the fused pair's mean, E
    fg = {}
    for kind, img in (("scalar", None), ("adaptive", Lf), ("adaptive2", Lf),
                      ("scalar2", None)):
        fg[kind] = [graph_ms(lambda img=img, dy=dy, S_in=S_in:
                             kernels.sgm_sweep_fused(C, S_in, dy,
                                                     VERTICAL_DXS, p1, p2,
                                                     img), 5)
                    for dy, S_in in ((1, None), (-1, S7.clone()))]
    S_acc = S7.clone()
    fused_adaptive_ms = (
        cuda_ms(lambda: kernels.sgm_sweep_fused(C, None, 1, VERTICAL_DXS,
                                                p1, p2, Lf), 10)
        + cuda_ms(lambda: kernels.sgm_sweep_fused(
            C, S_acc, -1, VERTICAL_DXS, p1, p2, Lf), 10)) / 2
    e_adaptive_ms = cuda_ms(lambda: kernels.sgm_sweep(C, S_acc, 0, 1, p1, p2,
                                                      Lf), 10)
    del S_acc
    print(f"[{card}] sgm_sweep_fused at KITTI F={F}, graph replay ms "
          f"(down write, up add): {fg}; bounds "
          f"{bound(3 * n_cost + n_pix, 0)[0]:.4f}, "
          f"{bound(5 * n_cost + n_pix, 0)[0]:.4f} adaptive; by events: "
          f"adaptive fused mean {fused_adaptive_ms:.4f} ms, adaptive E add "
          f"{e_adaptive_ms:.4f} ms", flush=True)
    S7s = None
    for dy, dx in dirs7:
        S7s = kernels.sgm_sweep(C, S7s, dy, dx, p1, p2)
    bwd = {}
    for kind, S, img in (("scalar", S7s, None), ("adaptive", S7, Lf),
                         ("adaptive2", S7, Lf), ("scalar2", S7s, None)):
        c = cfg if img is not None else cfg_s
        bwd[kind] = (
            graph_ms(lambda S=S, c=c, img=img:
                     kernels.sweep_bwd_wta(C, S, c, img), 5),
            cuda_ms(lambda S=S, c=c, img=img:
                    kernels.sweep_bwd_wta(C, S, c, img), 10))
    del S7s
    print(f"[{card}] sgm_sweep at KITTI F={F}, the set's mean by events: "
          f"adaptive {set_ms['adaptive']:.4f} ms, scalar "
          f"{set_ms['scalar']:.4f} ms", flush=True)
    print(f"[{card}] sweep_bwd_wta at KITTI F={F}, (graph replay, events) "
          f"ms: {bwd}; byte bound scalar "
          f"{bound(3 * n_cost + 9 * n_pix, 0)[0]:.4f}, adaptive "
          f"{bound(3 * n_cost + 10 * n_pix, 0)[0]:.4f}", flush=True)

    # --- the batch of 8, scalar and adaptive in turns
    bt = {}
    for kind, c in (("scalar", cfg_s), ("adaptive", cfg), ("adaptive2", cfg),
                    ("scalar2", cfg_s)):
        bt[kind] = cuda_ms(lambda c=c: sgbm_batched(L, R, c), 5)
    print(f"[{card}] kitti_sgm8 batch of {BATCH} on device tensors: "
          f"adaptive {bt['adaptive']:.3f}, {bt['adaptive2']:.3f} ms "
          f"({2 * BATCH * 1e3 / (bt['adaptive'] + bt['adaptive2']):.2f} "
          f"frames/s); scalar {bt['scalar']:.3f}, {bt['scalar2']:.3f} ms "
          f"({2 * BATCH * 1e3 / (bt['scalar'] + bt['scalar2']):.2f} "
          f"frames/s)", flush=True)
    print(f"[{card}] adaptive batch profiler: "
          f"{device_busy(lambda: sgbm_batched(L, R, cfg))}", flush=True)
    del S7

    # --- middlebury_sgm4 + adaptive_p2 at full size: the volume route
    mcfg_s = PRESETS["middlebury_sgm4"]
    mcfg = mcfg_s.replace(adaptive_p2=True)
    Fm = mcfg.frames_per_step
    (Hm, Wm), _, v_min, bad_max = MIDDLEBURY
    m_lefts, m_rights, m_gts = kitti["middlebury"]
    Lm = torch.from_numpy(m_lefts).cuda()
    Rm = torch.from_numpy(m_rights).cuda()

    def volume_route(c):
        return torch.cat([select_and_refine(
            sgbm_volume(Lm[i:i + Fm], Rm[i:i + Fm], c), c)
            for i in range(0, BATCH, Fm)])

    kernels.reset_launch_counts()
    vol = volume_route(mcfg)
    torch.cuda.synchronize()
    launches_m = kernels.launch_counts()
    forms_m = dict(kernels.sgm_sweep.builds)
    print(f"middlebury_sgm4 + adaptive_p2 volume route launches: "
          f"{launches_m}; sgm_sweep forms: {forms_m}", flush=True)
    require(forms_m == dict(forms0, write_adaptive=BATCH // Fm,
                            add_adaptive=3 * BATCH // Fm),
            f"the adaptive volume route's sweeps ran {forms_m}")
    require(launches_m["transpose_hw"] == 3 * BATCH // Fm
            and launches_m["wta_lr"] > 0
            and launches_m["sweep_bwd_wta"] == 0,
            "the adaptive volume route did not run its kernels")
    vol = vol.cpu().numpy()
    require(vol.shape == (BATCH, Hm, Wm) and np.isfinite(vol).all(),
            "adaptive volume route output has the wrong shape or non-finite "
            "values")
    kernels.reset_launch_counts()
    fused = sgbm_batched(Lm, Rm, mcfg).cpu().numpy()
    require(kernels.sweep_bwd_wta.builds == {"scalar": 0,
                                             "adaptive": BATCH // Fm},
            "the adaptive fused route did not run the adaptive bwd build")
    require(np.array_equal(vol, fused),
            "adaptive volume route differs from the fused route")
    del fused
    t0 = time.perf_counter()
    ref = plain_pipeline(Lm[:1], Rm[:1], mcfg).cpu().numpy()
    plain_s = time.perf_counter() - t0
    require(np.array_equal(vol[:1] == -1.0, ref == -1.0),
            "adaptive volume route invalid pattern differs from the plain "
            "pipeline")
    m_err = float(np.abs(vol[:1] - ref).max())
    require(m_err <= DISP_TOL, "adaptive volume route disparity differs "
            "from the plain pipeline")
    m_vfrac, m_bad2 = quality(vol, m_gts)
    print(f"middlebury_sgm4 + adaptive_p2 volume route: equal to the fused "
          f"route; vs plain pipeline (1 frame, {plain_s:.1f} s): {m_err}; "
          f"valid fraction {m_vfrac:.4f}, bad-2.0 {m_bad2:.4f} (plain "
          f"pipeline's frame: {quality(ref, m_gts[:1])})", flush=True)
    require(m_vfrac > v_min and m_bad2 < bad_max,
            "adaptive volume route output is not a good disparity map")
    mt = {}
    for kind, c in (("scalar", mcfg_s), ("adaptive", mcfg),
                    ("adaptive2", mcfg), ("scalar2", mcfg_s)):
        mt[kind] = (cuda_ms(lambda c=c: volume_route(c), 3),
                    cuda_ms(lambda c=c: sgbm_batched(Lm, Rm, c), 3))
    print(f"[{card}] middlebury_sgm4 {Hm}x{Wm} batch of {BATCH}, (volume "
          f"route, fused route) ms: {mt}", flush=True)

    # sweep_bwd_wta alone on one set of 4 Middlebury frames, S7 from the
    # other three paths, scalar and adaptive
    Lmf = Lm[:Fm].contiguous()
    Cm = kernels.census_cost_volume(Lmf, Rm[:Fm], D, mcfg.max_census_cost,
                                    mcfg.census_window, mcfg.min_disparity)
    nm_pix = Lmf.numel()
    mb = {}
    for kind, c, img in (("scalar", mcfg_s, None), ("adaptive", mcfg, Lmf),
                         ("adaptive2", mcfg, Lmf), ("scalar2", mcfg_s, None)):
        S7m = None
        for dy, dx in DIRS_4:
            if (dy, dx) != (0, -1):
                S7m = kernels.sgm_sweep(Cm, S7m, dy, dx, c.p1, c.p2, img)
        mb[kind] = graph_ms(lambda S7m=S7m, c=c, img=img:
                            kernels.sweep_bwd_wta(Cm, S7m, c, img), 2)
        del S7m
    del Cm
    print(f"[{card}] sweep_bwd_wta at Middlebury F={Fm}, graph replay ms: "
          f"{mb}; byte bound scalar "
          f"{bound(3 * nm_pix * D + 9 * nm_pix, 0)[0]:.4f}, adaptive "
          f"{bound(3 * nm_pix * D + 10 * nm_pix, 0)[0]:.4f}", flush=True)
    print(f"step 18: {time.perf_counter() - t_step:.1f} s", flush=True)
    return {"sgm_sweep": (forms["write_adaptive"] + forms["add_adaptive"],
                          e_adaptive_ms),
            "sgm_sweep_fused": (fused_forms["write_adaptive"]
                                + fused_forms["add_adaptive"],
                                fused_adaptive_ms),
            "sweep_bwd_wta": (bwd_builds["adaptive"],
                              (bwd["adaptive"][1] + bwd["adaptive2"][1]) / 2)}


def sync_sources(fn) -> list:
    """The host synchronisations of one call of fn(), as reported by
    `torch.cuda.set_sync_debug_mode("warn")`: for each, the innermost frame
    of the package's own code that made it, "path:line" (or "outside: ..."
    with the frames where it surfaced, when none did)."""
    import traceback
    import warnings

    import torch
    found: list = []

    def record(message, category, filename, lineno, file=None, line=None):
        # one warning a synchronising call; the mode's own notice that it
        # is a prototype is not one
        if "called a synchronizing" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        own = [f for f in stack if "tpustereo_torch" in f.filename]
        if own:
            found.append(f"{own[-1].filename.split('tpustereo_torch/')[-1]}"
                         f":{own[-1].lineno}")
        else:   # where the warning surfaced, for the record
            found.append("outside: " + " < ".join(
                f"{f.filename.split('/')[-1]}:{f.lineno}"
                for f in stack[::-1] if "warnings" not in f.filename)[:200])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return found


def odometry_path(card: str, per_set: dict, shared: dict,
                  dev: str = "cuda") -> dict:
    """Step 19: stereo odometry at KITTI odometry size (see the module's
    docstring). `per_set` holds the seven KITTI kernels' launches of one set
    of frames (step 3); `shared` receives the straight run's sequence and
    trajectory for step 20. Returns {kernel: launches on the straight
    run}."""
    import torch
    from tpustereo_torch import PRESETS, api, kernels
    from tpustereo_torch.data import synthetic_sequence
    from tpustereo_torch.eval import ate, rpe
    from tpustereo_torch.odometry import (OdometryConfig, PoseGraph,
                                          StereoOdometry, optimize_poses)
    from tpustereo_torch.odometry.features import (describe, detect_corners,
                                                   match_descriptors)
    from tpustereo_torch.odometry.fused import (backproject,
                                                fused_track_frames,
                                                fused_track_from_disp,
                                                fused_track_step)
    from tpustereo_torch.odometry.pnp import gauss_newton_pose
    from tpustereo_torch.pipeline import sgbm

    t_step = time.perf_counter()
    cfg = PRESETS["kitti_odometry"].replace(strips=1)
    ocfg = OdometryConfig()
    calib, frames, gt = synthetic_sequence(
        n_frames=ODO_FRAMES, shape=ODO_SHAPE, step_x=ODO_STEP, seed=0,
        **ODO_CAM)
    print(f"step 19: {len(frames)} frames of {ODO_SHAPE} made in "
          f"{time.perf_counter() - t_step:.1f} s", flush=True)

    # --- the straight run, through the user's entry point
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    traj = api.run_sequence(frames, calib, cfg, ocfg, device=dev)
    cold_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expected = dict.fromkeys(launches, 0)
    expected.update({k: n * len(frames) for k, n in per_set.items()})
    print(f"odometry launches: {launches}", flush=True)
    require(launches == expected, f"the odometry run's launches {launches} "
            f"are not {len(frames)} matcher calls of {per_set}")
    err = np.linalg.norm(traj[:, :3, 3] - gt[:, :3, 3], axis=-1)
    dist = float(np.linalg.norm(gt[-1, :3, 3]))
    a, r = ate(traj, gt), rpe(traj, gt, delta=1)
    print(f"straight run: final error {err[-1]:.4f} m over {dist:.2f} m, "
          f"final x {traj[-1, 0, 3]:.4f} (true {gt[-1, 0, 3]:.4f}); ATE "
          f"rmse {a['rmse']:.6f} m, max {a['max']:.6f}; RPE trans "
          f"{r['trans_rmse']:.6f} m, rot {r['rot_rmse_deg']:.6f} deg",
          flush=True)
    require(np.isfinite(traj).all() and traj.shape == (len(frames), 4, 4),
            "run_sequence gave a trajectory of the wrong shape or non-finite")
    # the JAX unit test's bars (tests/test_odometry_units.py)
    require(err[-1] < 0.2 * dist and traj[-1, 0, 3] > 0.6 * gt[-1, 0, 3],
            "the straight run misses the JAX test's trajectory bars")
    shared.update(calib=calib, frames=frames, gt=gt, traj=traj)

    # the same run again, warm, through StereoOdometry: its host clock, its
    # keyframes and its graph
    torch.cuda.synchronize()
    odo = StereoOdometry(calib, cfg, ocfg, device=dev)
    t0 = time.perf_counter()
    for L, R in frames:
        odo.step(L, R)
    warm_s = time.perf_counter() - t0
    print(f"[{card}] run_sequence host clock: {len(frames) / cold_s:.2f} "
          f"frames/s cold ({cold_s:.3f} s, the first run of the step), "
          f"{len(frames) / warm_s:.2f} frames/s warm ({warm_s:.3f} s); "
          f"{len(odo.kfs)} keyframes, closures {odo.closures}; warm "
          f"trajectory vs the first: max diff "
          f"{np.abs(odo.trajectory() - traj).max():.3e}", flush=True)

    # --- out-and-back: the JAX loop-closure test's run at this size
    out = [i * ODO_STEP for i in range(8)]
    calib_l, frames_l, gt_l = synthetic_sequence(
        shape=ODO_SHAPE, seed=5, cam_xs=out + out[::-1][1:], **ODO_CAM)
    closing = StereoOdometry(calib_l, cfg, OdometryConfig(
        keyframe_translation=0.05, lc_min_gap=6, lc_min_matches=25),
        device=dev)
    opened = StereoOdometry(calib_l, cfg, OdometryConfig(
        keyframe_translation=0.05, loop_closure=False), device=dev)
    for L, R in frames_l:
        closing.step(L, R)
        opened.step(L, R)
    err_end = float(np.linalg.norm(closing.trajectory()[-1, :3, 3]
                                   - gt_l[-1, :3, 3]))
    err_open = float(np.linalg.norm(opened.trajectory()[-1, :3, 3]
                                    - gt_l[-1, :3, 3]))
    print(f"out-and-back: closures {closing.closures} over "
          f"{len(closing.kfs)} keyframes; endpoint error {err_end:.4f} m, "
          f"{err_open:.4f} m without closures", flush=True)
    require(any(j - i >= 6 for i, j in closing.closures),
            "no loop closure across 6 keyframes on the out-and-back run")
    require(err_end < max(0.05, 1.05 * err_open),
            "the closures left the endpoint worse than the open run")

    # --- the card against the CPU on the same inputs
    K = ocfg.max_corners
    intr = torch.tensor([calib.fx, calib.fy, calib.cx, calib.cy],
                        dtype=torch.float32, device=dev)
    base = torch.tensor(calib.baseline, dtype=torch.float32, device=dev)
    zeros = (torch.zeros((K, 64), device=dev),
             torch.zeros((K,), dtype=torch.bool, device=dev),
             torch.zeros((K, 3), device=dev))
    Ls = torch.from_numpy(np.stack([f[0] for f in frames[:5]])).to(dev)
    Rs = torch.from_numpy(np.stack([f[1] for f in frames[:5]])).to(dev)
    kf0 = fused_track_step(Ls[0], Rs[0], *zeros, intr, base, cfg, ocfg)
    kf = (kf0.desc, kf0.valid, kf0.X)

    def diffs(got, ref) -> dict:
        got = type(got)(*(x.cpu() for x in got))
        require(torch.equal(got.valid, ref.valid), "corner validity differs")
        require(int(got.n_matches) == int(ref.n_matches),
                "match counts differ")
        out = {k: (getattr(got, k) - getattr(ref, k)).abs().max().item()
               for k in ODO_TOL}
        for k, tol in ODO_TOL.items():
            require(out[k] <= tol, f"{k} differs by {out[k]} > {tol}")
        return out

    worst = dict.fromkeys(ODO_TOL, 0.0)
    for f in range(3):
        state = zeros if f == 0 else kf
        disp = sgbm(Ls[f], Rs[f], cfg)
        got = fused_track_from_disp(Ls[f], disp, *state, intr, base, cfg,
                                    ocfg)
        ref = fused_track_from_disp(Ls[f].cpu(), disp.cpu(),
                                    *(x.cpu() for x in state), intr.cpu(),
                                    base.cpu(), cfg, ocfg)
        for k, v in diffs(got, ref).items():
            worst[k] = max(worst[k], v)
        print(f"frame {f}: card vs CPU n_matches {int(ref.n_matches)}, "
              f"valid corners {int(ref.valid.sum())}", flush=True)
    print(f"fused_track_from_disp, card vs CPU, 3 frames: max abs diff "
          f"{worst}", flush=True)
    g = odo.graph
    ij = torch.tensor([e[:2] for e in g.edges])
    Ts = torch.from_numpy(np.stack([e[2] for e in g.edges]))
    w = torch.tensor([e[3] for e in g.edges], dtype=torch.float32)
    poses = torch.from_numpy(np.stack(g.poses))
    pg_ref = optimize_poses(poses, ij, Ts, w)
    pg_got = optimize_poses(poses.to(dev), ij.to(dev), Ts.to(dev),
                            w.to(dev)).cpu()
    pg_err = (pg_got - pg_ref).abs().max().item()
    print(f"optimize_poses on the straight run's graph ({len(g.poses)} "
          f"poses, {len(g.edges)} edges), card vs CPU: max abs diff "
          f"{pg_err}", flush=True)
    require(pg_err <= ODO_TOL["T"], "optimize_poses differs from the CPU")

    # --- fused_track_frames at F = 4 against 4 single steps
    chunk = fused_track_frames(Ls[1:], Rs[1:], *kf, intr, base, cfg, ocfg)
    for f in range(4):
        single = fused_track_step(Ls[1 + f], Rs[1 + f], *kf, intr, base,
                                  cfg, ocfg)
        require(torch.equal(chunk.disp[f], single.disp),
                "fused_track_frames' disparity differs from a single step")
        diffs(type(single)(*(x[f] for x in chunk)), type(single)(
            *(x.cpu() for x in single)))
    print("fused_track_frames at F = 4: equal to 4 single steps", flush=True)

    # --- host synchronisations in one tracked step (frame 1 after the
    # keyframe of frame 0; no keyframe is made)
    sync_odo = StereoOdometry(calib, cfg, ocfg, device=dev)
    sync_odo.step(*frames[0])
    sources = sync_sources(lambda: sync_odo.step(*frames[1]))
    require(len(sync_odo.kfs) == 1, "the measured step made a keyframe")
    ours = [x for x in sources if x.startswith("odometry/")]
    # sources are "path:line" of the package's innermost frame, else
    # "outside: ..." with the frames where the warning surfaced
    rest: dict = {}
    for x in sources:
        if x not in ours:
            rest[x] = rest.get(x, 0) + 1
    print(f"host synchronisations in one tracked step: {len(sources)}; "
          f"from odometry/: {ours}; the rest: {rest}", flush=True)
    require(len(ours) == 1, f"odometry/ synchronises {len(ours)} times in "
            f"a tracked step, not once")

    # --- times
    disp1 = sgbm(Ls[1], Rs[1], cfg)
    step_ms = median_ms(lambda: fused_track_step(Ls[1], Rs[1], *kf, intr,
                                                 base, cfg, ocfg), 20)
    sgbm_ms = cuda_ms(lambda: sgbm(Ls[1], Rs[1], cfg), 20)
    core_ms = median_ms(lambda: fused_track_from_disp(
        Ls[1], disp1, *kf, intr, base, cfg, ocfg), 20)
    shared["refs"].update(odometry=step_ms, odometry_core=core_ms)
    frames_ms = cuda_ms(lambda: fused_track_frames(
        Ls[1:], Rs[1:], *kf, intr, base, cfg, ocfg), 10) / 4
    print(f"[{card}] tracked frame by CUDA events: {step_ms:.4f} ms "
          f"(sgbm {sgbm_ms:.4f} ms, tracking core {core_ms:.4f} ms); "
          f"fused_track_frames at F = 4: {frames_ms:.4f} ms a frame",
          flush=True)
    # the core by function, on the inputs it gives each
    pts, cvalid = detect_corners(Ls[1], max_corners=K)
    desc = describe(Ls[1], pts)
    idx_b, good = match_descriptors(kf[0], desc, kf[1], cvalid)
    u = torch.flip(pts[idx_b], [1])
    w_m = (good & kf[1]).to(torch.float32)
    split = {
        "detect_corners": lambda: detect_corners(Ls[1], max_corners=K),
        "describe": lambda: describe(Ls[1], pts),
        "backproject": lambda: backproject(pts, disp1, intr, base,
                                           ocfg.min_depth, ocfg.max_depth),
        "match_descriptors": lambda: match_descriptors(kf[0], desc, kf[1],
                                                       cvalid),
        "gauss_newton_pose": lambda: gauss_newton_pose(kf[2], u, w_m, intr,
                                                       iters=ocfg.gn_iters),
    }
    print(f"[{card}] tracking core by function, CUDA events: "
          f"{ {n: round(cuda_ms(fn, 20), 4) for n, fn in split.items()} } ms",
          flush=True)
    reps = 5
    pg_s = []
    for _ in range(reps):
        copy = PoseGraph(list(g.poses), list(g.edges), device=dev)
        t0 = time.perf_counter()
        copy.optimize()
        pg_s.append(time.perf_counter() - t0)
    print(f"[{card}] PoseGraph.optimize at {len(g.poses)} keyframes "
          f"({len(g.edges)} edges), host clock: "
          f"{[round(x * 1e3, 3) for x in pg_s]} ms", flush=True)
    busy = device_busy(lambda: fused_track_step(Ls[1], Rs[1], *kf, intr,
                                                base, cfg, ocfg))
    print(f"[{card}] profiler, one tracked step: {busy}", flush=True)
    print(f"step 19: {time.perf_counter() - t_step:.1f} s", flush=True)
    return {k: launches[k] for k in per_set}


def plain_tiled(L, R, cfg, strips: int):
    """(F, H, W) frames on the card through the halo mode's plain
    composition, written here from the JAX `sgbm_tiled`'s rules and not
    from `dist.tiling`: rows padded to a multiple of strips * 8 by edge
    replication, strips of Hs rows extended by h = min(max(halo, census
    margin), Hs) rows each side (edge rows replicated at the image's top
    and bottom: a gather of clamped row indices), the costs of rows
    outside the image zeroed; then on the extended strips the plain
    census, `ops.aggregate`, `ops.wta` and `ops.lr_check` (the JAX jnp
    formulation, as `plain_pipeline`), cropped and gathered, then plain
    speckle and the median. No kernel runs."""
    import torch
    from tpustereo_torch.kernels.cost import census_cost_volume_plain
    from tpustereo_torch.ops import (aggregate, lr_check, median3,
                                     speckle_frames, wta)
    F, H, W = L.shape
    D = cfg.num_disparities
    Hs = -(-H // (strips * 8)) * 8
    h = min(max(cfg.halo, cfg.census_window[0] // 2), Hs)
    He = Hs + 2 * h
    # global row of each extended strip's row: (strips, He)
    g = (torch.arange(strips)[:, None] * Hs - h
         + torch.arange(He)[None]).to(L.device)
    rows = g.clamp(0, H - 1).reshape(-1)
    el, er = (x[:, rows].reshape(F, strips, He, W).transpose(0, 1)
              .reshape(-1, He, W).contiguous() for x in (L, R))
    C = census_cost_volume_plain(el, er, D, cfg.max_census_cost,
                                 cfg.census_window, cfg.min_disparity)
    outside = (g < 0) | (g >= H)
    C.view(strips, F, He, W, D).masked_fill_(
        outside[:, None, :, None, None], 0)
    S = aggregate(C, cfg, el)[:, h:He - h]
    del C
    disp, _, valid = wta(S, cfg)
    valid &= lr_check(S, disp, cfg)
    del S

    def gather(x):
        x = x.reshape(strips, F, Hs, W).transpose(0, 1)
        return x.reshape(F, strips * Hs, W)[:, :H]

    disp, valid = gather(disp), gather(valid)
    out = torch.where(speckle_frames(disp, valid, cfg), disp, -1.0)
    return median3(out) if cfg.median_filter else out


def tiled_path(card: str, per_set: dict, shared: dict) -> dict:
    """Step 20: the strip-tiled matcher at KITTI odometry size (see the
    module's docstring). `per_set` holds the seven KITTI kernels' launches
    of one set of frames (step 3), `shared` step 19's straight run.
    Returns {kernel: extra keys of its row}."""
    import warnings

    import torch
    from tpustereo_torch import PRESETS, api, dist, kernels
    from tpustereo_torch.eval import ate
    from tpustereo_torch.kernels.sgm import (VERTICAL_DXS,
                                             sgm_sweep_fused_plain,
                                             sgm_sweep_plain)
    from tpustereo_torch.odometry import OdometryConfig, StereoOdometry
    from tpustereo_torch.pipeline import sgbm, sgbm_batched

    t_step = time.perf_counter()
    dev = torch.device("cuda")
    cfg = PRESETS["kitti_odometry"]
    exact = cfg.replace(exact_tiling=True)
    D, p1, p2 = cfg.num_disparities, cfg.p1, cfg.p2
    lefts, rights, gts = synthetic_pairs(ODO_SHAPE, 45.0, BATCH)
    L = torch.from_numpy(lefts).to(dev)
    R = torch.from_numpy(rights).to(dev)
    H, W = ODO_SHAPE
    ydirs = ((1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))

    # --- the carry forms against their plain version, random q carries,
    # on two frames' census volume
    C = kernels.census_cost_volume(L[:2].contiguous(), R[:2].contiguous(), D,
                                   cfg.max_census_cost, cfg.census_window,
                                   cfg.min_disparity)
    img = L[:2].contiguous()
    rng = np.random.default_rng(20)
    carry_err = 0
    for i, (dy, dx) in enumerate(ydirs):
        q = rng.integers(0, 160, (2, W, D)).astype(np.int32)
        q = torch.from_numpy(q - q.min(-1, keepdims=True)).to(dev)
        prev = torch.from_numpy(rng.integers(0, 256, (2, W),
                                             dtype=np.uint8)).to(dev)
        for form in ("write", "add"):
            for im in (None, img):
                pv = None if im is None else prev
                S0 = (None if form == "write" else torch.from_numpy(
                    rng.integers(-900, 900, C.shape, dtype=np.int16)).to(dev))
                got, got_q = kernels.sgm_sweep(
                    C, None if S0 is None else S0.clone(), dy, dx, p1, p2,
                    im, carry=q, return_carry=True, img_prev=pv)
                ref, ref_q = sgm_sweep_plain(
                    C, None if S0 is None else S0.clone(), dy, dx, p1, p2,
                    im, q, True, pv)
                torch.cuda.synchronize()
                require(torch.equal(got, ref) and torch.equal(got_q, ref_q),
                        f"sgm_sweep {(dy, dx)} {form} carry form "
                        f"{'adaptive ' if im is not None else ''}differs "
                        f"from plain")
                carry_err = max(carry_err, int_err(got, ref),
                                int((got_q - ref_q).abs().max().item()))
    # chained over 2 and 4 strips: one untiled launch, bit for bit
    for strips in (2, 4):
        cuts = np.array_split(np.arange(H), strips)
        for dy, dx in ydirs:
            for im in (None, img):
                ref, ref_q = kernels.sgm_sweep(C, None, dy, dx, p1, p2, im,
                                               return_carry=True)
                parts, q = {}, None
                for rows in (cuts if dy > 0 else cuts[::-1]):
                    r0, r1 = int(rows[0]), int(rows[-1]) + 1
                    pv = (im[:, r0 - 1 if dy > 0 else r1].contiguous()
                          if im is not None and q is not None else None)
                    parts[r0], q = kernels.sgm_sweep(
                        C[:, r0:r1].contiguous(), None, dy, dx, p1, p2,
                        None if im is None else im[:, r0:r1].contiguous(),
                        carry=q, return_carry=True, img_prev=pv)
                torch.cuda.synchronize()
                require(torch.equal(torch.cat([parts[k] for k in
                                               sorted(parts)], 1), ref)
                        and torch.equal(q, ref_q),
                        f"sgm_sweep {(dy, dx)} chained over {strips} strips "
                        f"differs from one launch")
    print(f"step 20: sgm_sweep carry forms (6 directions, write and add, "
          f"scalar and adaptive, random q) equal to plain, max abs diff "
          f"{carry_err}; chains over 2 and 4 strips equal to one launch",
          flush=True)

    # --- the fused carry forms (the exact ring's launches with 8 paths):
    # the down and up sets, both forms, scalar and adaptive, random (3, B,
    # W, D) q carries, against their plain version; chained over 2 and 4
    # strips against one launch
    fused_carry_err = 0
    for dy in (1, -1):
        q = rng.integers(0, 160, (3, 2, W, D)).astype(np.int32)
        q = torch.from_numpy(q - q.min(-1, keepdims=True)).to(dev)
        prev = torch.from_numpy(rng.integers(0, 256, (2, W),
                                             dtype=np.uint8)).to(dev)
        for form in ("write", "add"):
            for im in (None, img):
                pv = None if im is None else prev
                S0 = (None if form == "write" else torch.from_numpy(
                    rng.integers(-900, 900, C.shape, dtype=np.int16)).to(dev))
                got, got_q = kernels.sgm_sweep_fused(
                    C, None if S0 is None else S0.clone(), dy, VERTICAL_DXS,
                    p1, p2, im, carry=q, return_carry=True, img_prev=pv)
                ref, ref_q = sgm_sweep_fused_plain(
                    C, None if S0 is None else S0.clone(), dy, VERTICAL_DXS,
                    p1, p2, im, carry=q, return_carry=True, img_prev=pv)
                torch.cuda.synchronize()
                require(torch.equal(got, ref) and torch.equal(got_q, ref_q),
                        f"sgm_sweep_fused dy={dy} {form} carry form "
                        f"{'adaptive ' if im is not None else ''}differs "
                        f"from plain")
                fused_carry_err = max(fused_carry_err, int_err(got, ref),
                                      int((got_q - ref_q).abs().max().item()))
    for strips in (2, 4):
        cuts = np.array_split(np.arange(H), strips)
        for dy in (1, -1):
            for im in (None, img):
                ref, ref_q = kernels.sgm_sweep_fused(
                    C, None, dy, VERTICAL_DXS, p1, p2, im, return_carry=True)
                parts, q = {}, None
                for rows in (cuts if dy > 0 else cuts[::-1]):
                    r0, r1 = int(rows[0]), int(rows[-1]) + 1
                    pv = (im[:, r0 - 1 if dy > 0 else r1].contiguous()
                          if im is not None and q is not None else None)
                    parts[r0], q = kernels.sgm_sweep_fused(
                        C[:, r0:r1].contiguous(), None, dy, VERTICAL_DXS, p1,
                        p2, None if im is None else im[:, r0:r1].contiguous(),
                        carry=q, return_carry=True, img_prev=pv)
                torch.cuda.synchronize()
                require(torch.equal(torch.cat([parts[k] for k in
                                               sorted(parts)], 1), ref)
                        and torch.equal(q, ref_q),
                        f"sgm_sweep_fused dy={dy} chained over {strips} "
                        f"strips differs from one launch")
    print(f"step 20: sgm_sweep_fused carry forms (down and up sets, write "
          f"and add, scalar and adaptive, random q) equal to plain, max abs "
          f"diff {fused_carry_err}; chains over 2 and 4 strips equal to one "
          f"launch", flush=True)

    # --- halo mode as shipped (2 strips, halo 32) against the plain
    # composition, and exact mode at 2 and 4 strips against untiled sgbm
    mesh2 = dist.make_mesh(1, 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        kernels.reset_launch_counts()
        halo_out = dist.sgbm_tiled_batched(L, R, cfg, mesh2)
        torch.cuda.synchronize()
        halo_launches = kernels.launch_counts()
        with_warn = [str(w.message) for w in caught]
    require(not with_warn, f"the shipped halo warned: {with_warn}")
    require(halo_out.shape == (BATCH, H, W)
            and torch.isfinite(halo_out).all().item(),
            "sgbm_tiled_batched gave the wrong shape or non-finite values")
    ref = torch.cat([plain_tiled(L[i:i + 2], R[i:i + 2], cfg, 2)
                     for i in range(0, BATCH, 2)])
    require(torch.equal(halo_out == -1.0, ref == -1.0),
            "halo mode's invalid pattern differs from the plain composition")
    halo_err = (halo_out - ref).abs().max().item()
    require(halo_err <= DISP_TOL, "halo mode differs from the plain "
            "composition")
    del ref
    one = api.match_pair_tiled(lefts[0], rights[0], cfg)
    require(np.array_equal(one, halo_out[0].cpu().numpy()),
            "match_pair_tiled differs from the batched tiled frame")
    untiled = sgbm_batched(L, R, cfg.replace(strips=1)).cpu().numpy()
    halo_np = halo_out.cpu().numpy()
    shared["tiled"] = dict(lefts=lefts, rights=rights, halo=halo_np,
                           untiled=untiled)
    vfrac, bad2 = quality(halo_np, gts)
    mism = float((np.abs(halo_np - untiled) > 0.5).mean())
    print(f"halo mode (strips 2, halo 32), 8 frames of {ODO_SHAPE}: launches "
          f"{ {k: v for k, v in halo_launches.items() if v} }; vs the plain "
          f"composition max abs diff {halo_err}; valid {vfrac:.4f}, bad-2.0 "
          f"{bad2:.4f}; pixels off the untiled output by > 0.5: {mism:.6f}",
          flush=True)
    require(vfrac > 0.9 and bad2 < 0.05, "halo mode output is not a good "
            "disparity map")
    exact_counts = {}
    for strips in (2, 4):
        kernels.reset_launch_counts()
        out = dist.sgbm_tiled_batched(L, R, exact, dist.make_mesh(1, strips))
        torch.cuda.synchronize()
        exact_counts[strips] = (kernels.launch_counts(),
                                dict(kernels.sgm_sweep_fused.carry_forms),
                                dict(kernels.sgm_sweep.carry_forms))
        out = out.cpu().numpy()
        require(np.array_equal(out == -1.0, untiled == -1.0),
                f"exact mode at {strips} strips: invalid pattern differs "
                f"from untiled")
        e = float(np.abs(out - untiled).max())
        require(e <= DISP_TOL, f"exact mode at {strips} strips differs "
                f"from untiled by {e}")
        launched, fused_forms, one_forms = exact_counts[strips]
        print(f"exact mode, {strips} strips, 8 frames: max abs diff to "
              f"untiled sgbm {e}; launches "
              f"{ {k: v for k, v in launched.items() if v} }"
              f"; fused carry forms {fused_forms}; one-direction carry "
              f"forms {one_forms}", flush=True)
        # the ring with 8 paths: the down set written and the up set added,
        # one fused carry launch a strip each (2 a strip, not six
        # one-direction launches); E the one sgm_sweep
        require(fused_forms == {"write": strips, "add": strips,
                                "write_adaptive": 0, "add_adaptive": 0}
                and launched["sgm_sweep_fused"] == 2 * strips
                and sum(one_forms.values()) == 0
                and launched["sgm_sweep"] == 1,
                f"exact mode's ring at {strips} strips did not run one fused "
                f"carry launch a scan order a strip")

    # --- run_sequence over step 19's straight run, the preset as shipped
    calib, frames, gt = shared["calib"], shared["frames"], shared["gt"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    traj = api.run_sequence(frames, calib, cfg)
    run_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    shared["tiled_traj"] = traj
    expected = dict.fromkeys(launches, 0)
    expected.update({k: n * len(frames) for k, n in per_set.items()})
    print(f"tiled odometry launches: {launches}", flush=True)
    require(launches == expected, f"the tiled odometry run's launches "
            f"{launches} are not {len(frames)} matcher calls of {per_set}")
    err = np.linalg.norm(traj[:, :3, 3] - gt[:, :3, 3], axis=-1)
    dist_m = float(np.linalg.norm(gt[-1, :3, 3]))
    a = ate(traj, gt)
    d_t = float(np.abs(traj[:, :3, 3] - shared["traj"][:, :3, 3]).max())
    d_r = float(np.abs(traj[:, :3, :3] - shared["traj"][:, :3, :3]).max())
    print(f"tiled run_sequence (strips 2, halo 32): final error "
          f"{err[-1]:.4f} m over {dist_m:.2f} m; ATE rmse {a['rmse']:.6f} m, "
          f"max {a['max']:.6f}; against the strips=1 run: translation "
          f"{d_t:.6f} m, rotation {d_r:.6f}; host clock "
          f"{len(frames) / run_s:.2f} frames/s", flush=True)
    require(np.isfinite(traj).all() and err[-1] < 0.2 * dist_m,
            "the tiled run misses the JAX test's trajectory bar")
    require(d_t <= 0.02 and d_r <= 0.01, "the tiled run strays from the "
            "strips=1 run past the JAX test's bars")
    odo = StereoOdometry(calib, cfg, OdometryConfig())
    odo.step(*frames[0])
    sources = sync_sources(lambda: odo.step(*frames[1]))
    ours = [x for x in sources if x.startswith(("odometry/", "dist/"))]
    print(f"host synchronisations in one tiled tracked step: "
          f"{len(sources)}; from odometry/ and dist/: {ours}", flush=True)
    require(len(ours) == 1 and ours[0].startswith("odometry/"),
            "the tiled tracked step does not synchronise exactly once")

    # --- times: one frame a call, by events, beside untiled sgbm
    L1, R1 = L[1], R[1]
    calls = {
        "untiled sgbm": lambda: sgbm(L1, R1, cfg.replace(strips=1)),
        "halo, 2 strips": lambda: dist.sgbm_tiled(L1, R1, cfg, mesh2),
        "exact, 2 strips": lambda: dist.sgbm_tiled(L1, R1, exact, mesh2),
        "exact, 4 strips": lambda: dist.sgbm_tiled(
            L1, R1, exact, dist.make_mesh(1, 4)),
    }
    for name, fn in calls.items():
        kernels.reset_launch_counts()
        fn()
        n = sum(kernels.launch_counts().values())
        shared["refs"][name] = median_ms(fn, 20)
        print(f"[{card}] {name}: {shared['refs'][name]:.4f} ms a frame by "
              f"events ({n} kernel launches); profiler: {device_busy(fn)}",
              flush=True)
    batch_ms = cuda_ms(lambda: dist.sgbm_tiled_batched(L, R, cfg, mesh2), 5)
    print(f"[{card}] halo mode, {BATCH} frames in one call: "
          f"{batch_ms / BATCH:.4f} ms a frame", flush=True)

    # the carry forms per launch at the exact path's strip shape (one
    # frame's 192-row strip), beside the same launch without a carry: the
    # one-direction sweep (the ring's form with 4 paths) and the fused
    # down set (with 8 paths)
    Hs = 192
    Cs = C[:1, :Hs].contiguous()
    Ss = kernels.sgm_sweep(Cs, None, 1, 0, p1, p2)
    q = torch.zeros((1, W, D), dtype=torch.int32, device=dev)
    n_cost = Cs.numel()
    carry_ms = graph_ms(lambda: kernels.sgm_sweep(
        Cs, Ss, 1, 0, p1, p2, carry=q, return_carry=True), 10)
    plain_ms = graph_ms(lambda: kernels.sgm_sweep(Cs, Ss, 1, 0, p1, p2), 10)
    b_ms, b_by = bound(5 * n_cost + 2 * W * D * 4, 9 * n_cost)
    print(f"[{card}] sgm_sweep add form on a (1, {Hs}, {W}, {D}) strip by "
          f"graph replay: with the carry in and out {carry_ms:.4f} ms, "
          f"without {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    q3 = torch.zeros((3, 1, W, D), dtype=torch.int32, device=dev)
    fcarry_ms = graph_ms(lambda: kernels.sgm_sweep_fused(
        Cs, Ss, 1, VERTICAL_DXS, p1, p2, carry=q3, return_carry=True), 10)
    fplain_ms = graph_ms(lambda: kernels.sgm_sweep_fused(
        Cs, Ss, 1, VERTICAL_DXS, p1, p2), 10)
    fb_ms, fb_by = bound(5 * n_cost + 2 * 3 * W * D * 4, 27 * n_cost)
    print(f"[{card}] sgm_sweep_fused add form (the down set) on a (1, {Hs}, "
          f"{W}, {D}) strip by graph replay: with the (3, 1, {W}, {D}) "
          f"carry in and out {fcarry_ms:.4f} ms, without {fplain_ms:.4f} "
          f"ms; bound {fb_ms:.4f} ms ({fb_by})", flush=True)
    print(f"step 20: {time.perf_counter() - t_step:.1f} s", flush=True)
    out = {k: {"tiled_launches": launches[k]} for k in per_set}
    out["sgm_sweep"].update(
        carry_launches=sum(exact_counts[2][2].values()), carry_ms=carry_ms,
        carry_bound_ms=b_ms, carry_max_abs_err=carry_err)
    out["sgm_sweep_fused"].update(
        carry_launches=sum(exact_counts[2][1].values()),
        carry_ms=fcarry_ms, carry_bound_ms=fb_ms,
        carry_max_abs_err=fused_carry_err)
    return out


def odometry_tree(root: str, calib, n: int, write) -> list:
    """The `odometry` arguments over a KITTI odometry tree of n frames under
    root (`sequences/00/image_{0,1}`, `calib.txt` of `calib`'s camera),
    frame i written by write(i, left path, right path)."""
    import os
    fx, fy, cx, cy, b = (calib.fx, calib.fy, calib.cx, calib.cy,
                         calib.baseline)
    seq = os.path.join(root, "sequences", "00")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, sub))
    for i in range(n):
        write(i, *(os.path.join(seq, sub, f"{i:06d}.png")
                   for sub in ("image_0", "image_1")))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write(f"P0: {fx!r} 0 {cx!r} 0 0 {fy!r} {cy!r} 0 0 0 1 0\n"
                f"P1: {fx!r} 0 {cx!r} {-fx * b!r} 0 {fy!r} {cy!r} 0 0 "
                f"0 1 0\n")
    return ["odometry", "--preset", "kitti_odometry", "--root", root]


def entry_points_path(card: str, shared: dict) -> None:
    """Step 21: the user's entry points at full width (see the module's
    docstring). `shared` holds step 19's sequence and calibration, and in
    "refs" each path's ms a frame by events from its earlier step."""
    import gc
    import multiprocessing
    import os
    import shutil
    import sys
    import tempfile
    import threading
    import zlib

    import torch
    from tpustereo_torch import PRESETS, api, dist, native
    from tpustereo_torch.bench.__main__ import main as bench_main
    from tpustereo_torch.cli.main import main as cli_main
    from tpustereo_torch.data import io, prefetch_pairs, synthetic_pair
    from tpustereo_torch.eval.bench import (odometry_loop, run_benchmark,
                                            run_odometry_benchmark)
    from tpustereo_torch.eval.roofline import roofline, shares
    from tpustereo_torch.odometry import StereoOdometry
    from tpustereo_torch.eval.runner import (_eval_one, evaluate,
                                             synthetic_cases)
    from tpustereo_torch.pipeline import sgbm_batched

    t_step = time.perf_counter()
    refs = shared["refs"]
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg = PRESETS["kitti_sgm8"]

    def in_turns(what: str, run, call, per: int, reps: int):
        """Three records of run(profiled) (the last one profiled), each
        after the same work timed by the host clock (`host_ms` of `call`,
        `reps` calls of `per` frames), and that timing once more after
        the last: (the median record, the median host time in ms a frame,
        the last record). Each record is printed."""
        host, recs = [], []
        for k in range(3):
            host.append(host_ms(call, reps) / per)
            recs.append(run(k == 2))
            print(f"[{card}] run record {what}: {json.dumps(recs[-1])}",
                  flush=True)
            require(recs[-1]["backend"] == "cuda" and recs[-1][
                "device_kind"] == torch.cuda.get_device_name(0),
                f"{what}: the record does not name the card")
        host.append(host_ms(call, reps) / per)
        rec = sorted(recs, key=lambda r: r["ms_per_frame"])[1]
        return rec, float(np.median(host)), recs[-1]

    def against(what: str, ms_frame: float, adjacent: float,
                earlier: float) -> None:
        """The harness's ms a frame (the median of three turns) against
        the same work on the same inputs timed by the host clock beside
        it, and against the path's events time in its earlier step (the
        median of three loops there): each within a factor of 2. A
        host-bound path's loops a second apart differ up to 1.6x (PERF.md
        §6), hence the medians on both sides."""
        r_adj, r_early = ms_frame / adjacent, ms_frame / earlier
        print(f"[{card}] {what}: harness {ms_frame:.4f} ms a frame; beside "
              f"it by the host clock {adjacent:.4f}, ratio {r_adj:.3f}; the "
              f"earlier step's events {earlier:.4f}, ratio {r_early:.3f}",
              flush=True)
        require(0.5 <= r_adj <= 2.0, f"{what}: the harness's time is not "
                f"within a factor of 2 of the same work's beside it")
        require(0.5 <= r_early <= 2.0, f"{what}: the harness's time is not "
                f"within a factor of 2 of the earlier step's events")

    # --- files: 8 pairs as PNGs through the port's codec, then `match`
    lefts, rights, _ = synthetic_pairs(SHAPE, 40.0, BATCH)
    for i in range(BATCH):
        paths = [os.path.join(work, f"{s}{i}.png") for s in "lr"]
        for path, img in zip(paths, (lefts[i], rights[i])):
            io.write_image(path, img)
            require(np.array_equal(io.read_image_gray(path), img),
                    "an image decoded by the port differs from the array "
                    "written")
        args = ["match", "--preset", "kitti_sgm8", "--left", paths[0],
                "--right", paths[1]]
        pfm, png = (os.path.join(work, f"d{i}{x}") for x in (".pfm", ".png"))
        cli_main(args + ["--out", pfm])
        cli_main(args + ["--out", png])
        want = api.match_pair(io.read_image_gray(paths[0]),
                              io.read_image_gray(paths[1]), cfg)
        got = io.read_pfm(pfm)
        require(np.array_equal(got.view(np.int32), want.view(np.int32)),
                "the match .pfm differs from api.match_pair")
        require(np.array_equal(io.read_png(png), io.kitti_disparity_raw(got)),
                "the match .png differs from the KITTI encoding of the .pfm")
    print(f"step 21: match on {BATCH} PNG pairs of {SHAPE}: .pfm equal to "
          f"api.match_pair bit for bit, .png its KITTI encoding", flush=True)

    # --- the harness: each preset at its BASELINE shape, B = 8, in three
    # turns, the last one profiled
    presets = {"kitti_sgm8": SHAPE, "middlebury_sgm4": MIDDLEBURY[0],
               "tsukuba_sad": MODES["tsukuba_sad"][0],
               "middlebury_census_wta": MODES["middlebury_census_wta"][0]}
    for name, shape in presets.items():
        L1, R1, _, _ = synthetic_pair(shape, disparity=40.0, slope=0.02,
                                      seed=0)   # the harness's inputs
        Lh, Rh = (torch.from_numpy(np.stack([x] * BATCH)).cuda()
                  for x in (L1, R1))
        # a host-bound batch takes about 1 ms of host time: 50 a loop
        iters = {"middlebury_sgm4": 5, "kitti_sgm8": 10}.get(name, 50)

        def call(name=name):
            return sgbm_batched(Lh, Rh, PRESETS[name])

        def run(profiled, name=name, shape=shape, iters=iters):
            return run_benchmark(
                PRESETS[name], shape=shape, batch=BATCH, iters=iters,
                stages=name == "kitti_sgm8",
                profile_dir=os.path.join(work, name) if profiled else None)
        rec, adjacent, last = in_turns(name, run, call, BATCH, iters)
        sh = shares(rec["roofline"])
        # the profiler now and then records no device event in a session
        # (step 20's untiled profile): only kitti_sgm8's share is required
        busy = last.get("device_busy_fraction", {}).get("busy_fraction")
        print(f"[{card}] {name} roofline shares {sh}, bound by "
              f"{rec['roofline'].get('bound')}; busy "
              f"{'not measured' if busy is None else busy}", flush=True)
        require(sh and all(0 < v <= 1 for v in sh.values()),
                f"{name}: a roofline share outside (0, 1]: {sh}")
        require(name != "kitti_sgm8" or (busy is not None and 0 < busy <= 1),
                "device_busy_fraction gave no share for kitti_sgm8's profile")
        against(name, rec["ms_per_frame"], adjacent, refs[name])
        del Lh, Rh
    odo_runs = {
        "odometry untiled": (dict(), refs["odometry"]),
        "odometry tiled, make_mesh(1, 2)": (
            dict(tiled=True, mesh=dist.make_mesh(1, 2)),
            refs["odometry_core"] + refs["halo, 2 strips"]),
    }
    for what, (kw, earlier) in odo_runs.items():
        def run(profiled, kw=kw):
            return run_odometry_benchmark(PRESETS["kitti_odometry"],
                                          frames=4, iters=5, **kw)
        # the harness's own loop on its own inputs, for the host clock
        track_many, Lo, Ro, _, _ = odometry_loop(PRESETS["kitti_odometry"],
                                                 frames=4, **kw)
        rec, adjacent, _ = in_turns(what, run, lambda: track_many(Lo, Ro),
                                    4, 5)
        against(what, rec["ms_per_frame"], adjacent, earlier)
        del Lo, Ro
    what = "python -m tpustereo_torch.bench (batch 16)"
    L1, R1, _, _ = synthetic_pair(SHAPE, disparity=40.0, slope=0.02, seed=0)
    Lh, Rh = (torch.from_numpy(np.stack([x] * 16)).cuda() for x in (L1, R1))

    def call16():
        return sgbm_batched(Lh, Rh, cfg)
    host_before = host_ms(call16, 5)
    line = bench_main([])
    adjacent = (host_before + host_ms(call16, 5)) / 2 / 16
    sh = shares(roofline(cfg, SHAPE, 1.0 / line["value"],
                         torch.cuda.get_device_name(0)))
    print(f"[{card}] {what} roofline shares {sh}", flush=True)
    require(sh and all(0 < v <= 1 for v in sh.values()),
            f"{what}: a roofline share outside (0, 1]: {sh}")
    against(what, 1e3 / line["value"], adjacent, refs["kitti_sgm8"])
    del Lh, Rh

    # --- eval: the card's report against the CPU's on the same cases
    t0 = time.perf_counter()
    rep = evaluate(cfg, synthetic=True)
    cpu = [_eval_one(L, R, gt, cfg, name, False, False, "cpu")
           for name, L, R, gt in synthetic_cases(cfg, (192, 320))]
    print(f"[{card}] evaluate kitti_sgm8 on the card: {rep['pairs']}; mean "
          f"{rep['mean']} ({time.perf_counter() - t0:.1f} s with the CPU's)",
          flush=True)
    require(rep["pairs"] == cpu, "evaluate on the card differs from the CPU")

    # --- odometry through the CLI over KITTI trees on disk. Step 19's
    # first 10 frames written by the port (filter None): stopped after 5
    # and resumed from its checkpoint, against the uninterrupted run and
    # api.run_sequence. Then ms a frame over files, prefetch 0 and 2, on
    # that tree and on a static one of the committed libpng adaptive pair
    # (Paeth rows, as real dataset files), beside the arrays' own
    calib, frames = shared["calib"], shared["frames"][:10]
    fixture = [os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "data", f"adaptive_image_{s}.png")
               for s in (0, 1)]

    def kitti_tree(name: str, write, n: int = 10) -> list:
        """The `odometry` arguments over a KITTI tree of n frames with
        step 19's camera, frame i written by write(i, left, right path)."""
        return odometry_tree(os.path.join(work, name), calib, n, write)

    def timed(fn, n: int = 10):
        """fn()'s value and its ms a frame over n frames, by the host
        clock."""
        t0 = time.perf_counter()
        value = fn()
        return value, (time.perf_counter() - t0) / n * 1e3

    odo = kitti_tree("kitti", lambda i, lp, rp: [
        io.write_image(p, x) for p, x in zip((lp, rp), frames[i])])
    straight, resumed = (os.path.join(work, x) for x in ("s.txt", "r.txt"))
    ck = os.path.join(work, "ck.npz")
    cli_main(odo + ["--max-frames", "10", "--out", straight])
    cli_main(odo + ["--max-frames", "5", "--checkpoint", ck])
    cli_main(odo + ["--max-frames", "10", "--checkpoint", ck, "--resume",
                    "--out", resumed])
    a, r = np.loadtxt(straight), np.loadtxt(resumed)
    ms = {}
    ref, ms["arrays (api.run_sequence), step 19's frames"] = timed(
        lambda: api.run_sequence(frames, calib, PRESETS["kitti_odometry"]))
    d_resume = float(np.abs(a - r).max())
    d_api = float(np.abs(a - ref[:, :3, :].reshape(len(ref), 12)).max())
    print(f"[{card}] odometry CLI over 10 frames of {ODO_SHAPE}: resumed "
          f"after 5 against uninterrupted max |diff| {d_resume}; "
          f"uninterrupted against api.run_sequence {d_api}", flush=True)
    require(a.shape == r.shape == (10, 12) and np.isfinite(a).all(),
            "the CLI trajectory has the wrong shape or non-finite values")
    # the JAX resume test's tolerance; the .txt rows hold 7 digits
    require(d_resume <= 1e-5, "the resumed CLI run differs")
    require(d_api <= 1e-5, "the CLI run differs from api.run_sequence")

    # decode: the adaptive file (Paeth rows) against the port's
    # filter-None copy of the same image
    pair = [io.read_image_gray(p) for p in fixture]
    copy = os.path.join(work, "copy.png")
    io.write_image(copy, pair[0])
    require(np.array_equal(io.read_image_gray(copy), pair[0]),
            "the port's copy of the adaptive file decodes differently")
    read_ms = {}
    for what, path in (("adaptive", fixture[0]), ("filter None", copy)):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            io.read_image_gray(path)
            ts.append((time.perf_counter() - t0) * 1e3)
        read_ms[what] = float(np.median(ts))
    print(f"[{card}] read_image_gray of one {ODO_SHAPE} frame, median of 5 "
          f"by the host clock: {read_ms} ms; adaptive / filter None "
          f"{read_ms['adaptive'] / read_ms['filter None']:.2f}", flush=True)
    # the static adaptive tree holds 30 frames, so the CLI's start weighs
    # little in its ms a frame
    n_static = 30
    static = kitti_tree("adaptive", lambda i, lp, rp: [
        shutil.copyfile(s, d) for s, d in zip(fixture, (lp, rp))], n_static)

    def arrays_loop():
        return api.run_sequence([tuple(pair)] * n_static, calib,
                                PRESETS["kitti_odometry"])

    # what concurrent decode work costs the host-bound loop: the loop over
    # the adaptive pair beside the C unfilter called without a break, from
    # a thread of this process (which takes the interpreter lock between
    # calls) and from a process of its own (which shares only the cores)
    with open(fixture[0], "rb") as f:
        png = f.read()
    raw = np.frombuffer(zlib.decompress(b"".join(
        b for k, b in io._chunks(png, fixture[0]) if k == b"IDAT")), np.uint8)
    h, w = pair[0].shape

    def beside_thread():
        stop = threading.Event()

        def unfilter_loop():
            while not stop.is_set():
                native.png_unfilter(raw, h, w, 1)
        t = threading.Thread(target=unfilter_loop, daemon=True)
        t.start()
        try:
            return timed(arrays_loop, n_static)
        finally:
            stop.set()
            t.join()

    def beside_process():
        busy = subprocess.Popen([sys.executable, "-c", (
            "import zlib, numpy as np\n"
            "from tpustereo_torch import native\n"
            "from tpustereo_torch.data import io\n"
            f"png = open({fixture[0]!r}, 'rb').read()\n"
            "raw = np.frombuffer(zlib.decompress(b''.join(b for k, b in "
            "io._chunks(png, '') if k == b'IDAT')), np.uint8)\n"
            "print('ready', flush=True)\n"
            f"while True: native.png_unfilter(raw, {h}, {w}, 1)\n")],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, text=True)
        try:
            require(busy.stdout.readline().strip() == "ready",
                    "the unfilter process did not start")
            return timed(arrays_loop, n_static)
        finally:
            busy.kill()
            busy.wait()

    def cli_run(args, n_frames, n, out):
        return lambda: timed(lambda: cli_main(
            args + ["--max-frames", str(n_frames), "--prefetch", str(n),
                    "--out", out]), n_frames)

    cases = {"arrays, the adaptive pair": lambda: timed(arrays_loop,
                                                        n_static)}
    outs = {}
    for tree, args, n_frames in (("filter None", odo, 10),
                                 ("adaptive", static, n_static)):
        for n in (0, 2):
            outs[tree, n] = os.path.join(work, f"{tree[0]}{n}.txt")
            cases[f"CLI, {tree} files, prefetch {n}"] = cli_run(
                args, n_frames, n, outs[tree, n])
    # two designs of the prefetch over the adaptive tree's files: the
    # port's (prefetch_pairs, a thread of this process) and the decode in a
    # worker process forked here, `depth` 2 each
    files = [tuple(os.path.join(static[-1], "sequences", "00", sub,
                                f"{i:06d}.png")
                   for sub in ("image_0", "image_1"))
             for i in range(n_static)]

    def forked_decode(paths, depth: int = 2):
        ctx = multiprocessing.get_context("fork")
        q = ctx.Queue(depth)

        def work():
            for lp, rp in paths:
                q.put((io.read_image_gray(lp), io.read_image_gray(rp)))
            q.put(None)
            q.close()
            q.join_thread()
        proc = ctx.Process(target=work, daemon=True)
        proc.start()
        try:
            while (item := q.get(timeout=60)) is not None:
                yield item
        finally:
            proc.kill()
            proc.join()

    cases["files, decoded in a thread (prefetch_pairs, 2)"] = lambda: timed(
        lambda: api.run_sequence(prefetch_pairs(files, 2), calib,
                                 PRESETS["kitti_odometry"]), n_static)
    cases["files, decoded in a forked process (2)"] = lambda: timed(
        lambda: api.run_sequence(forked_decode(files), calib,
                                 PRESETS["kitti_odometry"]), n_static)
    cases["arrays, a thread running the C unfilter"] = beside_thread
    cases["arrays, a process running the C unfilter"] = beside_process
    # three rounds in turns, so that a drift of the host's speed within the
    # process weighs on every case alike; each case's median. The CLI and
    # `run_sequence` over the same files at the same prefetch also stamp
    # each tracked step on the host clock, which splits each run into a
    # per-run part (up to the first step, after the last) and a per-frame
    # part (from the first step to the last, over the frames)
    runs = {name: [] for name in cases}
    split_cases = ("CLI, adaptive files, prefetch 2",
                   "files, decoded in a thread (prefetch_pairs, 2)")
    splits = {name: [] for name in split_cases}
    stamps = []
    step0 = StereoOdometry.step

    def stamped(self, left, right):
        t0 = time.perf_counter()
        pose = step0(self, left, right)
        stamps.append((t0, time.perf_counter()))
        return pose

    # the cyclic collector's pauses in a case: ms and gen-2 collections
    pauses = {"ms": 0.0, "full": 0, "t0": 0.0}

    def collector(phase, info):
        if phase == "start":
            pauses["t0"] = time.perf_counter()
        else:
            pauses["ms"] += (time.perf_counter() - pauses["t0"]) * 1e3
            pauses["full"] += info["generation"] == 2

    StereoOdometry.step = stamped
    gc.callbacks.append(collector)
    try:
        for _ in range(3):
            for name, case in cases.items():
                stamps.clear()
                pauses.update(ms=0.0, full=0)
                t_a = time.perf_counter()
                value, t = case()
                t_b = time.perf_counter()
                runs[name].append(t)
                if name in splits:
                    n = len(stamps)
                    in_steps = sum(b - a for a, b in stamps)
                    splits[name].append((
                        (stamps[0][0] - t_a + t_b - stamps[-1][1]) * 1e3,
                        (stamps[-1][1] - stamps[0][0]) / n * 1e3,
                        in_steps / n * 1e3,
                        (stamps[-1][1] - stamps[0][0] - in_steps) / n * 1e3,
                        pauses["ms"], pauses["full"]))
                if name == "arrays, the adaptive pair":
                    want = value[:, :3, :].reshape(n_static, 12)
                elif name.startswith("files"):
                    require(np.abs(value[:, :3, :].reshape(n_static, 12)
                                   - want).max() <= 1e-5,
                            f"the odometry over the {name} differs")
    finally:
        StereoOdometry.step = step0
        gc.callbacks.remove(collector)
    ms.update({name: float(np.median(t)) for name, t in runs.items()})
    split = {name: tuple(float(np.median([r[i] for r in rs]))
                         for i in range(6)) for name, rs in splits.items()}
    cli_split, seq_split = (split[n] for n in split_cases)
    print(f"[{card}] the CLI's surplus over run_sequence on the same "
          f"{n_static} files at prefetch 2, host clock, medians of 3 rounds "
          f"in turns: per run {cli_split[0] - seq_split[0]:.2f} ms (CLI "
          f"{cli_split[0]:.2f}, run_sequence {seq_split[0]:.2f}: up to the "
          f"first step and after the last), per frame "
          f"{cli_split[1] - seq_split[1]:.3f} ms (CLI {cli_split[1]:.3f}, "
          f"run_sequence {seq_split[1]:.3f}: first step to last over the "
          f"frames); CLI / run_sequence "
          f"{ms[split_cases[0]] / ms[split_cases[1]]:.3f}", flush=True)
    for name in split_cases:
        r = split[name]
        print(f"[{card}] {name}: per run {r[0]:.2f} ms, per frame "
              f"{r[1]:.3f} ms (in the step {r[2]:.3f}, between steps "
              f"{r[3]:.3f}); the cyclic collector {r[4]:.2f} ms a run, "
              f"{r[5]:.0f} full collections", flush=True)
    first = []          # the forked worker's first pair: its start, a decode
    for _ in range(3):
        t0 = time.perf_counter()
        it = forked_decode(files[:2])
        next(it)
        first.append((time.perf_counter() - t0) * 1e3)
        it.close()
    trajs = {key: np.loadtxt(out) for key, out in outs.items()}
    quota = "not found"
    for q in ("/sys/fs/cgroup/cpu.max", "/sys/fs/cgroup/cpu/cpu.cfs_quota_us"):
        if os.path.exists(q):
            with open(q) as f:
                quota = f"{q}: {f.read().strip()}"
    print(f"[{card}] odometry over 10 frames (the adaptive pair and its "
          f"tree: {n_static}), ms a frame by the host clock (the process's "
          f"first frame included; from the adaptive pair on, the median of "
          f"3 rounds in turns; host: {len(os.sched_getaffinity(0))} usable "
          f"CPUs, CPU quota {quota}): {ms}", flush=True)
    p0, p2 = (ms[f"CLI, adaptive files, prefetch {n}"] for n in (0, 2))
    arrays_ms = ms["arrays, the adaptive pair"]
    ratio = {name: round(t / arrays_ms, 3) for name, t in ms.items()
             if name.startswith(("files", "arrays, a"))}
    print(f"[{card}] CLI over adaptive PNGs: prefetch 2 / prefetch 0 = "
          f"{p2 / p0:.3f}; prefetch 2 / arrays = {p2 / arrays_ms:.3f}; "
          f"against the arrays: {ratio}; the forked process's first pair "
          f"after {[round(t, 1) for t in first]} ms", flush=True)
    require(p2 <= p0, "prefetch 2 is slower than prefetch 0 over adaptive "
            "PNGs")
    for (tree, n), t in trajs.items():
        require(t.shape == ((10 if tree == "filter None" else n_static), 12)
                and np.isfinite(t).all(),
                f"the CLI over {tree} files, prefetch {n}: a bad trajectory")
        require(np.abs(t - (want if tree == "adaptive" else a)).max() <= 1e-5,
                f"the CLI over {tree} files, prefetch {n}, differs from the "
                f"same frames' run")
    shutil.rmtree(work)
    print(f"step 21: {time.perf_counter() - t_step:.1f} s", flush=True)


def _digest(a: np.ndarray) -> str:
    import hashlib
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def multirank_rank(spec: dict) -> dict:
    """Step 22 in one rank (`tpustereo_torch.dist.launch` starts it; the
    parent built the kernels): the multi-rank paths on the inputs the
    parent saved, each call's kernel launches and `dist.comm` messages on
    this rank, and its ms a frame by events. Rank 0 saves the outputs;
    every rank returns their digests."""
    import os

    import torch
    import torch.distributed as tdist
    from tpustereo_torch import PRESETS, api, dist, kernels
    from tpustereo_torch.data.datasets import KittiCalib
    from tpustereo_torch.dist import comm

    rank, n = tdist.get_rank(), tdist.get_world_size()
    inputs = np.load(os.path.join(spec["dir"], "inputs.npz"))
    dev = torch.device("cuda", torch.cuda.current_device())
    oL, oR = (torch.from_numpy(inputs[k]).to(dev)
              for k in ("odo_left", "odo_right"))
    kL, kR = (torch.from_numpy(inputs[k]).to(dev)
              for k in ("kitti_left", "kitti_right"))
    cfg = PRESETS["kitti_odometry"]
    exact = cfg.replace(exact_tiling=True)
    outs, res = {}, {}

    def run(name, fn, frames):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        comm.reset_counts()
        y = fn()
        torch.cuda.synchronize()
        res[name] = dict(launches=kernels.launch_counts(),
                         comm=comm.counts(), frames=frames,
                         ms=cuda_ms(fn, 3) / frames)
        outs[name] = y.cpu().numpy()

    if n == 2:
        mesh = dist.make_mesh(1, 2)
        run("halo, (1, 2)",
            lambda: dist.sgbm_tiled_batched(oL, oR, cfg, mesh), len(oL))
        run("exact, (1, 2)",
            lambda: dist.sgbm_tiled_batched(oL, oR, exact, mesh), len(oL))
        run("kitti_sgm8 data parallel, (2, 1)",
            lambda: dist.sgbm_data_parallel(kL, kR, PRESETS["kitti_sgm8"],
                                            dist.make_mesh(2, 1)), len(kL))
        run("wta_disparity_sharded, (1, 2)",
            lambda: dist.wta_disparity_sharded(
                kL[0], kR[0], PRESETS["middlebury_census_wta"], mesh), 1)
        frames = inputs["frames"]
        calib = KittiCalib(*inputs["calib"].tolist())
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        comm.reset_counts()
        t0 = time.perf_counter()
        outs["odometry"] = api.run_sequence(
            [(f[0], f[1]) for f in frames], calib, cfg, mesh=mesh)
        res["odometry"] = dict(launches=kernels.launch_counts(),
                               comm=comm.counts(), frames=len(frames),
                               ms=(time.perf_counter() - t0) * 1e3
                               / len(frames))
    else:
        run("exact, (1, 4)", lambda: dist.sgbm_tiled_batched(
            oL, oR, exact, dist.make_mesh(1, 4)), len(oL))
        run("halo, (2, 2)", lambda: dist.sgbm_tiled_batched(
            oL, oR, cfg, dist.make_mesh(2, 2)), len(oL))
    if rank == 0:
        np.savez(os.path.join(spec["dir"], f"out{n}_{spec['backend']}.npz"),
                 **{k.replace(" ", "_"): v for k, v in outs.items()})
    return {"res": res, "digests": {k: _digest(v) for k, v in outs.items()}}


def multirank_path(card: str, kitti: dict, shared: dict) -> dict:
    """Step 22: several ranks, one process each (see the module's
    docstring). `kitti` holds step 3's pairs and output, `shared` step
    19's sequence and step 20's pairs, outputs and tiled trajectory.
    Returns {kernel: extra keys of its row}."""
    import os
    import shutil
    import tempfile

    import torch
    from tpustereo_torch import PRESETS, dist
    from tpustereo_torch.dist.launch import launch
    from tpustereo_torch.eval.multihost import run_multihost_bench

    t_step = time.perf_counter()
    torch.cuda.empty_cache()
    tiled = shared["tiled"]
    calib = shared["calib"]
    work = tempfile.mkdtemp(prefix="step22_")
    np.savez(os.path.join(work, "inputs.npz"), odo_left=tiled["lefts"],
             odo_right=tiled["rights"], kitti_left=kitti["lefts"],
             kitti_right=kitti["rights"],
             frames=np.stack([np.stack(f) for f in shared["frames"]]),
             calib=np.array([calib.fx, calib.fy, calib.cx, calib.cy,
                             calib.baseline]))
    L, R = (torch.from_numpy(kitti[k][0]).cuda() for k in ("lefts",
                                                             "rights"))
    wcfg = PRESETS["middlebury_census_wta"]
    refs = {
        "halo, (1, 2)": tiled["halo"],
        "exact, (1, 2)": tiled["untiled"],
        "kitti_sgm8 data parallel, (2, 1)": kitti["out"],
        "wta_disparity_sharded, (1, 2)": dist.wta_disparity_sharded(
            L, R, wcfg, dist.make_mesh(1, 2)).cpu().numpy(),
        "odometry": shared["tiled_traj"],
        "exact, (1, 4)": tiled["untiled"],
        "halo, (2, 2)": tiled["halo"],
    }
    phases = [("gloo", 2), ("gloo", 4)]
    cards = torch.cuda.device_count()
    if cards >= 2:
        phases.append(("nccl", 2))
    rows = {}
    try:
        for backend, n in phases:
            t0 = time.perf_counter()
            ranks = launch(n, "chip_smoke:multirank_rank",
                           {"dir": work, "backend": backend},
                           backend=backend, device="cuda", timeout=300)
            wall = time.perf_counter() - t0
            got = np.load(os.path.join(work, f"out{n}_{backend}.npz"))
            share = "ranks sharing one card" if backend == "gloo" else \
                "one rank a card"
            for name, r0 in ranks[0]["res"].items():
                out = got[name.replace(" ", "_")]
                same = all(r["digests"][name] == ranks[0]["digests"][name]
                           for r in ranks)
                require(same, f"step 22 {name}: the ranks' outputs differ")
                require(np.array_equal(out, refs[name]),
                        f"step 22 {name} over {n} {backend} ranks differs "
                        f"from the one-process port")
                per_frame = {k: v["messages"] / r0["frames"]
                             for k, v in r0["comm"].items() if v["messages"]}
                kbytes = {k: v["bytes"] / r0["frames"] / 1e3
                          for k, v in r0["comm"].items() if v["bytes"]}
                ms = [round(r["res"][name]["ms"], 4) for r in ranks]
                clock = ("host clock" if name == "odometry"
                         else "CUDA events")
                print(f"[{card}] step 22, {n} {backend} ranks ({share}, not "
                      f"a scaling figure): {name} equal to the one-process "
                      f"port bit for bit on every rank; rank 0 per frame: "
                      f"messages {per_frame}, kB {kbytes}; ms a frame per "
                      f"rank by the {clock}: {ms}", flush=True)
                if name.startswith("exact"):
                    # rank 0 holds the top strip: it sends the down set's
                    # carry, one (3, F, W, D) int32 message a call (three
                    # before the fused carry)
                    F, W = len(tiled["lefts"]), ODO_SHAPE[1]
                    D = PRESETS["kitti_odometry"].num_disparities
                    require(r0["comm"]["carry"] == {
                        "messages": 1, "bytes": 3 * F * W * D * 4},
                        f"step 22 {name}: rank 0 sent carries "
                        f"{r0['comm']['carry']}, not one (3, {F}, {W}, {D}) "
                        f"message")
                if name == "halo, (1, 2)" and backend == "gloo":
                    for k in KERNELS:
                        require(r0["launches"][k] > 0, f"{k} was not "
                                f"launched on the multi-rank path")
                        rows[k] = {"multirank_launches_per_frame":
                                   r0["launches"][k] / r0["frames"]}
            print(f"step 22: {n} {backend} ranks in {wall:.1f} s (start, "
                  f"run and end)", flush=True)
        if cards < 2:
            print(f"step 22: the nccl phase (one rank a card) needs two "
                  f"cards; this machine has {cards}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    rec = run_multihost_bench(2, PRESETS["kitti_odometry"], shape=ODO_SHAPE,
                              batch=2, iters=5, timeout=300, tiled=True)
    require(rec["fps_total_1host"] > 0 and rec["fps_total_nhost"] > 0
            and abs(rec["fps_total_nhost"] / (2 * rec["fps_total_1host"])
                    - rec["value"]) <= 1e-3, f"multihost record {rec}")
    print(f"[{card}] step 22: run_multihost_bench(2, tiled=True) at "
          f"{ODO_SHAPE}, kitti_odometry, {rec['ranks']} {rec['transport']} "
          f"ranks (ranks share a card: {rec['ranks_share_a_card']}; "
          f"contention, not scaling): fps 1 host {rec['fps_total_1host']}, "
          f"2 hosts {rec['fps_total_nhost']}, value {rec['value']} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"step 22: {time.perf_counter() - t_step:.1f} s", flush=True)
    return rows


@contextlib.contextmanager
def captured_maps():
    """The disparity maps that `eval.runner._eval_one` makes inside the
    block, in call order: {"tpu": `api.match_pair`'s, "golden":
    `golden.sgbm_numpy`'s}. The runner looks both names up at each call."""
    from tpustereo_torch import api, golden
    maps = {"tpu": [], "golden": []}
    saved = api.match_pair, golden.sgbm_numpy

    def keep(key: str, fn):
        def run(*args, **kw):
            maps[key].append(fn(*args, **kw))
            return maps[key][-1]
        return run
    api.match_pair = keep("tpu", saved[0])
    golden.sgbm_numpy = keep("golden", saved[1])
    try:
        yield maps
    finally:
        api.match_pair, golden.sgbm_numpy = saved


def against_golden(what: str, card: np.ndarray, gold: np.ndarray,
                   ref: str = "golden") -> float:
    """max |card - golden| over the pixels both leave valid, as the
    runner's delta; requires the invalid patterns equal and the delta
    within DISP_TOL. `ref` names the map held against."""
    require(card.shape == gold.shape,
            f"{what}: the card's map {card.shape}, the {ref}'s {gold.shape}")
    differ = int(((card < 0) != (gold < 0)).sum())
    require(differ == 0, f"{what}: the card's invalid pattern differs from "
            f"the {ref}'s at {differ} pixels")
    both = card >= 0
    delta = float(np.abs(card - gold)[both].max()) if both.any() else 0.0
    require(delta <= DISP_TOL,
            f"{what}: max |card - {ref}| {delta} > {DISP_TOL}")
    return delta


def rate_pixels(card: np.ndarray, gold: np.ndarray, gt: np.ndarray,
                limit: int = 5) -> list:
    """Up to `limit` pixels of the truth where the card and the golden fall
    on different sides of a rate's threshold (bad-1.0, bad-2.0, D1), as
    (y, x, card, golden, truth)."""
    def wrong(d):
        err = np.abs(d - gt)
        return np.stack([err > 1.0, err > 2.0,
                         (err > 3.0) & (err > 0.05 * gt)]) | (d < 0)
    ys, xs = np.nonzero((wrong(card) != wrong(gold)).any(0) & (gt > 0))
    return [(int(y), int(x), float(card[y, x]), float(gold[y, x]),
             float(gt[y, x])) for y, x in zip(ys[:limit], xs[:limit])]


def pinned_suite(root: str) -> tuple:
    """(SUITE, RATE_TOL, EPE_TOL) of `tests/test_pinned_metrics.py`, read
    from its source, so the two suites cannot drift apart: the file imports
    the JAX package's config, which this script does not import. The
    values are literals and `dict(...)` calls."""
    import ast
    import os
    names = ("SUITE", "RATE_TOL", "EPE_TOL")
    with open(os.path.join(root, PINNED_TESTS)) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) in names):
            found[node.targets[0].id] = eval(
                compile(ast.Expression(node.value), PINNED_TESTS, "eval"),
                {"__builtins__": {}, "dict": dict})
    require(set(found) == set(names),
            f"{PINNED_TESTS} holds {sorted(found)}, not {names}")
    return tuple(found[n] for n in names)


def eval_surface_path(card: str, dev: str = "cuda") -> None:
    """Step 23: the evaluation surface on the card (see the module's
    docstring), on `dev`."""
    import os
    import shutil
    import signal
    import sys
    import tempfile
    from io import StringIO

    from tpustereo_torch import Config, PRESETS, api, kernels
    from tpustereo_torch.cli.main import main as cli_main
    from tpustereo_torch.data import io, synthetic_pair, synthetic_sequence
    from tpustereo_torch.data.datasets import load_middlebury_pair
    from tpustereo_torch.eval.matrix import ROWS, row_cases, run_matrix, table
    from tpustereo_torch.eval.metrics import bad, d1_all, end_point_error
    from tpustereo_torch.eval.runner import _metrics

    t_step = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    secs = {}

    def quiet(argv: list) -> str:
        """`cli.main(argv + ["--device", dev])`, its stdout kept out of
        the log: what it wrote to stderr."""
        out, err = StringIO(), StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            require(cli_main(argv + ["--device", dev]) == 0,
                    f"cli {argv[0]} exited non-zero")
        return err.getvalue()

    def launched() -> dict:
        return {k: v for k, v in kernels.launch_counts().items() if v}

    # --- (a) the 13 rows against the golden, pair by pair, and against the
    # stored record
    t0 = time.perf_counter()
    with open(os.path.join(here, EVAL_RECORD)) as f:
        stored = json.load(f)
    require([n for n, _, _ in ROWS] == list(stored),
            f"the matrix's rows are not those of {EVAL_RECORD}")
    records, reached, off = {}, set(), []
    for name, cfg, shape in ROWS:
        kernels.reset_launch_counts()
        with captured_maps() as maps:
            rec = run_matrix(dev, [name])[name]
        counts = launched()
        reached |= set(counts)
        cases = row_cases(cfg, shape)
        require(len(maps["tpu"]) == len(maps["golden"]) == len(cases)
                == rec["pairs"] == 3, f"{name}: not 3 pairs and 3 goldens")
        deltas = [against_golden(f"{name}, {case[0]}", t, g)
                  for case, t, g in zip(cases, maps["tpu"], maps["golden"])]
        require(max(deltas) == rec["golden_max_abs"],
                f"{name}: the record's golden delta is not the maps'")
        records[name] = rec
        got, want = rec["mean"], stored[name]["mean"]
        rates = [k for k in ("d1_all", "bad_2.0", "bad_1.0")
                 if got[k] != want[k]]
        d_epe = abs(got["epe"] - want["epe"])
        print(f"[{card}] step 23 {name}: mean {got}, record {want}; max "
              f"|card - golden| {max(deltas)} (exactly 0.0: "
              f"{max(deltas) == 0.0}), invalid patterns equal on "
              f"{rec['pairs']} pairs; {rec['wall_s']} s; launched {counts}",
              flush=True)
        if rates or d_epe > EPE_MEAN_TOL:
            golden_mean = {k: round(float(np.mean(
                [_metrics(g, case[3])[k] for case, g in
                 zip(cases, maps["golden"])])), 5) for k in got}
            print(f"  {name}: {rates} differ from the record, EPE by "
                  f"{d_epe}; the golden's own mean here {golden_mean}",
                  flush=True)
            for case, t, g in zip(cases, maps["tpu"], maps["golden"]):
                print(f"  {case[0]}: pixels (y, x, card, golden, truth) on "
                      f"either side of a rate's threshold: "
                      f"{rate_pixels(t, g, case[3])}", flush=True)
            off.append(name)
    print(f"[{card}] step 23: the evaluation matrix on the card\n"
          f"{table(records)}", flush=True)
    require(not off, f"rows whose mean differs from {EVAL_RECORD}: {off}")
    missing = [k for k in EVAL_KERNELS if k not in reached]
    require(not missing, f"the matrix launched none of {missing}")
    secs["(a) matrix"] = round(time.perf_counter() - t0, 1)

    # --- (b) the pinned points against the stored values, and the card's
    # invalid pattern against the CPU's
    t0 = time.perf_counter()
    suite, rate_tol, epe_tol = pinned_suite(here)
    with open(os.path.join(here, PINNED_RECORD)) as f:
        pinned = json.load(f)
    require(set(pinned) == {n for n, _, _ in suite},
            f"{PINNED_RECORD} does not cover the suite")
    for name, pair_kw, cfg_kw in suite:
        L, R, gt, mask = synthetic_pair(**pair_kw)
        gtm = np.where(mask, gt, -1.0).astype(np.float32)
        cfg = Config(**cfg_kw)
        disp = api.match_pair(L, R, cfg, device=dev)
        cpu = api.match_pair(L, R, cfg, device="cpu")
        got = {"bad2": round(float(bad(disp, gtm)), 6),
               "d1_all": round(float(d1_all(disp, gtm)), 6),
               "epe": round(float(end_point_error(disp, gtm)), 6),
               "valid_frac": round(float((disp >= 0).mean()), 6)}
        want = pinned[name]
        wide = [k for k in ("bad2", "d1_all", "valid_frac")
                if abs(got[k] - want[k]) > rate_tol]
        wide += ["epe"] * (abs(got["epe"] - want["epe"]) > epe_tol)
        print(f"[{card}] step 23 pinned {name}: {got}, stored {want}",
              flush=True)
        require(not wide, f"pinned point {name}: {wide} outside "
                f"{rate_tol} / {epe_tol} of {PINNED_RECORD}")
        against_golden(f"pinned point {name}", disp, cpu, ref="CPU")
    secs["(b) pinned"] = round(time.perf_counter() - t0, 1)

    # --- (c) the KITTI 2015 recipe at full size through the CLI
    t0 = time.perf_counter()
    root = os.path.join(work, "kitti2015")
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, "training", sub))
    for i in range(2):
        L, R, gt, valid = synthetic_pair(SHAPE, disparity=40.0 + i,
                                         slope=0.04, seed=40 + i)
        name = f"{i:06d}_10.png"
        io.write_image(os.path.join(root, "training", "image_2", name), L)
        io.write_image(os.path.join(root, "training", "image_3", name), R)
        io.write_kitti_disparity(
            os.path.join(root, "training", "disp_occ_0", name),
            np.where(valid & (gt > 0), gt, -1.0))
    rec_path = os.path.join(work, "EVAL_kitti2015.jsonl")
    kernels.reset_launch_counts()
    with captured_maps() as maps:
        quiet(["eval", "--preset", "kitti_sgm8", "--kitti2015", root,
               "--indices", "0-1", "--golden", "--record", rec_path])
    counts = launched()
    with open(rec_path) as f:
        report = json.loads(f.read().splitlines()[-1])
    require([p["pair"] for p in report["pairs"]]
            == ["kitti2015_000000", "kitti2015_000001"],
            f"the KITTI 2015 record's pairs: {report['pairs']}")
    require(len(maps["tpu"]) == len(maps["golden"]) == 2,
            "the KITTI 2015 recipe did not match 2 pairs with the golden")
    for p, t, g in zip(report["pairs"], maps["tpu"], maps["golden"]):
        d = against_golden(f"KITTI 2015 recipe, {p['pair']}", t, g)
        require(p["shape"] == list(SHAPE) and p["tpu_vs_golden_max_abs"]
                == d, f"{p['pair']}: the record's shape or delta")
        require(p["tpu"] == p["golden"],
                f"{p['pair']}: the card's metrics {p['tpu']} are not the "
                f"golden's {p['golden']}")
        print(f"[{card}] step 23 KITTI 2015 recipe, kitti_sgm8 as shipped, "
              f"{p['pair']} {p['shape']}: card {p['tpu']} = golden; max "
              f"|card - golden| {d}, invalid patterns equal", flush=True)
    print(f"[{card}] step 23 KITTI 2015 recipe: mean {report['mean']}; "
          f"launched {counts}", flush=True)
    secs["(c) KITTI 2015"] = round(time.perf_counter() - t0, 1)

    # --- (d) the Middlebury recipe: full resolution against match_pair,
    # half resolution against the golden
    t0 = time.perf_counter()
    scene = os.path.join(work, "middlebury", "Synthetic")
    os.makedirs(scene)
    L, R, gt, valid = synthetic_pair(MIDDLEBURY[0], disparity=MIDDLEBURY[1],
                                     slope=0.02, seed=0)
    io.write_image(os.path.join(scene, "im0.png"), L)
    io.write_image(os.path.join(scene, "im1.png"), R)
    io.write_pfm(os.path.join(scene, "disp0GT.pfm"),
                 np.where(valid & (gt > 0), gt, np.inf).astype(np.float32))
    recipe = ["eval", "--preset", "middlebury_sgm4", "--middlebury", scene]
    rec_path = os.path.join(work, "EVAL_middlebury.jsonl")
    with captured_maps() as maps:
        quiet(recipe + ["--record", rec_path])
    Ld, Rd, _ = load_middlebury_pair(scene)
    require(np.array_equal(Ld, L) and np.array_equal(Rd, R),
            "the Middlebury images decode differently from those written")
    want = api.match_pair(Ld, Rd, PRESETS["middlebury_sgm4"], device=dev)
    require(len(maps["tpu"]) == 1 and not maps["golden"]
            and np.array_equal(maps["tpu"][0].view(np.int32),
                               want.view(np.int32)),
            "the Middlebury recipe's disparity differs from api.match_pair")
    with captured_maps() as maps:
        quiet(recipe + ["--half-res", "--golden", "--record", rec_path])
    with open(rec_path) as f:
        full, half = (json.loads(x)["pairs"][0]
                      for x in f.read().splitlines())
    require(full["shape"] == list(MIDDLEBURY[0])
            and half["shape"] == [MIDDLEBURY[0][0] // 2,
                                  MIDDLEBURY[0][1] // 2],
            f"the Middlebury records' shapes {full['shape']} "
            f"{half['shape']}")
    require(len(maps["tpu"]) == len(maps["golden"]) == 1,
            "the half-resolution recipe did not run the golden once")
    d = against_golden("Middlebury recipe, half resolution", maps["tpu"][0],
                       maps["golden"][0])
    require(half["tpu_vs_golden_max_abs"] == d,
            "the half-resolution record's delta is not the maps'")
    print(f"[{card}] step 23 Middlebury recipe, middlebury_sgm4 as shipped: "
          f"{full['shape']} {full['tpu']}, equal to api.match_pair bit for "
          f"bit; --half-res --golden {half['shape']} card {half['tpu']}, "
          f"golden {half['golden']}, max |card - golden| {d}, invalid "
          f"patterns equal", flush=True)
    secs["(d) Middlebury"] = round(time.perf_counter() - t0, 1)

    # --- (e) a CLI odometry process killed after its first checkpoint,
    # resumed, against the uninterrupted run
    t0 = time.perf_counter()
    calib, frames, _ = synthetic_sequence(
        n_frames=KILL_FRAMES, shape=ODO_SHAPE, step_x=ODO_STEP, seed=0,
        **ODO_CAM)
    args = odometry_tree(
        os.path.join(work, "odometry"), calib, KILL_FRAMES,
        lambda i, lp, rp: [io.write_image(p, x)
                           for p, x in zip((lp, rp), frames[i])])
    args += ["--max-frames", str(KILL_FRAMES)]
    straight, resumed, ck = (os.path.join(work, x)
                             for x in ("s.txt", "r.txt", "ck.npz"))
    quiet(args + ["--out", straight])
    killed, rc = False, None
    with open(os.path.join(work, "killed.err"), "w") as err:
        p = subprocess.Popen(
            [sys.executable, "-m", "tpustereo_torch.cli"] + args
            + ["--checkpoint", ck, "--checkpoint-every", "1", "--device",
               dev],
            cwd=here, stdout=subprocess.DEVNULL, stderr=err)
        try:
            deadline = time.time() + 300
            while time.time() < deadline and p.poll() is None:
                # the checkpoint is written whole, then renamed into place
                if os.path.exists(ck):
                    os.kill(p.pid, signal.SIGKILL)
                    killed = True
                    break
                time.sleep(0.005)
            rc = p.wait(timeout=60)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(os.path.join(work, "killed.err")) as f:
        tail = f.read()[-2000:]
    require(killed and rc == -signal.SIGKILL,
            f"the odometry process was not killed after a checkpoint (rc "
            f"{rc}): {tail}")
    with np.load(ck) as z:
        start = int(z["frames"])
    require(0 < start < KILL_FRAMES,
            f"the checkpoint holds {start} of {KILL_FRAMES} frames")
    err_text = quiet(args + ["--checkpoint", ck, "--resume", "--out",
                             resumed])
    require(f"resumed at frame {start}" in err_text,
            f"the resumed run did not start at frame {start}")
    a, r = np.loadtxt(straight), np.loadtxt(resumed)
    require(a.shape == r.shape == (KILL_FRAMES, 12) and np.isfinite(a).all(),
            "the odometry trajectories have the wrong shape or non-finite "
            "values")
    d_kill = float(np.abs(a - r).max())
    print(f"[{card}] step 23 odometry CLI over {KILL_FRAMES} frames of "
          f"{ODO_SHAPE}: the process SIGKILLed after its checkpoint of "
          f"frame {start}, resumed: max |resumed - uninterrupted| {d_kill}",
          flush=True)
    # the JAX test's tolerance; the .txt rows hold 7 digits
    require(d_kill <= 1e-5, "the resumed odometry differs")
    secs["(e) killed odometry"] = round(time.perf_counter() - t0, 1)

    shutil.rmtree(work, ignore_errors=True)
    print(f"[{card}] step 23 seconds by part: {secs}", flush=True)
    print(f"step 23: {time.perf_counter() - t_step:.1f} s", flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = card_line()
    print(card, flush=True)

    from tpustereo_torch import PRESETS, api, kernels
    from tpustereo_torch.kernels import _build
    from tpustereo_torch.kernels.cost import census_cost_volume_plain
    from tpustereo_torch.kernels.lr import dr_consistency_plain
    from tpustereo_torch.kernels.sgm import (FUSED_MAX_D, VERTICAL_DXS,
                                             _vertical_sets,
                                             sgm_sweep_fused_plain,
                                             sgm_sweep_plain,
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
    lefts, rights, gts = synthetic_pairs(SHAPE, 40.0, BATCH)
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
    # one 2 x 9,000 frame: past the 8,940 columns of the kernel's old design
    Lw, Rw = (torch.from_numpy(np.random.default_rng(s).integers(
        0, 256, (1, 2, 9000), dtype=np.uint8)).to(dev) for s in (1, 2))
    require(torch.equal(
        kernels.census_cost_volume(Lw, Rw, D, cfg.max_census_cost,
                                   cfg.census_window, d0),
        census_cost_volume_plain(Lw, Rw, D, cfg.max_census_cost,
                                 cfg.census_window, d0)),
        "census_cost_volume differs from plain at 9,000 columns")
    del Lw, Rw

    # both sweep forms in every direction: the write form (S = L_r), then
    # the add form on the partial sum S7 of the directions before it (on
    # L_r itself for the first); S7 ends as the sum of all but W
    S7 = None
    sweep_err = 0
    for dy, dx in DIRS_8:
        L_k = kernels.sgm_sweep(C, None, dy, dx, p1, p2)
        L_p = sgm_sweep_plain(C, None, dy, dx, p1, p2)
        torch.cuda.synchronize()
        require(torch.equal(L_k, L_p),
                f"sgm_sweep {(dy, dx)} write form differs")
        base = L_k if S7 is None else S7
        S_k = kernels.sgm_sweep(C, base.clone(), dy, dx, p1, p2)
        S_p = sgm_sweep_plain(C, base.clone(), dy, dx, p1, p2)
        torch.cuda.synchronize()
        require(torch.equal(S_k, S_p), f"sgm_sweep {(dy, dx)} add form "
                f"differs")
        sweep_err = max(sweep_err, int_err(L_k, L_p), int_err(S_k, S_p))
        if (dy, dx) != (0, -1):
            S7 = L_k if S7 is None else S_k
        del L_k, L_p, S_k, S_p, base
    err["sgm_sweep"] = sweep_err
    # the fused sweep in both orders and forms: one set written, the other
    # added onto it (the main path's down write and up add, and the reverse)
    fused_err = 0
    for first in (1, -1):
        S_k = kernels.sgm_sweep_fused(C, None, first, VERTICAL_DXS, p1, p2)
        S_p = sgm_sweep_fused_plain(C, None, first, VERTICAL_DXS, p1, p2)
        torch.cuda.synchronize()
        require(torch.equal(S_k, S_p),
                f"sgm_sweep_fused dy={first} write form differs")
        fused_err = max(fused_err, int_err(S_k, S_p))
        kernels.sgm_sweep_fused(C, S_k, -first, VERTICAL_DXS, p1, p2)
        sgm_sweep_fused_plain(C, S_p, -first, VERTICAL_DXS, p1, p2)
        torch.cuda.synchronize()
        require(torch.equal(S_k, S_p),
                f"sgm_sweep_fused dy={-first} add form differs")
        fused_err = max(fused_err, int_err(S_k, S_p))
        del S_k, S_p
    # a frame with more tiles than the card holds blocks (D = 512: tiles of
    # 8 columns), which each block walks several of, band by band, and the
    # same frame at D = 256; at both D the 8-path vertical sets as
    # `sgm_select` runs them (`vertical_orders`: past FUSED_MAX_D the six
    # one-direction launches, decided from D) beside the fused pair, in
    # turns
    gen = torch.Generator(device=C.device).manual_seed(17)
    for Dw in (256, 512):
        C_w = torch.randint(0, 25, (1, 375, 1242, Dw), generator=gen,
                            device=C.device, dtype=torch.uint8)
        S_k = kernels.sgm_sweep_fused(C_w, None, 1, VERTICAL_DXS, p1, p2)
        S_p = sgm_sweep_fused_plain(C_w, None, 1, VERTICAL_DXS, p1, p2)
        kernels.sgm_sweep_fused(C_w, S_k, -1, VERTICAL_DXS, p1, p2)
        sgm_sweep_fused_plain(C_w, S_p, -1, VERTICAL_DXS, p1, p2)
        torch.cuda.synchronize()
        require(torch.equal(S_k, S_p), f"sgm_sweep_fused differs on a 1 x "
                f"375 x 1242 frame at D = {Dw}")
        fused_err = max(fused_err, int_err(S_k, S_p))
        del S_p, S_k

        def fused_pair(C_w=C_w):
            S = kernels.sgm_sweep_fused(C_w, None, 1, VERTICAL_DXS, p1, p2)
            return kernels.sgm_sweep_fused(C_w, S, -1, VERTICAL_DXS, p1, p2)

        def route(C_w=C_w):
            return _vertical_sets(C_w, p1, p2, None)
        kernels.reset_launch_counts()
        require(torch.equal(route(), fused_pair()), f"the vertical sets at "
                f"D = {Dw} differ from the fused pair")
        routed = kernels.launch_counts()
        fused_route = Dw <= FUSED_MAX_D
        require(routed["sgm_sweep_fused"] == 2 + 2 * fused_route
                and routed["sgm_sweep"] == 6 * (not fused_route),
                f"the vertical sets at D = {Dw} did not take the route "
                f"decided from D: {routed}")
        turns = [("route", route), ("fused pair", fused_pair),
                 ("fused pair", fused_pair), ("route", route)]
        ms = [(k, round(cuda_ms(fn, 3), 4)) for k, fn in turns]
        how = "fused" if fused_route else "six one-direction launches"
        print(f"[{card}] 1 x 375 x 1242 at D = {Dw}: the vertical sets as "
              f"sgm_select runs them ({how}) and the fused pair, ms by "
              f"events in turns: {ms}; byte "
              f"bound a fused write "
              f"{bound(3 * C_w.numel(), 27 * C_w.numel())[0]:.4f}",
              flush=True)
        del C_w
    err["sgm_sweep_fused"] = fused_err

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
    require(torch.equal(med.view(torch.int32), med_p.view(torch.int32)),
            "median3 differs from plain")
    err["median3"] = (med - med_p).abs().max().item()
    # the same shape of +-0.0, +-1 and 2: bit for bit where zeros of both
    # signs meet
    zs = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0], device=dev)[
        torch.randint(0, 5, med_in.shape, device=dev,
                      generator=torch.Generator(dev).manual_seed(0))]
    require(torch.equal(kernels.median3(zs).view(torch.int32),
                        median3(zs).view(torch.int32)),
            "median3 differs from plain on signed zeros")
    del med_p, zs
    for name, e in err.items():
        print(f"check {name}: max abs diff to plain = {e}", flush=True)

    # --- 2. the main path, through the user's entry point
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = api.match_batch(lefts, rights, cfg)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    sweep_forms = dict(kernels.sgm_sweep.builds)
    fused_forms = dict(kernels.sgm_sweep_fused.builds)
    # the path's own peak, above what the checks above keep allocated
    peak_gib = (torch.cuda.max_memory_allocated() - resident) / 2**30
    print(f"main path launches: {launches}; sgm_sweep forms: "
          f"{sweep_forms}; sgm_sweep_fused forms: {fused_forms}", flush=True)
    for name in KERNELS:
        require(launches[name] > 0, f"{name} was not launched on the main "
                f"path")
    # a set of frames: the down set fused writes S7, the up set fused adds
    # to it, and E, the one direction left, adds by the one-direction kernel
    zero = dict.fromkeys(sweep_forms, 0)
    require(fused_forms == dict(zero, write=BATCH // F, add=BATCH // F),
            f"the main path's fused sweeps ran {fused_forms}, not one write "
            f"and one add a set of frames")
    require(sweep_forms == dict(zero, add=BATCH // F),
            f"the main path's one-direction sweeps ran {sweep_forms}, not "
            f"the E add alone a set of frames")
    require(out.shape == (BATCH, H, W) and np.isfinite(out).all(),
            "match_batch output has the wrong shape or non-finite values")

    ref = np.concatenate([plain_pipeline(L[i:i + F], R[i:i + F], cfg)
                          .cpu().numpy() for i in range(0, BATCH, F)])
    require(np.array_equal(out == -1.0, ref == -1.0),
            "invalid pattern differs from the plain pipeline")
    path_err = float(np.abs(out - ref).max())
    require(path_err <= DISP_TOL, "disparity differs from the plain pipeline")
    vfrac, bad2 = quality(out, gts)
    print(f"main path vs plain pipeline: max abs diff {path_err}; valid "
          f"fraction {vfrac:.4f}; bad-2.0 vs ground truth {bad2:.4f}",
          flush=True)
    # the bar the JAX package's drive recipe sets on synthetic pairs
    require(vfrac > 0.9 and bad2 < 0.05,
            "main path output is not a good disparity map")

    # --- 3. timing, at the main path's shapes (the add form accumulates
    # into a scratch S, so S7 stays as checked)
    dirs7 = [r for r in DIRS_8 if r != (0, -1)]
    S_tmp = S7.clone()

    def sweeps():
        # one set of frames' seven sweeps one direction a launch, the
        # schedule before the fused kernel
        S = kernels.sgm_sweep(C, None, *dirs7[0], p1, p2)
        for dy, dx in dirs7[1:]:
            kernels.sgm_sweep(C, S, dy, dx, p1, p2)
        return S

    def fused_sweeps():
        # the same S7 as `sgm_select` makes it: two fused passes and E
        S = kernels.sgm_sweep_fused(C, None, 1, VERTICAL_DXS, p1, p2)
        kernels.sgm_sweep_fused(C, S, -1, VERTICAL_DXS, p1, p2)
        kernels.sgm_sweep(C, S, 0, 1, p1, p2)
        return S

    require(torch.equal(sweeps(), fused_sweeps()),
            "the fused schedule's S7 differs from the seven launches'")
    fused_one = {
        "down write": lambda: kernels.sgm_sweep_fused(
            C, None, 1, VERTICAL_DXS, p1, p2),
        "up add": lambda: kernels.sgm_sweep_fused(
            C, S_tmp, -1, VERTICAL_DXS, p1, p2),
    }
    e_add = cuda_ms(lambda: kernels.sgm_sweep(C, S_tmp, 0, 1, p1, p2), 10)
    ms = {
        "census_cost_volume": cuda_ms(lambda: kernels.census_cost_volume(
            Lf, Rf, D, cfg.max_census_cost, cfg.census_window, d0), 20),
        # what the main path launches: E in the add form
        "sgm_sweep": e_add,
        "sgm_sweep_fused": sum(cuda_ms(f, 10) for f in fused_one.values())
        / len(fused_one),
        "sweep_bwd_wta": cuda_ms(lambda: kernels.sweep_bwd_wta(C, S7, cfg),
                                 10),
        "dr_consistency": cuda_ms(lambda: kernels.dr_consistency(
            d_r, disp, D, cfg.disp12_max_diff, d0), 50),
        "connected_component_labels": cuda_ms(
            lambda: kernels.connected_component_labels(conn_h, conn_v), 20),
        "median3": cuda_ms(lambda: kernels.median3(med_in), 50),
    }
    # device time of the three short kernels: their event times above are
    # the host's time per launch through the wrappers where that is longer
    g_ms = {
        "dr_consistency": graph_ms(lambda: kernels.dr_consistency(
            d_r, disp, D, cfg.disp12_max_diff, d0), 50),
        "connected_component_labels": graph_ms(
            lambda: kernels.connected_component_labels(conn_h, conn_v), 50),
        "median3": graph_ms(lambda: kernels.median3(med_in), 50),
    }
    print(f"[{card}] ms per launch by CUDA-graph replay: {g_ms}; by "
          f"events: { {n: ms[n] for n in g_ms} }", flush=True)
    cc_names = device_kernels(
        lambda: kernels.connected_component_labels(conn_h, conn_v))
    print(f"connected_component_labels: {len(cc_names)} kernel launches a "
          f"call (profiler): {[n[:40] for n in cc_names]}", flush=True)
    # each direction in each form, by events and by CUDA-graph replay,
    # beside its byte bound (3 bytes a cost written, 5 added)
    for dy, dx in DIRS_8:
        for form, nbytes in (("write", 3), ("add", 5)):
            S_in = None if form == "write" else S_tmp

            def one(dy=dy, dx=dx, S_in=S_in):
                kernels.sgm_sweep(C, S_in, dy, dx, p1, p2)
            print(f"[{card}] sgm_sweep {dy},{dx} {form}: events "
                  f"{cuda_ms(one, 5):.4f} ms, graph replay "
                  f"{graph_ms(one, 5):.4f} ms, bound "
                  f"{bound(nbytes * n_cost, 9 * n_cost)[0]:.4f} ms",
                  flush=True)
    # the fused launches beside their bounds, then a set's sweeps and
    # `sgm_select` both ways in turns on the same volume: the package's
    # fused schedule against the seven one-direction launches (composed
    # here from `kernels.sgm_sweep`); the set's function bound is one read
    # of C: the down set written, the up set and E added
    fused_bounds = {"down write": bound(3 * n_cost, 27 * n_cost)[0],
                    "up add": bound(5 * n_cost, 27 * n_cost)[0]}
    for what, fn in fused_one.items():
        print(f"[{card}] sgm_sweep_fused {what}: events "
              f"{cuda_ms(fn, 10):.4f} ms, graph replay "
              f"{graph_ms(fn, 10):.4f} ms, bound {fused_bounds[what]:.4f} "
              f"ms", flush=True)
    set_bound = (fused_bounds["down write"] + fused_bounds["up add"]
                 + bound(5 * n_cost, 9 * n_cost)[0])
    set_ms, select_ms = {}, {}
    for kind in ("seven", "fused", "fused2", "seven2"):
        fn = sweeps if kind.startswith("seven") else fused_sweeps
        set_ms[kind] = cuda_ms(fn, 5)
        select_ms[kind] = cuda_ms(
            (lambda: kernels.sweep_bwd_wta(C, sweeps(), cfg))
            if kind.startswith("seven") else
            (lambda: kernels.sgm_select(C, cfg)), 5)
    print(f"[{card}] a set's sweeps at KITTI F={F} by events, in turns: "
          f"fused (2 fused + E) {set_ms['fused']:.4f}, "
          f"{set_ms['fused2']:.4f} ms; seven one-direction launches "
          f"{set_ms['seven']:.4f}, {set_ms['seven2']:.4f} ms; the "
          f"function's bound {set_bound:.4f} ms", flush=True)
    print(f"[{card}] sgm_select at KITTI F={F} by events, in turns: the "
          f"package's fused schedule {select_ms['fused']:.4f}, "
          f"{select_ms['fused2']:.4f} ms; seven launches + sweep_bwd_wta "
          f"{select_ms['seven']:.4f}, {select_ms['seven2']:.4f} ms",
          flush=True)
    require(max(set_ms["fused"], set_ms["fused2"])
            < min(set_ms["seven"], set_ms["seven2"]),
            "the fused set is not faster than the seven launches")
    require(max(select_ms["fused"], select_ms["fused2"])
            < min(select_ms["seven"], select_ms["seven2"]),
            "sgm_select is not faster than the seven-launch composition")
    plain_ms = {
        "census_cost_volume": cuda_ms(lambda: census_cost_volume_plain(
            Lf, Rf, D, cfg.max_census_cost, cfg.census_window, d0), 2),
        "sgm_sweep": cuda_ms(
            lambda: sgm_sweep_plain(C, S_tmp, 0, 1, p1, p2), 1, warmup=0),
        "sgm_sweep_fused": cuda_ms(lambda: sgm_sweep_fused_plain(
            C, S_tmp, -1, VERTICAL_DXS, p1, p2), 1, warmup=0),
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
        # C and S read and S written (E, the add form); ~9 integer ops a
        # cost
        "sgm_sweep": bound(5 * n_cost, 9 * n_cost),
        # the mean of the down write (C read, S written) and the up add
        # (C and S read, S written); ~9 ops a cost and direction
        "sgm_sweep_fused": bound(4 * n_cost, 27 * n_cost),
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
          f"{BATCH}, by events; 7.586-7.596 ms with seven sweep launches "
          f"a set, an earlier schedule); {api_fps:.2f} frames/s through "
          f"match_batch (numpy in/out); peak memory {peak_gib:.2f} GiB",
          flush=True)
    print(f"[{card}] whole path, speckle and median off: "
          f"{BATCH * 1e3 / off_ms:.2f} frames/s on device tensors "
          f"({off_ms:.3f} ms per batch of {BATCH}); the two stages cost "
          f"{dev_ms - off_ms:.3f} ms per batch", flush=True)
    in_kernels = {n: launches[n] * ms[n] for n in KERNELS}
    print(f"[{card}] batch of {BATCH}, ms in each kernel (launches x "
          f"ms/launch): {in_kernels}; component_big "
          f"{BATCH // F * big_ms:.3f} ms; outside the seven kernels "
          f"(component_big included): "
          f"{dev_ms - sum(in_kernels.values()):.3f} ms", flush=True)
    busy = device_busy(lambda: sgbm_batched(L, R, cfg))
    print(f"[{card}] profiler, one batch: {busy}", flush=True)
    fills = volume_fills(lambda: sgbm_batched(L, R, cfg), n_cost)
    fill_kernels = [k for k in device_kernels(lambda: sgbm_batched(L, R, cfg))
                    if "fill" in k.lower()]
    print(f"fills of a (F, H, W, D) volume in one batch: {fills}; fill "
          f"kernels in the batch (profiler): {len(fill_kernels)} "
          f"{sorted(set(k[:80] for k in fill_kernels))}", flush=True)
    require(not fills, "the main path fills a volume the size of S7")

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
    # each path's ms a frame by events, for step 21's harness records
    refs = {"kitti_sgm8": dev_ms / BATCH}
    rows += modes_path(card, refs)
    kitti = dict(lefts=lefts, rights=rights, gts=gts, L=L, R=R, out=out,
                 C=C, refs=refs)
    rows += volume_path(card, kitti)
    rows += fills_path(card, dict(kitti, d_r=d_r, disp=disp, lab=lab,
                                  gaps=med_in))
    t_steps = time.perf_counter()
    sad_wide_path(card)
    rows += micro_path(card)
    print(f"steps 16-17: {time.perf_counter() - t_steps:.1f} s", flush=True)
    # the sweeps and sweep_bwd_wta also carry the adaptive path's launches
    # and ms a launch
    for name, (n, a_ms) in adaptive_path(card, kitti).items():
        row = next(r for r in rows if r["name"] == name)
        row.update(adaptive_launches=n, adaptive_ms=a_ms)
    # the KITTI seven also carry their launches on the odometry path
    per_set = {n: launches[n] // (BATCH // F) for n in KERNELS}
    shared: dict = {"refs": refs}
    for name, n in odometry_path(card, per_set, shared).items():
        next(r for r in rows if r["name"] == name)["odometry_launches"] = n
    # ... and on the strip-tiled odometry; sgm_sweep also its carry forms
    for name, extra in tiled_path(card, per_set, shared).items():
        next(r for r in rows if r["name"] == name).update(extra)
    entry_points_path(card, shared)
    # the KITTI seven also carry their launches a frame on one of 2 ranks
    for name, extra in multirank_path(card, kitti, shared).items():
        next(r for r in rows if r["name"] == name).update(extra)
    eval_surface_path(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
