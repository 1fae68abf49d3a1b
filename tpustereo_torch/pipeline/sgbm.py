"""End-to-end stereo pipeline (the part of the JAX `pipeline/sgbm.py` the
port runs so far): a cost and selection stage per mode, then the LR check,
speckle, the gap fill and the 3x3 median.

Mirrors the JAX fused branches of `sgbm` and `sgbm_frames`, then
`_postproc_frames`:

* 'sgm': the census cost volume, the directional sweeps accumulated into
  one int16 S7, the backward sweep fused with WTA / uniqueness / subpixel /
  d_R, then `valid &= dr_consistency` (with `fill_mode="hirschmuller"`,
  `dr_consistency_hits`, which also gives the hits map of the fill);
* 'census_wta': the census cost volume, then WTA / uniqueness / subpixel /
  LR check over it in one kernel (`wta_lr`);
* 'sad': the SAD plane sweep fused with WTA / uniqueness / subpixel / d_R
  (`sad_wta`, no volume in memory), then `valid &= dr_consistency`;

then, for every mode, speckle over the stacked frames (`ops.speckle_frames`
with the CUDA labelling kernel and its size count, and the labels and the
bitonic sort under `ops.postproc.BITONIC_SPECKLE`), `where(valid, disp,
-1.0)`, the fill
(`ops.fill_background` or `ops.fill_hirschmuller`) and the median over the
stack. Frames are a batch dimension written out, so `frames_per_step`
changes nothing numerically. Everything runs on the device of the input
tensors: CUDA tensors through the kernels, CPU tensors through their plain
versions.

The volume route, the JAX `sgbm_volume` then `_select_and_refine`, is
public here too: `sgbm_volume` makes the mode's whole volume S
(`kernels.aggregate_volume` for SGM: sweeps, then the horizontal sweeps
in the transposed layout) and `select_and_refine` runs `wta_lr` over it,
for every mode and dtype, then speckle, the fill and the median; for the
Hirschmueller fill `wta_lr` also returns its right-view map, and the hits
kernel reads it in the shifted-column convention. SGM configurations past
the JAX fused bound, paths * (census_bits + P2) >= 4096, take it, as in
the JAX `sgbm`, and so do the census_wta and SAD modes with
`fill_mode="hirschmuller"`, whose fused kernels in the JAX package give no
right-view map, and the SAD configurations that `sad_wta` cannot take
(`kernels.sad.sad_wta_fits`: W > 4096, or a block whose band row overflows
shared memory, e.g. block >= 36 at 2964 columns), as the JAX `sgbm` leaves
its fused SAD kernel past `_sad_fused_ok`; its terms there (block <= 11, the
VMEM budget) are TPU limits and are not copied, since both routes give the
same output. The JAX package also sends configurations there that fail
its TPU memory gate (`_bwd_feasible`, e.g. `middlebury_sgm4` at
1988 x 2964); that gate is not ported, because the port's fused route is
exact at every height, so here such a configuration keeps the fused route
and reaches the volume route only through `sgbm_volume` +
`select_and_refine`.

Adaptive P2 (`cfg.adaptive_p2`) runs on both SGM routes: the left image
goes to the sweeps (`sgm_select`, `aggregate_volume`), as the JAX pipeline
hands `left` to both; the fused-route gate stays on the scalar P2, as in
the JAX `sgbm`.

Out of this slice (each raises `NotImplementedError` naming its ROADMAP
item): configurations outside the kernels' limits (D > 512; for SGM,
paths * (census_bits + P2) >= 2^15, which int16 S cannot hold, with
max(P2, P1 + 1) under adaptive P2).
"""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.kernels import (aggregate_volume, bitonic_sort,
                                     census_cost_volume,
                                     connected_component_big,
                                     connected_component_labels,
                                     dr_consistency, dr_consistency_hits,
                                     median3, sad_wta, sgm_select, wta_lr)
from tpustereo_torch.kernels.sad import sad_wta_fits
from tpustereo_torch.kernels.sgm import p2_max
from tpustereo_torch.ops import (fill_background, fill_hirschmuller,
                                 sad_volume)
from tpustereo_torch.ops.postproc import speckle_frames
from tpustereo_torch.trace import span

INVALID = -1.0
# paths * (census_bits + P2) from which the JAX `sgbm` leaves its fused
# route (a limit of its TPU bwd kernel's packing, not of the port's fused
# route, which is exact up to S16_BOUND); kept so that both packages run
# the same route
FUSED_BOUND = 4096
S16_BOUND = 1 << 15  # ... that int16 S holds


def _fused_bound(cfg: Config) -> int:
    """The JAX `sgbm`'s fused-route gate term, on the scalar P2."""
    return cfg.paths * (cfg.max_census_cost + cfg.p2)


def _sgm_bound(cfg: Config) -> int:
    """The largest S any sum of paths reaches: under adaptive P2 a path
    adds up to max(P2, P1 + 1)."""
    return cfg.paths * (cfg.max_census_cost
                        + p2_max(cfg.p1, cfg.p2, cfg.adaptive_p2))


def check_slice(cfg: Config) -> None:
    """Raise `NotImplementedError` for a configuration the port refuses,
    with the reason (ROADMAP.md, "Wide configurations"). Census windows
    over 64 bits need no check here: `Config` refuses them."""
    refused = []
    if cfg.num_disparities > 512:
        refused.append("num_disparities > 512: a sweep warp holds at most "
                       "512 disparities in registers (ROADMAP: wide "
                       "configs)")
    if cfg.mode == "sgm" and _sgm_bound(cfg) >= S16_BOUND:
        refused.append("paths * (census_bits + p2) >= 2^15: the int16 sums "
                       "of the paths would wrap; the JAX package's TPU "
                       "path refuses such configurations too (ROADMAP: wide "
                       "configs)")
    if refused:
        raise NotImplementedError("refused: " + "; ".join(refused))


def _census(left: torch.Tensor, right: torch.Tensor, cfg: Config):
    with span("census"):
        return census_cost_volume(left, right, cfg.num_disparities,
                                  cfg.max_census_cost, cfg.census_window,
                                  cfg.min_disparity)


def _select(left: torch.Tensor, right: torch.Tensor, cfg: Config):
    """The mode's fused cost and selection stages, LR check included:
    (F, H, W) uint8 x2 -> (disp float32, valid bool, hits bool or None).
    hits, the map of the Hirschmueller fill, comes only from SGM (the JAX
    fused SGM branch); the other modes take the volume route for that
    fill."""
    if cfg.mode == "sad":
        with span("sweeps"):
            sel = sad_wta(left, right, cfg)
        return _lr_check(*sel, cfg)
    C = _census(left, right, cfg)
    with span("sweeps"):
        if cfg.mode == "census_wta":
            return (*wta_lr(C, cfg), None)
        sel = sgm_select(C, cfg, left)
    return _lr_check(*sel, cfg)


def _lr_check(disp: torch.Tensor, valid: torch.Tensor, d_r: torch.Tensor,
              cfg: Config):
    """`valid &= dr_consistency` of a fused route's d_r (shifted-column
    index map), with the hits map of the Hirschmueller fill from the same
    kernel: -> (disp, valid, hits or None)."""
    D, d0 = cfg.num_disparities, cfg.min_disparity
    hits = None
    with span("lr_check"):
        if cfg.disp12_max_diff >= 0:
            if cfg.fill_mode == "hirschmuller":
                ok, hits = dr_consistency_hits(d_r, disp, D,
                                               cfg.disp12_max_diff, d0)
            else:
                ok = dr_consistency(d_r, disp, D, cfg.disp12_max_diff, d0)
            valid &= ok
    return disp, valid, hits


def _postproc(disp: torch.Tensor, valid: torch.Tensor,
              hits: torch.Tensor | None, cfg: Config) -> torch.Tensor:
    """Speckle over the stacked frames, -1.0 at invalid pixels, the fill
    (hits: the Hirschmueller fill's map, else None), median."""
    with span("speckle"):
        valid = speckle_frames(disp, valid, cfg,
                               cc=connected_component_labels,
                               sort=bitonic_sort, big=connected_component_big)
    out = torch.where(valid, disp, INVALID)
    if cfg.fill_mode == "background":
        with span("fill"):
            out = fill_background(out)
    elif cfg.fill_mode == "hirschmuller":
        with span("fill"):
            out = fill_hirschmuller(out, hits)
    if cfg.median_filter:
        with span("median"):
            out = median3(out)
    return out


def _shifted_columns(d_R: torch.Tensor, d_start: int) -> torch.Tensor:
    """A true-unit right-view map indexed by the right column, d_R (..., W),
    as the fused route's shifted-column index map: d_r[c] = d_R[c -
    d_start] - d_start for c >= d_start (the hits kernel never reads
    c < d_start, which stay 0)."""
    d_r = torch.zeros_like(d_R)
    W = d_R.shape[-1]
    if d_start < W:
        d_r[..., d_start:] = d_R[..., :W - d_start] - d_start
    return d_r


def sgbm_volume(left: torch.Tensor, right: torch.Tensor,
                cfg: Config) -> torch.Tensor:
    """The mode's whole cost volume S: (F, H, W) uint8 x2 -> (F, H, W, D),
    aggregated for SGM (int16), the census cost as int16 for census_wta,
    and the SAD volume (int32) for sad, as the JAX `sgbm_volume`."""
    check_slice(cfg)
    if cfg.mode == "sad":
        with span("sweeps"):
            return sad_volume(left, right, cfg.num_disparities,
                              cfg.sad_block, cfg.min_disparity)
    if cfg.mode == "census_wta":
        return _census(left, right, cfg).to(torch.int16)
    C = _census(left, right, cfg)
    with span("sweeps"):
        return aggregate_volume(C, cfg, left)


def select_and_refine(S: torch.Tensor, cfg: Config) -> torch.Tensor:
    """WTA + uniqueness + subpixel + LR check over the volume S of
    `sgbm_volume` in one `wta_lr` launch, then speckle, the fill and the
    median: (F, H, W, D) -> (F, H, W) float32, invalid = -1. The
    Hirschmueller fill's hits map comes from `wta_lr`'s right-view map
    through the hits kernel, never from a sheared volume.

    Every mode's volume goes through the kernel: the SAD volume as int32,
    exact while its costs (255 * block^2) stay below 2^20, so for
    block <= 64 as in `sad_wta`. The JAX `_select_and_refine` runs its
    kernel only on int16 (block <= 11, a TPU limit) and a larger block
    through `ops.wta` + `ops.lr_check`; the outputs are the same."""
    check_slice(cfg)
    with span("select"):
        sel = _volume_select(S, cfg)
    return _postproc(*sel, cfg)


def _volume_select(S: torch.Tensor, cfg: Config):
    """`select_and_refine`'s selection: -> (disp, valid, hits or None)."""
    if cfg.mode == "sad" and 255 * cfg.sad_block ** 2 >= 1 << 20:
        raise ValueError(f"sad_block {cfg.sad_block} out of [1, 64]: "
                         f"wta_lr needs every cost below 2^20")
    if cfg.fill_mode != "hirschmuller":
        return (*wta_lr(S, cfg), None)
    disp, valid, d_R = wta_lr(S, cfg, with_dr=True)
    _, hits = dr_consistency_hits(
        _shifted_columns(d_R, cfg.min_disparity), disp, cfg.num_disparities,
        cfg.disp12_max_diff, cfg.min_disparity)
    return disp, valid, hits


def volume_route(cfg: Config, W: int) -> bool:
    """Whether frames of width W take the volume route (see the module's
    docstring), else the mode's fused kernels."""
    return ((cfg.mode == "sgm" and _fused_bound(cfg) >= FUSED_BOUND)
            or (cfg.mode != "sgm" and cfg.fill_mode == "hirschmuller")
            or (cfg.mode == "sad" and not sad_wta_fits(W, cfg.sad_block)))


def sgbm_frames(left: torch.Tensor, right: torch.Tensor,
                cfg: Config) -> torch.Tensor:
    """(F, H, W) uint8 x2 -> (F, H, W) float32 disparity, invalid = -1."""
    with span("frames"):
        check_slice(cfg)
        if volume_route(cfg, left.shape[-1]):
            return select_and_refine(sgbm_volume(left, right, cfg), cfg)
        return _postproc(*_select(left, right, cfg), cfg)


def sgbm(left: torch.Tensor, right: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Single pair: (H, W) uint8 x2 -> (H, W) float32."""
    return sgbm_frames(left[None], right[None], cfg)[0]


def sgbm_batched(left: torch.Tensor, right: torch.Tensor,
                 cfg: Config) -> torch.Tensor:
    """(B, H, W) uint8 x2 -> (B, H, W) float32, `cfg.frames_per_step`
    frames per set of kernel launches when that divides B, else one.
    Under a torch profiler the call records its stages' spans
    (`tpustereo_torch.trace`)."""
    with span("sgbm_batched"):
        B = left.shape[0]
        F = cfg.frames_per_step if B % cfg.frames_per_step == 0 else 1
        outs = [sgbm_frames(left[i:i + F], right[i:i + F], cfg)
                for i in range(0, B, F)]
        with span("cat"):
            return torch.cat(outs)
