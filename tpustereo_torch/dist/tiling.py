"""Strip tiling: a frame's rows split into strips, the counterpart of the
JAX package's `dist/tiling.py` (BASELINE config 5).

Horizontal SGM paths stay inside a strip; the paths that scan y cross
strips, in one of two modes, as in the JAX package:

* **halo approximation** (default): each strip is extended by `cfg.halo`
  rows of its neighbours (`halo_exchange`) and the halo is dropped after
  selection. Outputs approximate the untiled pipeline's and equal the JAX
  `sgbm_tiled`'s in this mode.
* **exact ring hand-off** (`cfg.exact_tiling`): each y-scanning sweep runs
  strip after strip in path order, each strip's launch seeded with the
  previous strip's final carry (`kernels.sgm_sweep(..., carry=,
  return_carry=)`). Equal to the untiled pipeline bit for bit at any strip
  count; the y sweeps serialise across strips. The JAX ring runs every
  strip's sweep at every step and keeps the owner's (SPMD); here only the
  owner's runs, with the same outputs.

Post-processing (speckle, the fill, the median) runs on the gathered map
of the real rows, as in the JAX package, so it equals the untiled one.

Strips are the leading axis of a tensor on the mesh's one device
(`dist.mesh`): (S, F, Hs, W) for S strips of F frames, and the gather is
a reshape. Halo mode extends each strip (`halo_exchange`, slicing across
that axis) and runs the census and `sgm_select` over all extended strips
as one batch of S * F. Exact mode takes every strip's costs from one
census over the padded frames (what the JAX census over a strip extended
by the census margin gives it), runs the ring's sweeps one strip a
launch, and the E sweep and the fused W sweep + selection over all
strips in one launch each. census_wta and SAD are row-local past their
window's margin, so the untiled pipeline's stages run over the padded
frames, the strips' union. Rows are padded to a multiple of S * 8 (`_pad_rows`, the
JAX package's rounding, which decides where strip boundaries fall), and
the costs of rows outside the image are zeroed.
"""

from __future__ import annotations

import warnings

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.dist.mesh import Mesh
from tpustereo_torch.kernels import (aggregate_volume, sgm_select, sgm_sweep,
                                     sweep_bwd_wta)
from tpustereo_torch.ops.sgm import DIRS_4, DIRS_8
from tpustereo_torch.pipeline.sgbm import (_census, _lr_check, _postproc,
                                           _select, _volume_select,
                                           check_slice, sgbm_volume,
                                           volume_route)

AXIS = "strip"


def _effective_halo(cfg: Config, strip_rows: int, ry: int) -> int:
    """Halo rows actually exchanged: at least the census margin, at most the
    strip height (only the adjacent strip is reached). Warns when the
    requested halo is shrunk, as the JAX package does."""
    h = min(max(cfg.halo, ry), strip_rows)
    if h < cfg.halo:
        warnings.warn(
            f"halo {cfg.halo} clamped to strip height {strip_rows}: the "
            "halo approximation loses accuracy; use fewer strips or "
            "exact_tiling=True", stacklevel=3)
    return h


def halo_exchange(x: torch.Tensor, halo: int) -> torch.Tensor:
    """(S, ..., Hs, W) strips -> (S, ..., Hs + 2 halo, W): each strip with
    `halo` rows of the strip above and of the strip below; the first
    strip's top and the last strip's bottom replicate its edge row (the
    untiled pipeline's border convention)."""
    Hs = x.shape[-2]
    if not 0 <= halo <= Hs:
        raise ValueError(f"halo {halo} out of [0, {Hs}]")
    if halo == 0:
        return x
    top, bot = x[:1, ..., :1, :], x[-1:, ..., -1:, :]
    top = top.expand(*top.shape[:-2], halo, x.shape[-1])
    bot = bot.expand(*bot.shape[:-2], halo, x.shape[-1])
    above = torch.cat([top, x[:-1, ..., Hs - halo:, :]], 0)
    below = torch.cat([x[1:, ..., :halo, :], bot], 0)
    return torch.cat([above, x, below], -2)


def _zero_oob_rows(C: torch.Tensor, halo: int, strip_rows: int,
                   n_real: int) -> torch.Tensor:
    """Zero, in place, the cost rows of C (S, ..., He, W, D) whose global
    image row, strip * strip_rows - halo + row, falls outside [0, n_real):
    the first and last strips' halos and the bottom padding. A row of zero
    cost is an exact fresh path start for the y-scanning directions: with
    a carry uniform over d, L = min(q, q +- 1 + P1, P2) is uniform, so q
    stays 0, the state of an untiled sweep at the image's edge."""
    He = C.shape[-3]
    for i in range(C.shape[0]):
        lo = min(max(halo - i * strip_rows, 0), He)
        hi = min(max(n_real - i * strip_rows + halo, lo), He)
        if lo:
            C[i].narrow(-3, 0, lo).zero_()
        if hi < He:
            C[i].narrow(-3, hi, He - hi).zero_()
    return C


def _pad_rows(x: torch.Tensor, strips: int) -> torch.Tensor:
    """Pad the rows (the last but one axis) to a multiple of strips * 8 by
    edge replication, the JAX package's rounding (there for the TPU's
    sublanes): real rows near the bottom see the untiled census border,
    and the padded rows' costs are zeroed in their strip."""
    H = x.shape[-2]
    Hp = -(-H // (strips * 8)) * (strips * 8)
    if Hp == H:
        return x
    edge = x[..., -1:, :]
    return torch.cat([x, edge.expand(*edge.shape[:-2], Hp - H,
                                     x.shape[-1])], -2)


def _strips(x: torch.Tensor, strips: int) -> torch.Tensor:
    """(F, Hp, ...) padded frames -> their (S, F, Hs, ...) strips (a
    view)."""
    F, Hp = x.shape[:2]
    return x.reshape(F, strips, Hp // strips, *x.shape[2:]).transpose(0, 1)


def _unstrip(x: torch.Tensor, strips: int, h: int = 0) -> torch.Tensor:
    """(S * F, Hs + 2 h, ...) strips -> the (F, S * Hs, ...) frames, the h
    rows at each end of every strip dropped."""
    x = x[:, h:x.shape[1] - h]
    x = x.reshape(strips, -1, *x.shape[1:]).transpose(0, 1)
    return x.reshape(x.shape[0], -1, *x.shape[3:])


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(S, F, ...) -> (S * F, ...), one batch for the kernels."""
    return x.reshape(-1, *x.shape[2:])


def _halo_costs(lp, rp, cfg: Config, strips: int, n_real: int):
    """Halo mode's costs: the census over strips extended by the effective
    halo h (`halo_exchange`), rows outside the image zeroed -> (C
    (S * F, Hs + 2 h, W, D), the extended left strips (S * F, ...), h)."""
    ls, rs = _strips(lp, strips), _strips(rp, strips)
    Hs = ls.shape[-2]
    h = _effective_halo(cfg, Hs, cfg.census_window[0] // 2)
    ext_l = halo_exchange(ls, h)
    C = _census(_flat(ext_l), _flat(halo_exchange(rs, h)), cfg)
    _zero_oob_rows(C.view(*ext_l.shape, -1), h, Hs, n_real)
    return C, _flat(ext_l), h


def _exact_costs(lp, rp, cfg: Config, strips: int, n_real: int):
    """Exact mode's costs of each strip: (S, F, Hs, W, D), each strip's
    volume contiguous. One census over the padded frames gives every
    strip's rows what the JAX census over the strip extended by the
    census margin gives them (the rows next to it, or the edge row
    replicated), with no crop; rows past the image are zeroed."""
    C = _census(lp, rp, cfg)
    if n_real < C.shape[1]:
        C[:, n_real:].zero_()
    # a copy only for several frames: one frame's strips are contiguous
    return _strips(C, strips).contiguous()


def _exact_sweeps(C: torch.Tensor, S: torch.Tensor, cfg: Config, img, lp):
    """The y-scanning path costs of C (S, F, Hs, W, D) into S (int16, its
    shape): each direction's sweep runs strip after strip in path order
    (down sweeps from the top strip, up sweeps from the bottom one), each
    launch seeded with the previous strip's final carry; a strip's first
    sweep writes its S, the later ones add. img (S, F, Hs, W) is the
    strips' left image under adaptive P2 (else None); lp (F, Hp, W), the
    padded left frames, gives the carry's image row."""
    n, Hs = C.shape[0], C.shape[2]
    written = [False] * n
    for dy, dx in (DIRS_4 if cfg.paths == 4 else DIRS_8):
        if dy == 0:
            continue
        carry = None
        for k, i in enumerate(range(n) if dy > 0 else range(n - 1, -1, -1)):
            more = k < n - 1
            prev = None
            if img is not None and carry is not None:
                prev = lp[:, i * Hs - 1 if dy > 0 else (i + 1) * Hs]
                prev = prev.contiguous()
            res = sgm_sweep(C[i], S[i] if written[i] else None, dy, dx,
                            cfg.p1, cfg.p2, None if img is None else img[i],
                            carry=carry, return_carry=more, img_prev=prev,
                            out=None if written[i] else S[i])
            written[i] = True
            carry = res[1] if more else None


def _exact_volumes(lp, rp, cfg: Config, strips: int, n_real: int):
    """Exact mode up to the horizontal sweeps, all strips as one batch:
    -> (C, S with every path but W, the left image or None), each of
    (S * F, Hs, ...)."""
    C = _exact_costs(lp, rp, cfg, strips, n_real)
    img = _strips(lp, strips).contiguous() if cfg.adaptive_p2 else None
    S = torch.empty(C.shape, dtype=torch.int16, device=C.device)
    _exact_sweeps(C, S, cfg, img, lp)
    C, S = _flat(C), _flat(S)
    img = None if img is None else _flat(img)
    sgm_sweep(C, S, 0, 1, cfg.p1, cfg.p2, img)    # E
    return C, S, img


def _sgm_fused(lp, rp, cfg: Config, strips: int, n_real: int):
    """The SGM fused route on strips, halo or exact: the path costs but W,
    then the fused W sweep + WTA + d_R over every strip in one launch,
    cropped to the strips and gathered, then the LR check. Halo mode
    runs `sgm_select` over the extended strips (the extended left image
    for adaptive P2). -> (disp, valid, hits) of (F, Hp, W)."""
    if cfg.exact_tiling:
        C, S, img = _exact_volumes(lp, rp, cfg, strips, n_real)
        maps, h = sweep_bwd_wta(C, S, cfg, img), 0
    else:
        C, ext_l, h = _halo_costs(lp, rp, cfg, strips, n_real)
        maps = sgm_select(C, cfg, ext_l)
    del C
    return _lr_check(*(_unstrip(x, strips, h) for x in maps), cfg)


def _sgm_volume(lp, rp, cfg: Config, strips: int, n_real: int):
    """SGM's whole aggregated volume over the padded frames, halo or exact:
    (F, Hp, W, D), as the JAX `_volume_local` gathered."""
    if cfg.exact_tiling:
        C, S, img = _exact_volumes(lp, rp, cfg, strips, n_real)
        sgm_sweep(C, S, 0, -1, cfg.p1, cfg.p2, img)   # W
        return _unstrip(S, strips)
    C, ext_l, h = _halo_costs(lp, rp, cfg, strips, n_real)
    return _unstrip(aggregate_volume(C, cfg, ext_l), strips, h)


def _strip_select(lp, rp, cfg: Config, strips: int, n_real: int):
    """Disparity, validity and the Hirschmueller hits map (or None) of the
    padded frames (F, Hp, W) uint8 x2 over `strips` strips, each (F, Hp,
    W). The route of the untiled pipeline for the frame's width
    (`pipeline.volume_route`); the outputs equal the JAX `_sgbm_strip`'s.
    census_wta and SAD are row-local past their window's margin, so the
    untiled pipeline's stages run over the padded frames, the strips'
    union."""
    vol = volume_route(cfg, lp.shape[-1])
    if cfg.mode != "sgm":
        return (_volume_select(sgbm_volume(lp, rp, cfg), cfg) if vol
                else _select(lp, rp, cfg))
    if vol:
        return _volume_select(_sgm_volume(lp, rp, cfg, strips, n_real), cfg)
    return _sgm_fused(lp, rp, cfg, strips, n_real)


def _tiled(left: torch.Tensor, right: torch.Tensor, cfg: Config,
           strips: int) -> torch.Tensor:
    """(F, H, W) uint8 x2 over `strips` strips -> (F, H, W) float32."""
    check_slice(cfg)
    H = left.shape[1]
    lp, rp = (_pad_rows(x, strips).contiguous() for x in (left, right))
    maps = _strip_select(lp, rp, cfg, strips, H)
    disp, valid, hits = (None if x is None else x[:, :H].contiguous()
                         for x in maps)
    return _postproc(disp, valid, hits, cfg)


def sgbm_tiled(left: torch.Tensor, right: torch.Tensor, cfg: Config,
               mesh: Mesh) -> torch.Tensor:
    """Strip-tiled single pair over the mesh's strip axis: (H, W) uint8 x2
    -> (H, W) float32, invalid = -1, on the mesh's device. Any H: rows are
    padded (`_pad_rows`), and the padding changes no real pixel's output
    in exact mode."""
    dev = mesh.device
    return _tiled(left.to(dev)[None], right.to(dev)[None], cfg,
                  mesh.shape[AXIS])[0]


def sgbm_tiled_batched(left: torch.Tensor, right: torch.Tensor, cfg: Config,
                       mesh: Mesh) -> torch.Tensor:
    """Batched and tiled: (B, H, W) x2 -> (B, H, W), the batch over the
    mesh's data axis (B must divide by it) and rows over its strip axis.
    On the one device all data shards and strips run as one batch."""
    if left.shape[0] % mesh.shape["data"]:
        raise ValueError(f"batch {left.shape[0]} does not divide by the "
                         f"data axis {mesh.shape['data']}")
    dev = mesh.device
    return _tiled(left.to(dev), right.to(dev), cfg, mesh.shape[AXIS])
