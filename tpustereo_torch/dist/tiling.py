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
  previous strip's final carry. With 8 paths a scan order's three
  directions run in one launch a strip, as the JAX `_ring_sweep_pallas`
  runs them (`kernels.sgm_sweep_fused(..., carry=, return_carry=)`, a
  (3, F, W, D) carry; past `kernels.sgm.FUSED_MAX_D` one direction a
  launch, as the untiled route); with 4 paths each one direction a launch
  (`kernels.sgm_sweep(..., carry=, return_carry=)`). Equal to the untiled
  pipeline bit for bit at any strip count; the y sweeps serialise across
  strips. The JAX ring runs every
  strip's sweep at every step and keeps the owner's (SPMD); here only the
  owner's runs, with the same outputs.

Post-processing (speckle, the fill, the median) runs on the gathered map
of the real rows, as in the JAX package, so it equals the untiled one.

In one process (`dist.mesh`), strips are the leading axis of a tensor
on the mesh's one device: (S, F, Hs, W) for S strips of F frames, and the
gather is a reshape. Halo mode extends each strip (`halo_exchange`,
slicing across that axis) and runs the census and `sgm_select` over all
extended strips as one batch of S * F. Exact mode takes every strip's
costs from one census over the padded frames (what the JAX census over a
strip extended by the census margin gives it), runs the ring's sweeps one
strip a launch, and the E sweep and the fused W sweep + selection over
all strips in one launch each. census_wta and SAD are row-local past
their window's margin, so the untiled pipeline's stages run over the
padded frames, the strips' union.

Across ranks (one process a device), each rank holds one strip of its
data shard, as a JAX shard does: the rows beyond it come over `dist.comm`
(`exchange_halo` for the halo, the census margin and the window margin of
census_wta and SAD; `send_carry` / `recv_carry` for the ring, which
passes each scan order's carry strip after strip in path order), each
rank selects on its own strip (the volume route too: no volume crosses
ranks), and `all_gather_rows` hands every rank of the
strip axis the maps that post-processing needs, as the JAX `all_gather`
does. The same functions run both forms: `_Place` says which strips of
how many this process holds.

Rows are padded to a multiple of S * 8 (`_pad_rows`, the JAX package's
rounding, which decides where strip boundaries fall; every rank pads the
same way), and the costs of rows outside the image are zeroed.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.dist import comm
from tpustereo_torch.dist.mesh import Mesh
from tpustereo_torch.kernels import (aggregate_volume, sgm_select, sgm_sweep,
                                     sweep_bwd_wta)
from tpustereo_torch.kernels.sgm import vertical_orders, vertical_sweep
from tpustereo_torch.pipeline.sgbm import (_census, _lr_check, _postproc,
                                           _select, _volume_select,
                                           check_slice, sgbm_volume,
                                           volume_route)

AXIS = "strip"


@dataclasses.dataclass(frozen=True)
class _Place:
    """The strips this process holds: strips first .. first + count - 1 of
    n, and the process group of the strip axis (None in one process,
    which holds all n)."""
    first: int
    count: int
    n: int
    group: object = None


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
                   n_real: int, first: int = 0) -> torch.Tensor:
    """Zero, in place, the cost rows of C (S, ..., He, W, D), strips first
    .. first + S - 1, whose global image row, strip * strip_rows - halo +
    row, falls outside [0, n_real): the first and last strips' halos and
    the bottom padding. A row of zero cost is an exact fresh path start
    for the y-scanning directions: with a carry uniform over d, L = min(q,
    q +- 1 + P1, P2) is uniform, so q stays 0, the state of an untiled
    sweep at the image's edge."""
    He = C.shape[-3]
    for i in range(C.shape[0]):
        top = (first + i) * strip_rows
        lo = min(max(halo - top, 0), He)
        hi = min(max(n_real - top + halo, lo), He)
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
    rows at each end of every strip dropped; contiguous, as the kernels
    take it (one strip's crop is a view until then)."""
    x = x[:, h:x.shape[1] - h]
    x = x.reshape(strips, -1, *x.shape[1:]).transpose(0, 1)
    return x.reshape(x.shape[0], -1, *x.shape[3:]).contiguous()


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(S, F, ...) -> (S * F, ...), one batch for the kernels."""
    return x.reshape(-1, *x.shape[2:])


def _held(x: torch.Tensor, place: _Place) -> torch.Tensor:
    """The frames (F, Hp, ...) of one process, or a rank's strip (F, Hs,
    ...) -> the held strips (count, F, Hs, ...)."""
    return _strips(x, place.n) if place.group is None else x[None]


def _extend(x: torch.Tensor, h: int, place: _Place) -> torch.Tensor:
    """Held strips (count, F, Hs, W) -> each with h rows of its
    neighbours, edge rows replicated at the image's top and bottom."""
    if place.group is None:
        return halo_exchange(x, h)
    return comm.exchange_halo(x[0], h, place.group)[None]


def _halo_costs(lp, rp, cfg: Config, place: _Place, n_real: int):
    """Halo mode's costs: the census over the held strips extended by the
    effective halo h, rows outside the image zeroed -> (C (count * F, Hs +
    2 h, W, D), the extended left strips (count * F, ...), h)."""
    ls, rs = _held(lp, place), _held(rp, place)
    Hs = ls.shape[-2]
    h = _effective_halo(cfg, Hs, cfg.census_window[0] // 2)
    ext_l = _extend(ls, h, place)
    C = _census(_flat(ext_l), _flat(_extend(rs, h, place)), cfg)
    _zero_oob_rows(C.view(*ext_l.shape, -1), h, Hs, n_real, place.first)
    return C, _flat(ext_l), h


def _exact_costs(lp, rp, cfg: Config, place: _Place, n_real: int):
    """Exact mode's costs of each held strip: (count, F, Hs, W, D), each
    strip's volume contiguous, and the image rows around them (F, R, W)
    with the offset of the first held row. In one process, one census over
    the padded frames gives every strip's rows what the JAX census over
    the strip extended by the census margin gives them (the rows next to
    it, or the edge row replicated), with no crop. A rank extends its
    strip by the margin (at least the one row beside it, which adaptive
    P2's carry reads), runs the census and crops. Rows past the image are
    zeroed."""
    if place.group is None:
        C = _census(lp, rp, cfg)
        if n_real < C.shape[1]:
            C[:, n_real:].zero_()
        # a copy only for several frames: one frame's strips are contiguous
        return _strips(C, place.n).contiguous(), lp, 0
    m = max(cfg.census_window[0] // 2, 1)
    Hs = lp.shape[-2]
    el = comm.exchange_halo(lp, m, place.group)
    er = comm.exchange_halo(rp, m, place.group)
    C = _census(el, er, cfg)[:, m:m + Hs].contiguous()[None]
    _zero_oob_rows(C, 0, Hs, n_real, place.first)
    return C, el, m


def _exact_sweeps(C: torch.Tensor, S: torch.Tensor, cfg: Config, img,
                  rows: torch.Tensor, base: int, place: _Place):
    """The y-scanning path costs of C (count, F, Hs, W, D) into S (int16,
    its shape): each scan order's sweep runs strip after strip in path
    order (down sweeps from the top strip, up sweeps from the bottom one),
    each launch seeded with the previous strip's final carry, received
    from the rank before this one's strips in path order and sent on to
    the rank after them; a strip's first sweep writes its S, the later
    ones add. The scan orders are `kernels.sgm.vertical_orders`': with 8
    paths the down set and the up set, one fused launch a strip and one
    (3, F, W, D) carry across each strip boundary; with 4 paths S and N,
    one direction a launch and an (F, W, D) carry. img (count, F, Hs, W)
    is the held strips' left image under adaptive P2 (else None); rows (F,
    R, W) the left image rows around them, held strip i's row j at
    rows[:, base + i * Hs + j], which gives the carry's image row."""
    k_n, F, Hs, W, D = C.shape
    first, n = place.first, place.n
    written = [False] * k_n
    for dy, dxs in vertical_orders(cfg.paths, D):
        down = dy > 0
        carry = None
        before = first - 1 if down else first + k_n
        if 0 <= before < n:
            shape = (len(dxs), F, W, D) if len(dxs) > 1 else (F, W, D)
            carry = comm.recv_carry(shape, torch.int32, before, place.group,
                                    C.device)
        for i in range(k_n) if down else range(k_n - 1, -1, -1):
            g = first + i
            more = g < n - 1 if down else g > 0
            prev = None
            if img is not None and carry is not None:
                prev = rows[:, base + i * Hs - 1 if down
                            else base + (i + 1) * Hs].contiguous()
            res = vertical_sweep(
                C[i], S[i] if written[i] else None, dy, dxs, cfg.p1, cfg.p2,
                None if img is None else img[i], carry=carry,
                return_carry=more, img_prev=prev,
                out=None if written[i] else S[i])
            written[i] = True
            carry = res[1] if more else None
        after = first + k_n if down else first - 1
        if 0 <= after < n:
            comm.send_carry(carry, after, place.group)


def _exact_volumes(lp, rp, cfg: Config, place: _Place, n_real: int):
    """Exact mode up to the horizontal sweeps, all held strips as one
    batch: -> (C, S with every path but W, the left image or None), each
    of (count * F, Hs, ...)."""
    C, rows, base = _exact_costs(lp, rp, cfg, place, n_real)
    img = _held(lp, place).contiguous() if cfg.adaptive_p2 else None
    S = torch.empty(C.shape, dtype=torch.int16, device=C.device)
    _exact_sweeps(C, S, cfg, img, rows, base, place)
    C, S = _flat(C), _flat(S)
    img = None if img is None else _flat(img)
    sgm_sweep(C, S, 0, 1, cfg.p1, cfg.p2, img)    # E
    return C, S, img


def _sgm_fused(lp, rp, cfg: Config, place: _Place, n_real: int):
    """The SGM fused route on the held strips, halo or exact: the path
    costs but W, then the fused W sweep + WTA + d_R over every held strip
    in one launch, cropped to the strips (and in one process gathered),
    then the LR check. Halo mode runs `sgm_select` over the extended
    strips (the extended left image for adaptive P2). -> (disp, valid,
    hits) of (F, count * Hs, W)."""
    if cfg.exact_tiling:
        C, S, img = _exact_volumes(lp, rp, cfg, place, n_real)
        maps, h = sweep_bwd_wta(C, S, cfg, img), 0
    else:
        C, ext_l, h = _halo_costs(lp, rp, cfg, place, n_real)
        maps = sgm_select(C, cfg, ext_l)
    del C
    return _lr_check(*(_unstrip(x, place.count, h) for x in maps), cfg)


def _sgm_volume(lp, rp, cfg: Config, place: _Place, n_real: int):
    """SGM's aggregated volume over the held strips, halo or exact: (F,
    count * Hs, W, D), in one process the whole frames' as the JAX
    `_volume_local` gathered them; a rank selects on its own."""
    if cfg.exact_tiling:
        C, S, img = _exact_volumes(lp, rp, cfg, place, n_real)
        sgm_sweep(C, S, 0, -1, cfg.p1, cfg.p2, img)   # W
        return _unstrip(S, place.count)
    C, ext_l, h = _halo_costs(lp, rp, cfg, place, n_real)
    return _unstrip(aggregate_volume(C, cfg, ext_l), place.count, h)


def _strip_select(lp, rp, cfg: Config, place: _Place, n_real: int):
    """Disparity, validity and the Hirschmueller hits map (or None) of the
    held strips of the padded frames (in one process lp, rp are the
    padded frames (F, Hp, W) uint8, on a rank its strip (F, Hs, W)), each
    (F, count * Hs, W). The route of the untiled pipeline for the frame's
    width (`pipeline.volume_route`); the outputs equal the JAX
    `_sgbm_strip`'s. census_wta and SAD are row-local past their window's
    margin: in one process the untiled pipeline's stages run over the
    padded frames, the strips' union; a rank runs them over its strip
    extended by that margin and crops it."""
    vol = volume_route(cfg, lp.shape[-1])
    if cfg.mode != "sgm":
        m = 0
        if place.group is not None:
            m = (cfg.sad_block if cfg.mode == "sad"
                 else cfg.census_window[0]) // 2
            lp, rp = (comm.exchange_halo(x, m, place.group)
                      for x in (lp, rp))
        maps = (_volume_select(sgbm_volume(lp, rp, cfg), cfg) if vol
                else _select(lp, rp, cfg))
        return tuple(None if x is None else x[:, m:x.shape[1] - m]
                     for x in maps)
    if vol:
        return _volume_select(_sgm_volume(lp, rp, cfg, place, n_real), cfg)
    return _sgm_fused(lp, rp, cfg, place, n_real)


def _gather_maps(maps, group):
    """A rank's (disp, valid, hits or None) strips -> the data shard's
    whole maps on every rank of the strip axis, in one gather (valid and
    hits as exact 0.0 / 1.0 beside the float disparity)."""
    disp = maps[0]
    stack = torch.stack([x.to(disp.dtype) for x in maps if x is not None])
    full = comm.all_gather_rows(stack, group)
    hits = None if maps[2] is None else full[2] > 0
    return full[0], full[1] > 0, hits


def _tiled(lp: torch.Tensor, rp: torch.Tensor, cfg: Config, place: _Place,
           n_real: int) -> torch.Tensor:
    """The held strips of the padded frames (see `_strip_select`) -> the
    (F, n_real, W) float32 frames, post-processed on the gathered maps of
    the real rows."""
    maps = _strip_select(lp, rp, cfg, place, n_real)
    if place.group is not None:
        maps = _gather_maps(maps, place.group)
    disp, valid, hits = (None if x is None else x[:, :n_real].contiguous()
                         for x in maps)
    return _postproc(disp, valid, hits, cfg)


def strip_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(F, H, W) frames -> this rank's strip of them padded
    (`_pad_rows`): rows s * Hs .. (s + 1) * Hs - 1 of the padded frames,
    s the rank's strip coordinate; what `sgbm_strip` takes."""
    strips = mesh.shape[AXIS]
    xp = _pad_rows(x, strips)
    Hs = xp.shape[-2] // strips
    s = mesh.ranks.strip
    return xp[..., s * Hs:(s + 1) * Hs, :].contiguous()


def sgbm_strip(left_rows: torch.Tensor, right_rows: torch.Tensor,
               cfg: Config, mesh: Mesh, n_real: int) -> torch.Tensor:
    """The multi-rank form on a rank's own rows, what a host that reads
    only its strip calls: (F, Hs, W) uint8 x2, this rank's strip of its
    data shard's frames padded to a multiple of strips * 8 rows
    (`strip_rows`), n_real the frames' height -> the data shard's (F,
    n_real, W) float32, the same on every rank of the strip axis."""
    check_slice(cfg)
    dev = mesh.device
    place = _Place(mesh.ranks.strip, 1, mesh.shape[AXIS],
                   mesh.ranks.strip_group)
    return _tiled(left_rows.to(dev).contiguous(),
                  right_rows.to(dev).contiguous(), cfg, place, n_real)


def _frames(left: torch.Tensor, right: torch.Tensor, cfg: Config,
            mesh: Mesh) -> torch.Tensor:
    """(F, H, W) uint8 x2 on the mesh's device -> (F, H, W) float32: one
    process tiles every strip, a rank its own."""
    check_slice(cfg)
    H = left.shape[1]
    if mesh.ranks is not None:
        return sgbm_strip(strip_rows(left, mesh), strip_rows(right, mesh),
                          cfg, mesh, H)
    strips = mesh.shape[AXIS]
    lp, rp = (_pad_rows(x, strips).contiguous() for x in (left, right))
    return _tiled(lp, rp, cfg, _Place(0, strips, strips), H)


def sgbm_tiled(left: torch.Tensor, right: torch.Tensor, cfg: Config,
               mesh: Mesh) -> torch.Tensor:
    """Strip-tiled single pair over the mesh's strip axis: (H, W) uint8 x2
    -> (H, W) float32, invalid = -1, on the mesh's device. Any H: rows are
    padded (`_pad_rows`), and the padding changes no real pixel's output
    in exact mode. Across ranks every rank passes the whole pair, keeps
    its strip's rows and returns the whole map (every data shard tiles
    the same pair, as the JAX mesh replicates it over its data axis)."""
    dev = mesh.device
    return _frames(left.to(dev)[None], right.to(dev)[None], cfg, mesh)[0]


def sgbm_tiled_batched(left: torch.Tensor, right: torch.Tensor, cfg: Config,
                       mesh: Mesh) -> torch.Tensor:
    """Batched and tiled: (B, H, W) x2 -> (B, H, W), the batch over the
    mesh's data axis (B must divide by it) and rows over its strip axis.
    On the one device all data shards and strips run as one batch. Across
    ranks every rank passes the whole batch, as a JAX caller passes a
    global array, tiles its data shard and returns the whole batch (the
    shards gathered over the data axis)."""
    k = mesh.shape["data"]
    if left.shape[0] % k:
        raise ValueError(f"batch {left.shape[0]} does not divide by the "
                         f"data axis {k}")
    dev = mesh.device
    if mesh.ranks is None:
        return _frames(left.to(dev), right.to(dev), cfg, mesh)
    F = left.shape[0] // k
    shard = slice(mesh.ranks.data * F, (mesh.ranks.data + 1) * F)
    out = _frames(left[shard].to(dev), right[shard].to(dev), cfg, mesh)
    return comm.all_gather_frames(out, mesh.ranks.data_group)
