"""Post-processing in plain PyTorch: the left-right check, speckle, the gap
fills and the 3x3 median.

Counterparts of the JAX package's `ops/postproc.py`:

- `_right_disparity`, `dr_consistency`, `lr_check`, `lr_hits` and
  `lr_hits_from_volume`, in its convention: d_R in true pixel units
  indexed by the right image's column. (The fused kernel path uses the
  shifted-column index map instead; see `kernels/lr.py`.) `torch.round`,
  like `jnp.round`, rounds half to even.
- `connected_component_labels`, `component_big`, `component_big_sorted`,
  `speckle_labels`, `speckle` and `speckle_frames`: 4-connected components
  of the speckle graph (valid pixels, |delta d| <= speckle_range in
  float32), labelled by their minimum linear index; pixels of components
  smaller than `speckle_window_size` are invalidated. The speckle functions
  take the labelling function as `cc`, and `speckle_frames` the sort of
  `BITONIC_SPECKLE` as `sort`, so the pipeline can hand them the CUDA
  kernels' wrappers (`kernels.connected_component_labels`,
  `kernels.bitonic_sort`); they default to the plain
  `connected_component_labels` and `torch.sort`.
- `fill_background` and `fill_hirschmuller` (Hirschmueller 2008, section
  V): each invalid (-1) pixel takes a value picked from the nearest valid
  pixels along rays. The JAX package holds the last valid value along a
  ray by scans, and the diagonals by a scan over rows; here every ray is
  one `cummax`/`cummin` of the valid positions along a line, the
  diagonals after a shear that makes them lines, then one gather, over
  all frames and rows at once. Values are only selected, never computed,
  so the fills are bit-exact.
- `median3`: the 3x3 median with edge replication, by the same 19-exchange
  network, over a batch of frames.
"""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.ops.wta import next_pow2
from tpustereo_torch.trace import span

_BIG = 1 << 24
# Paeth's median-of-9 exchange network (the JAX `median3` / `median3_pallas`
# order; `csrc/median3.cu` repeats it)
MEDIAN_NET = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
              (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
              (2, 5), (4, 7), (4, 2), (6, 4), (4, 2))


def _right_disparity(S: torch.Tensor, min_disp: int = 0) -> torch.Tensor:
    """d_R(x_r) = min_disp + argmin_j S(x_r + min_disp + j, j), ties to the
    lowest j; columns past the image read 1 << 20. (..., H, W, D) -> int32."""
    W, D = S.shape[-2], S.shape[-1]
    dev = S.device
    shift = next_pow2(max(D, 2))
    pad = torch.full(S.shape[:-2] + (min_disp + D, D), 1 << 20,
                     dtype=torch.int32, device=dev)
    Sp = torch.cat([S.to(torch.int32), pad], -2)
    lane = torch.arange(D, device=dev)
    idx = torch.arange(W, device=dev)[:, None] + min_disp + lane[None, :]
    T = Sp[..., idx, lane[None, :]]                    # (..., H, W, D)
    packed = (T * shift + lane.to(torch.int32)).amin(-1)
    return (packed & (shift - 1)) + min_disp


def dr_consistency(d_r: torch.Tensor, disp: torch.Tensor, num_disp: int,
                   max_diff: int, min_disp: int = 0) -> torch.Tensor:
    """|d_L(x) - d_R(x - round(d_L(x)))| <= max_diff, with d_R in true
    units; lookups left of the image, or d_L outside the search range, read
    a large sentinel and fail. (..., H, W) -> bool."""
    W = d_r.shape[-1]
    dl = torch.round(disp).to(torch.int32)
    col = torch.arange(W, device=d_r.device, dtype=torch.int32) - dl
    look = d_r.to(torch.int32).gather(-1, col.clamp(0, W - 1).long())
    G = torch.where(col >= 0, look, _BIG)
    j = dl - min_disp
    diff = torch.where((j >= 0) & (j < num_disp), (dl - G).abs(), _BIG)
    return diff <= max_diff


def lr_check(S: torch.Tensor, disp: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Validity mask |d_L(x) - d_R(x - round(d_L(x)))| <= disp12_max_diff."""
    if cfg.disp12_max_diff < 0:
        return torch.ones(disp.shape, dtype=torch.bool, device=disp.device)
    d_r = _right_disparity(S, cfg.min_disparity)
    return dr_consistency(d_r, disp, S.shape[-1], cfg.disp12_max_diff,
                          cfg.min_disparity)


def lr_hits(d_r: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The epipolar-intersection map of the Hirschmueller fill: hits[x] iff
    some d in the search range has x - d >= 0 and |d_R(x - d) - d| <=
    max(disp12_max_diff, 0), with d_R in true units. One shifted compare
    per disparity. (..., H, W) -> bool."""
    W = d_r.shape[-1]
    diff = max(cfg.disp12_max_diff, 0)
    d_r = d_r.to(torch.int32)
    hits = torch.zeros(d_r.shape, dtype=torch.bool, device=d_r.device)
    for d in range(cfg.min_disparity,
                   min(cfg.min_disparity + cfg.num_disparities, W)):
        hits[..., d:] |= (d_r[..., :W - d] - d).abs() <= diff
    return hits


def lr_hits_from_volume(S: torch.Tensor, cfg: Config) -> torch.Tensor:
    """`lr_hits` of the right-view WTA of the volume S (..., H, W, D)."""
    return lr_hits(_right_disparity(S, cfg.min_disparity), cfg)


# ---------------------------------------------------------------------------
# speckle
# ---------------------------------------------------------------------------

def connected_component_labels(conn_h: torch.Tensor,
                               conn_v: torch.Tensor) -> torch.Tensor:
    """Label 4-connected components given edge masks: conn_h (..., H, W-1)
    bool joins (y, x)~(y, x+1), conn_v (..., H-1, W) joins (y, x)~(y+1, x).
    Returns (..., H, W) int32: each pixel's component's minimum linear index
    within its own frame (stride W).

    Hook-and-jump union-find, run to convergence (no iteration cap): every
    label is the index of a pixel of the same component and no larger than
    the pixel's own, so the fixpoint is the component minimum. Each round
    links every root that an edge joins to a smaller root under the
    smallest such root (`scatter_reduce` amin), then jumps every pointer to
    its root."""
    H = conn_v.shape[-2] + 1
    W = conn_h.shape[-1] + 1
    batch = conn_h.shape[:-2]
    dev = conn_h.device
    n = batch.numel() * H * W
    idx = torch.arange(n, device=dev).reshape(*batch, H, W)
    a = torch.cat([idx[..., :-1][conn_h], idx[..., :-1, :][conn_v]])
    b = torch.cat([idx[..., 1:][conn_h], idx[..., 1:, :][conn_v]])
    lab = torch.arange(n, device=dev)
    while True:
        ra, rb = lab[a], lab[b]
        cross = ra != rb
        if not bool(cross.any()):
            break
        a, b = a[cross], b[cross]          # edges inside one tree stay so
        ra, rb = ra[cross], rb[cross]
        lab.scatter_reduce_(0, torch.maximum(ra, rb), torch.minimum(ra, rb),
                            reduce="amin")
        while True:
            nxt = lab[lab]
            if torch.equal(nxt, lab):
                break
            lab = nxt
    base = torch.arange(0, n, H * W, device=dev).reshape(*batch, 1, 1)
    return (lab.reshape(*batch, H, W) - base).to(torch.int32)


def component_big(lab: torch.Tensor, thresh: int) -> torch.Tensor:
    """Per-pixel 'my component has >= thresh pixels' for labels that are
    distinct across components: each pixel's count is the width of its
    label's run in the sorted labels, found by two binary searches. Same
    mask as the JAX `component_big`, which also sorts. (A histogram is the
    other exact route: `torch.bincount` reads its largest label back to
    the host, and an `index_add_` histogram serialises on the atomics of
    the large components.)"""
    flat = lab.reshape(-1)
    keys = flat.sort().values
    count = (torch.searchsorted(keys, flat, right=True)
             - torch.searchsorted(keys, flat))
    return (count >= thresh).reshape(lab.shape)


def torch_sort(keys: torch.Tensor, payload: torch.Tensor | None = None):
    """Ascending sort along the last axis with an optional payload, the
    signature of `kernels.bitonic_sort`; the default `sort` of the speckle
    functions."""
    vals, order = keys.sort(dim=-1)
    if payload is None:
        return vals
    return vals, payload.gather(-1, order)


def component_big_sorted(lab: torch.Tensor, thresh: int,
                         sort=torch_sort) -> torch.Tensor:
    """`component_big` of each frame of (..., H, W) frame-local labels, in
    the JAX package's sort formulation (its `component_big` with
    `use_pallas=True`): a pair sort of (labels, pixel index), each run's
    bounds by a running max of run starts and a reversed running min of run
    ends, then a keys-only sort of index * 2 + big that carries the bit
    back to its pixel. `sort(keys, payload=None)` sorts int32 keys along
    the last axis; the leading axes are independent sorts. The mask does
    not depend on the order of equal keys' payloads."""
    *batch, H, W = lab.shape
    n = H * W
    if n >= 1 << 30:
        raise ValueError("component_big_sorted needs H*W < 2**30")
    flat = lab.reshape(-1, n).to(torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=lab.device)
    sl, si = sort(flat, pos.expand(flat.shape))
    ones = torch.ones((flat.shape[0], 1), dtype=torch.bool,
                      device=lab.device)
    step = sl[:, 1:] != sl[:, :-1]
    is_start = torch.cat([ones, step], 1)
    is_end = torch.cat([step, ones], 1)
    spos = torch.where(is_start, pos, -1).cummax(1).values
    epos = torch.where(is_end, pos, n).flip(1).cummin(1).values.flip(1)
    big = (epos - spos + 1) >= thresh
    out = sort(si * 2 + big.to(torch.int32))
    return (out & 1).to(torch.bool).reshape(lab.shape)


# Speckle sizes through `sort` (the bitonic kernel on the pipeline's path)
# in place of `component_big`'s sort + searchsorted, as the JAX toggle of
# the same name; off by default. The outputs are the same.
BITONIC_SPECKLE = False


def speckle_conn(disp: torch.Tensor, valid: torch.Tensor, cfg: Config):
    """The speckle graph's edge masks (conn_h, conn_v) of (..., H, W) maps:
    both ends valid and |delta d| <= speckle_range, compared in float32 (a
    Python scalar takes the float32 map's dtype; a tensor made on the card
    from it would be a host copy that waits for the stream)."""
    rng = float(cfg.speckle_range)
    conn_h = (valid[..., :-1] & valid[..., 1:]
              & ((disp[..., :-1] - disp[..., 1:]).abs() <= rng))
    conn_v = (valid[..., :-1, :] & valid[..., 1:, :]
              & ((disp[..., :-1, :] - disp[..., 1:, :]).abs() <= rng))
    return conn_h, conn_v


def speckle_labels(disp: torch.Tensor, valid: torch.Tensor, cfg: Config,
                   cc=connected_component_labels) -> torch.Tensor:
    """Connected-component labels of the speckle graph: (..., H, W) int32,
    the minimum linear index of each component within its frame."""
    return cc(*speckle_conn(disp, valid, cfg))


def speckle(disp: torch.Tensor, valid: torch.Tensor, cfg: Config,
            cc=connected_component_labels) -> torch.Tensor:
    """Invalidate components smaller than speckle_window_size; (H, W)."""
    if cfg.speckle_window_size <= 0:
        return valid
    big = component_big(speckle_labels(disp, valid, cfg, cc),
                        cfg.speckle_window_size)
    return valid & big


def speckle_frames(disp: torch.Tensor, valid: torch.Tensor, cfg: Config,
                   cc=connected_component_labels,
                   sort=torch_sort) -> torch.Tensor:
    """`speckle` over (F, H, W) stacked frames: one labelling call for all
    frames, then labels offset by f*H*W and one `component_big` over the
    stack or, under `BITONIC_SPECKLE`, `component_big_sorted` with one sort
    per frame (the frames a batch axis of each `sort` call, no offsets)."""
    if cfg.speckle_window_size <= 0:
        return valid
    F, H, W = disp.shape
    if F * H * W >= 1 << 31:
        raise ValueError("speckle_frames needs F*H*W < 2**31")
    with span("speckle.labels"):
        lab = speckle_labels(disp, valid, cfg, cc)
    with span("speckle.sizes"):
        if BITONIC_SPECKLE:
            return valid & component_big_sorted(
                lab, cfg.speckle_window_size, sort)
        base = torch.arange(0, F * H * W, H * W, dtype=torch.int32,
                            device=disp.device).reshape(F, 1, 1)
        return valid & component_big(lab + base, cfg.speckle_window_size)


# ---------------------------------------------------------------------------
# gap fills
# ---------------------------------------------------------------------------

_FBIG = 1e30  # "no valid value found" sentinel; sorts after any disparity
# Batcher's odd-even merge network for 8 values (19 exchanges): the fill's
# 8-value sort as elementwise min/max, which selects the same float32
# values as a sort (the values are never NaN or -0.0) and moves a fraction
# of `torch.sort`'s bytes along a short axis
SORT8_NET = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
             (1, 2), (5, 6), (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5),
             (1, 2), (3, 4), (5, 6))


def _nearest(valid: torch.Tensor, dim: int, forward: bool):
    """(index, found) of the nearest valid position along `dim`, at or
    after (forward) or at or before each position: a running min or max of
    the valid positions. The index is clamped into range where none is
    found."""
    n = valid.shape[dim]
    shape = [1] * valid.dim()
    shape[dim] = n
    pos = torch.arange(n, device=valid.device).reshape(shape)
    if forward:
        idx = torch.where(valid, pos, n).flip(dim).cummin(dim).values.flip(
            dim)
        return idx.clamp(max=n - 1), idx < n
    idx = torch.where(valid, pos, -1).cummax(dim).values
    return idx.clamp(min=0), idx >= 0


def _hold_line(disp: torch.Tensor, valid: torch.Tensor, dim: int,
               forward: bool) -> torch.Tensor:
    """The nearest valid disparity along `dim` (the JAX `_hold_last_valid`,
    inclusive: a valid pixel holds itself); _FBIG where the ray leaves the
    image without meeting one."""
    idx, found = _nearest(valid, dim, forward)
    return torch.where(found, disp.gather(dim, idx), _FBIG)


def _hold_diags(disp: torch.Tensor, valid: torch.Tensor, dx: int):
    """The nearest valid disparity along the diagonal rays (1, dx) and
    (-1, -dx) of each pixel of (..., H, W), inclusive, _FBIG where there is
    none (the JAX `_hold_diag` of those two rays). The shear c = x - y +
    H - 1 (dx = 1) or c = x + y (dx = -1) makes each diagonal the row c of
    a (W + H - 1, H) map over y; positions outside the image are invalid
    there, and a ray that leaves the image never comes back, so the nearest
    valid y along that row, below or above, is the ray's."""
    H, W = disp.shape[-2:]
    dev = disp.device
    c = torch.arange(W + H - 1, device=dev)[:, None]
    y = torch.arange(H, device=dev)
    x = c - (H - 1) + y if dx == 1 else c - y           # (W + H - 1, H)
    sheared = valid[..., y, x.clamp(0, W - 1)] & (x >= 0) & (x < W)
    yy = y[:, None]
    cc = torch.arange(W, device=dev) + (-yy + (H - 1) if dx == 1 else yy)
    flat = disp.reshape(-1, H * W)
    held = []
    for down in (True, False):
        ystar, found = _nearest(sheared, -1, forward=down)
        ys = ystar[..., cc, yy]                         # (..., H, W)
        # pixel (ys, xs) = (ys, cc - (H - 1) + ys) or (ys, cc - ys)
        at = ys * (W + 1) + (cc - (H - 1)) if dx == 1 else ys * (W - 1) + cc
        got = flat.gather(1, at.clamp(0, H * W - 1).reshape(flat.shape[0],
                                                            -1))
        held.append(torch.where(found[..., cc, yy], got.reshape(disp.shape),
                                _FBIG))
    return held


def fill_background(disp: torch.Tensor) -> torch.Tensor:
    """Fill each invalid (-1) pixel of (..., H, W) with the lower of its
    nearest valid left and right row neighbours (the occlusion rule: an
    occluded pixel belongs to the background), or the one that exists;
    pixels with neither stay -1."""
    valid = disp >= 0
    li, lh = _nearest(valid, -1, forward=False)
    ri, rh = _nearest(valid, -1, forward=True)
    lv, rv = disp.gather(-1, li), disp.gather(-1, ri)
    fill = torch.where(lh & rh, torch.minimum(lv, rv),
                       torch.where(lh, lv, torch.where(rh, rv, -1.0)))
    return torch.where(valid, disp, fill)


def fill_hirschmuller(disp: torch.Tensor,
                      mismatch: torch.Tensor) -> torch.Tensor:
    """Hirschmueller's gap fill of (..., H, W): the nearest valid disparity
    along each of 8 rays, sorted; an occlusion (no epipolar hit) takes the
    second lowest (the lowest when only one ray finds a value), a mismatch
    (`mismatch`, the hits map) the lower median. Pixels no ray reaches stay
    invalid."""
    valid = disp >= 0
    vals = torch.stack([
        _hold_line(disp, valid, -1, True),      # ray (0, +1)
        _hold_line(disp, valid, -1, False),     # ray (0, -1)
        _hold_line(disp, valid, -2, True),      # ray (+1, 0)
        _hold_line(disp, valid, -2, False),     # ray (-1, 0)
        *_hold_diags(disp, valid, 1),           # rays (1, 1), (-1, -1)
        *_hold_diags(disp, valid, -1),          # rays (1, -1), (-1, 1)
    ])
    k = (vals < _FBIG).sum(0)                   # rays that found a value
    s = list(vals)
    for i, j in SORT8_NET:
        s[i], s[j] = torch.minimum(s[i], s[j]), torch.maximum(s[i], s[j])
    idx = torch.where(mismatch, (k - 1) // 2, (k - 1).clamp(max=1))
    fill = s[0]
    for i in range(1, 4):                       # idx <= (8 - 1) // 2 = 3
        fill = torch.where(idx == i, s[i], fill)
    return torch.where(valid | (k == 0), disp, fill)


# ---------------------------------------------------------------------------
# median
# ---------------------------------------------------------------------------

def median3(disp: torch.Tensor) -> torch.Tensor:
    """3x3 median with edge replication within each frame; (..., H, W)
    float32. Invalid pixels (-1.0) take part like any value."""
    H, W = disp.shape[-2:]
    dev = disp.device
    rows = torch.arange(-1, H + 1, device=dev).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=dev).clamp(0, W - 1)
    p = disp[..., rows, :][..., cols]
    t = [p[..., dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    for i, j in MEDIAN_NET:
        t[i], t[j] = torch.minimum(t[i], t[j]), torch.maximum(t[i], t[j])
    return t[4].contiguous()
