"""Post-processing in plain PyTorch: the left-right check, speckle and the
3x3 median.

Counterparts of the JAX package's `ops/postproc.py`:

- `_right_disparity`, `dr_consistency` and `lr_check`, in its convention:
  d_R in true pixel units indexed by the right image's column. (The fused
  kernel path uses the shifted-column index map instead; see
  `kernels/lr.py`.) `torch.round`, like `jnp.round`, rounds half to even.
- `connected_component_labels`, `component_big`, `speckle_labels`,
  `speckle` and `speckle_frames`: 4-connected components of the speckle
  graph (valid pixels, |delta d| <= speckle_range in float32), labelled by
  their minimum linear index; pixels of components smaller than
  `speckle_window_size` are invalidated. The speckle functions take the
  labelling function as `cc`, so the pipeline can hand them the CUDA
  kernel's wrapper (`kernels.connected_component_labels`); it defaults to
  the plain `connected_component_labels`.
- `median3`: the 3x3 median with edge replication, by the same 19-exchange
  network, over a batch of frames.
"""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.ops.wta import next_pow2

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
                   cc=connected_component_labels) -> torch.Tensor:
    """`speckle` over (F, H, W) stacked frames: one labelling call for all
    frames, labels offset by f*H*W, one `component_big` over the stack."""
    if cfg.speckle_window_size <= 0:
        return valid
    F, H, W = disp.shape
    if F * H * W >= 1 << 31:
        raise ValueError("speckle_frames needs F*H*W < 2**31")
    lab = speckle_labels(disp, valid, cfg, cc)
    base = torch.arange(0, F * H * W, H * W, dtype=torch.int32,
                        device=disp.device).reshape(F, 1, 1)
    return valid & component_big(lab + base, cfg.speckle_window_size)


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
