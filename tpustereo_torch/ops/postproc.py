"""Left-right consistency check in plain PyTorch.

Counterpart of `_right_disparity`, `dr_consistency` and `lr_check` of the
JAX package's `ops/postproc.py`, in its convention: d_R in true pixel units
indexed by the right image's column. (The fused kernel path uses the
shifted-column index map instead; see `kernels/lr.py`.) `torch.round`, like
`jnp.round`, rounds half to even. Speckle and the median are not ported yet.
"""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.ops.wta import next_pow2

_BIG = 1 << 24


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
