"""SAD block-matching cost volume in plain PyTorch.

Counterpart of the JAX package's `ops/sad.py` (`sad_volume`), with its
semantics: the absolute-difference volume A = |L - R(x - d)|, 255 where
x - d < 0, for d = d_start + j; the filled volume is edge-padded by
r = block // 2 on both image axes and summed over block x block taps, so
output pixel (y, x) sums image rows y - r .. y - r + block - 1 and columns
x - r .. x - r + block - 1, each clamped into the image (for an even block
too). The JAX log-shear and binary window sums are TPU workarounds; here
the shift is a gather at clamped columns and the box sum a loop of integer
slice adds, exact like the reference.

This is the plain version of the fused SAD kernel (`kernels/sad.py`) and
the parity target of the tests. Functions take any leading batch dims.
"""

from __future__ import annotations

import torch


def _clamped(n: int, r: int, block: int, dev) -> torch.Tensor:
    """Source index of each of the n + block - 1 edge-padded positions."""
    return (torch.arange(n + block - 1, device=dev) - r).clamp(0, n - 1)


def sad_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int,
               block: int, d_start: int = 0) -> torch.Tensor:
    """(..., H, W) uint8 x2 -> (..., H, W, D) int32, plane j searching
    disparity d_start + j."""
    H, W = left.shape[-2:]
    dev = left.device
    li = left.to(torch.int32)
    ri = right.to(torch.int32)
    xs = torch.arange(W, device=dev)[:, None]
    idx = xs - d_start - torch.arange(num_disp, device=dev)[None, :]  # (W, D)
    G = ri[..., idx.clamp(0, W - 1)]                    # (..., H, W, D)
    A = torch.where(idx >= 0, (li[..., None] - G).abs(), 255)
    del G
    r = block // 2
    rows = A.index_select(-3, _clamped(H, r, block, dev))
    V = sum(rows[..., k:k + H, :, :] for k in range(block))
    del rows
    cols = V.index_select(-2, _clamped(W, r, block, dev))
    return sum(cols[..., k:k + W, :] for k in range(block)).to(torch.int32)
