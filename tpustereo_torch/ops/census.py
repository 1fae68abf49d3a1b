"""Census transform + Hamming cost volume in plain PyTorch.

Counterpart of the JAX package's `ops/census.py`, with the same
conventions: edge-replication borders, bit k of the window walked row-major
with the centre skipped, bit set iff neighbour < centre, and
`x - d_start - d < 0 -> max_cost`. The census of a window of up to 64 bits
is one int64 word per pixel (the JAX version keeps uint32 planes; word
`p0 | p1 << 32` is the same bits).

This is the plain version of the cost kernel (`kernels/cost.py`) and the
parity target of the tests. All functions take any leading batch dims.
"""

from __future__ import annotations

import torch

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def popcount64(v: torch.Tensor) -> torch.Tensor:
    """Bit count of each int64 (all 64 bits, sign bit included).

    SWAR fold; every shift is masked so the arithmetic right shift of a
    negative word gives the same bits as a logical one."""
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    v = v + (v >> 8)
    v = v + (v >> 16)
    v = v + (v >> 32)
    return v & 0x7F


def census(img: torch.Tensor, window=(5, 5)) -> torch.Tensor:
    """(..., H, W) uint8 -> (..., H, W) int64 census words."""
    ch, cw = window
    ry, rx = ch // 2, cw // 2
    if ch * cw - 1 > 64:
        raise ValueError("census window larger than 64 bits unsupported")
    H, W = img.shape[-2:]
    dev = img.device
    out = torch.zeros(img.shape, dtype=torch.int64, device=dev)
    bit = 0
    for dy in range(-ry, ry + 1):
        ys = (torch.arange(H, device=dev) + dy).clamp(0, H - 1)
        rows = img.index_select(-2, ys)
        for dx in range(-rx, rx + 1):
            if dy == 0 and dx == 0:
                continue
            xs = (torch.arange(W, device=dev) + dx).clamp(0, W - 1)
            q = rows.index_select(-1, xs)
            out |= (q < img).to(torch.int64) << bit
            bit += 1
    return out


def cost_volume(cen_l: torch.Tensor, cen_r: torch.Tensor, num_disp: int,
                max_cost: int, d_start: int = 0) -> torch.Tensor:
    """C[..., y, x, d] = popcount(cenL[x] ^ cenR[x - d_start - d]);
    out-of-image -> max_cost. (..., H, W) int64 -> (..., H, W, D) uint8."""
    W = cen_l.shape[-1]
    dev = cen_l.device
    xs = torch.arange(W, device=dev)[:, None]
    idx = xs - d_start - torch.arange(num_disp, device=dev)[None, :]  # (W, D)
    gathered = cen_r[..., idx.clamp(0, W - 1)]          # (..., H, W, D)
    pc = popcount64(cen_l[..., None] ^ gathered).to(torch.uint8)
    return torch.where(idx >= 0, pc, torch.full_like(pc, max_cost))
