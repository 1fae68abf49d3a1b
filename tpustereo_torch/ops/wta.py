"""WTA disparity selection + uniqueness + subpixel parabola fit, plain
PyTorch.

Counterpart of the JAX package's `ops/wta.py`, with its conventions kept:

* argmin by one packed (value * next_pow2(D) + d) min, so ties go to the
  lowest d (`torch.argmin` documents no tie rule on CUDA);
* uniqueness: the best is unique unless some d with |d - d*| > 1 has
  second * 100 < best * (100 + ratio);
* subpixel: S at d*-1 / d*+1 clamped into the search range, the parabola
  vertex in the same float32 op order, applied only at interior d*.
"""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config

_BIG = 1 << 24


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def wta(S: torch.Tensor, cfg: Config):
    """S (..., H, W, D) int -> (disp float32, d_int int32, valid bool)."""
    D = S.shape[-1]
    Si = S.to(torch.int32)
    iota = torch.arange(D, dtype=torch.int32, device=S.device)
    shift = next_pow2(max(D, 2))
    bits = shift.bit_length() - 1
    m = (Si * shift + iota).amin(-1)
    best = m >> bits
    j_int = m & (shift - 1)
    valid = torch.ones(best.shape, dtype=torch.bool, device=S.device)

    if cfg.uniqueness_ratio > 0:
        near = (iota - j_int[..., None]).abs() <= 1
        second = torch.where(near, _BIG, Si).amin(-1)
        valid &= ~(second * 100 < best * (100 + cfg.uniqueness_ratio))

    d_int = j_int + cfg.min_disparity
    disp = d_int.to(torch.float32)
    if cfg.subpixel:
        dm = (j_int - 1).clamp(min=0)[..., None].long()
        dp = (j_int + 1).clamp(max=D - 1)[..., None].long()
        smf = Si.gather(-1, dm)[..., 0].to(torch.float32)
        spf = Si.gather(-1, dp)[..., 0].to(torch.float32)
        s0 = best.to(torch.float32)
        denom = smf - 2.0 * s0 + spf
        offs = torch.where(denom > 0,
                           (smf - spf) / torch.clamp(2.0 * denom, min=1e-9),
                           0.0)
        offs = offs.clamp(-0.5, 0.5)
        interior = (j_int > 0) & (j_int < D - 1)
        disp = disp + torch.where(interior, offs, 0.0)
    return disp, d_int, valid
