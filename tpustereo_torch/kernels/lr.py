"""d_L / d_R consistency check: CUDA kernel wrapper and plain version.

Counterpart of the JAX package's `kernels/lr_pallas.py`
(`dr_consistency_pallas`, without `with_hits`). The kernel is
`csrc/lr_check.cu`. Both take d_r as the fused path's index map in the
shifted-column convention (see `kernels.sgm.sweep_bwd_wta`) and disp in
true units.
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.kernels import _build

_BIG = 1 << 20
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # d_r, disp, ok, n, W, D, max_diff, d_start, stream
    "lr_check_launch": ([_P] * 3 + [ctypes.c_long] + [_I] * 4 + [_P], _I),
}


def dr_consistency_plain(d_r: torch.Tensor, disp: torch.Tensor,
                         num_disp: int, max_diff: int,
                         d_start: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: one gather per pixel."""
    W = d_r.shape[-1]
    dl = torch.round(disp).to(torch.int32) - d_start
    col = torch.arange(W, device=d_r.device, dtype=torch.int32) - dl
    look = d_r.to(torch.int32).gather(-1, col.clamp(0, W - 1).long())
    hit = (dl >= 0) & (dl < min(num_disp, W)) & (col >= d_start) & (col >= 0)
    res = torch.where(hit, look, _BIG)
    return (dl - res).abs() <= max_diff


def dr_consistency(d_r: torch.Tensor, disp: torch.Tensor, num_disp: int,
                   max_diff: int, d_start: int = 0) -> torch.Tensor:
    """|d_L(x) - d_r(x - d_L(x))| <= max_diff in disparity-index units,
    d_L = round(disp) - d_start; (..., W) int32 + float32 -> bool.

    Lookups with d_L outside [0, min(D, W)) or at a column < d_start fail.
    CUDA tensors run the kernel, CPU tensors the plain version."""
    if d_r.shape != disp.shape or d_r.dim() < 1 or d_r.numel() == 0:
        raise ValueError(f"need equal non-empty shapes, got "
                         f"{tuple(d_r.shape)} and {tuple(disp.shape)}")
    if d_r.dtype != torch.int32 or disp.dtype != torch.float32:
        raise TypeError("d_r must be int32 and disp float32")
    if d_r.device != disp.device:
        raise ValueError("d_r and disp must be on one device")
    if num_disp <= 0 or d_start < 0:
        raise ValueError("need num_disp > 0 and d_start >= 0")
    if d_r.device.type == "cpu":
        return dr_consistency_plain(d_r, disp, num_disp, max_diff, d_start)
    if d_r.device.type != "cuda":
        raise ValueError(f"unsupported device {d_r.device}")
    if not (d_r.is_contiguous() and disp.is_contiguous()):
        raise ValueError("d_r and disp must be contiguous")
    ok = torch.empty(d_r.shape, dtype=torch.bool, device=d_r.device)
    lib = _build.load("lr_check", _SIGS)
    rc = lib.lr_check_launch(_build.ptr(d_r), _build.ptr(disp),
                             _build.ptr(ok), d_r.numel(), d_r.shape[-1],
                             num_disp, max_diff, d_start,
                             _build.stream_ptr(d_r))
    _build.check(lib, rc, "dr_consistency")
    dr_consistency.launches += 1
    return ok


dr_consistency.launches = 0
