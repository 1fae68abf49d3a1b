"""Fused census + Hamming cost volume: CUDA kernel wrapper and plain version.

Counterpart of the JAX package's `kernels/cost_pallas.py`
(`census_cost_volume_pallas`). The kernel is `csrc/census_cost.cu`; it
emits the plain (B, H, W, D) volume, with no padding and no transposed copy
(the horizontal sweeps read this layout directly).
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.kernels import _build
from tpustereo_torch.ops.census import census, cost_volume

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "census_cost_smem_bytes": ([_I, _I], ctypes.c_size_t),
    # left, right, cost, B, H, W, D, ch, cw, d_start, max_cost, stream
    "census_cost_launch": ([_P] * 3 + [_I] * 8 + [_P], _I),
}


def census_cost_volume_plain(left: torch.Tensor, right: torch.Tensor,
                             num_disp: int, max_cost: int, window=(5, 5),
                             d_start: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch (`ops.census`)."""
    return cost_volume(census(left, window), census(right, window), num_disp,
                       max_cost, d_start)


def census_cost_volume(left: torch.Tensor, right: torch.Tensor,
                       num_disp: int, max_cost: int, window=(5, 5),
                       d_start: int = 0) -> torch.Tensor:
    """(B, H, W) uint8 x2 -> (B, H, W, D) uint8 cost volume.

    C[b, y, x, d] = popcount(census_L[x] ^ census_R[x - d_start - d]),
    max_cost where x - d_start - d < 0. CUDA tensors run the kernel, CPU
    tensors the plain version."""
    ch, cw = window
    if left.shape != right.shape or left.dim() != 3 or left.numel() == 0:
        raise ValueError(f"need two equal non-empty (B, H, W) images, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    if left.dtype != torch.uint8 or right.dtype != torch.uint8:
        raise TypeError("images must be uint8")
    if left.device != right.device:
        raise ValueError("images must be on one device")
    if ch % 2 == 0 or cw % 2 == 0 or ch * cw - 1 > 64:
        raise ValueError(f"census window {window} must be odd and <= 64 bits")
    if not 0 < num_disp or d_start < 0 or not 0 <= max_cost <= 255:
        raise ValueError("need num_disp > 0, d_start >= 0, max_cost in "
                         "[0, 255]")
    if left.device.type == "cpu":
        return census_cost_volume_plain(left, right, num_disp, max_cost,
                                        window, d_start)
    if left.device.type != "cuda":
        raise ValueError(f"unsupported device {left.device}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("images must be contiguous")
    B, H, W = left.shape
    lib = _build.load("census_cost", _SIGS)
    if lib.census_cost_smem_bytes(W, ch) > _build.SMEM_MAX:
        raise ValueError(f"image width {W} exceeds the kernel's shared "
                         f"memory")
    out = torch.empty((B, H, W, num_disp), dtype=torch.uint8,
                      device=left.device)
    rc = lib.census_cost_launch(
        _build.ptr(left), _build.ptr(right), _build.ptr(out), B, H, W,
        num_disp, ch, cw, d_start, max_cost, _build.stream_ptr(left))
    _build.check(lib, rc, "census_cost_volume")
    census_cost_volume.launches += 1
    return out


census_cost_volume.launches = 0
