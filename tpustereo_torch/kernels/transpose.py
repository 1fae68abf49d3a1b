"""(B, H, W, D) -> (B, W, H, D) volume relayouts: CUDA kernel wrappers and
plain versions.

Counterparts of the JAX package's `kernels/transpose_pallas.py`
(`transpose_hw_pallas`, `transpose_sum_hw_pallas`), which hand C and S
between the vertical and the horizontal sweep layouts. The kernels are
`csrc/transpose.cu`; nothing is padded.
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # x, y, B, H, W, bytes per pixel, stream
    "transpose_hw_launch": ([_P, _P] + [_I] * 4 + [_P], _I),
    # a, b, y, B, H, W, D, stream
    "transpose_sum_hw_launch": ([_P] * 3 + [_I] * 4 + [_P], _I),
}


def _check(x: torch.Tensor, name: str, dtypes) -> None:
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{name} must be a non-empty (B, H, W, D) volume, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def transpose_hw_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return x.transpose(-3, -2).contiguous()


def transpose_hw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, D) uint8 or int16 -> (B, W, H, D), contiguous.

    CUDA tensors run the kernel, CPU tensors the plain version."""
    _check(x, "x", (torch.uint8, torch.int16))
    if x.device.type == "cpu":
        return transpose_hw_plain(x)
    B, H, W, D = x.shape
    y = torch.empty((B, W, H, D), dtype=x.dtype, device=x.device)
    lib = _build.load("transpose", _SIGS)
    rc = lib.transpose_hw_launch(_build.ptr(x), _build.ptr(y), B, H, W,
                                 D * x.element_size(), _build.stream_ptr(x))
    _build.check(lib, rc, "transpose_hw")
    transpose_hw.launches += 1
    return y


transpose_hw.launches = 0


def transpose_sum_hw_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return (a + b).transpose(-3, -2).contiguous()


def transpose_sum_hw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) transposed in one pass: (B, H, W, D) int16 x2 -> (B, W, H, D)
    int16, wrapping as int16 addition does.

    CUDA tensors run the kernel, CPU tensors the plain version."""
    _check(a, "a", (torch.int16,))
    _check(b, "b", (torch.int16,))
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"a and b must have one shape and device, got "
                         f"{tuple(a.shape)} on {a.device} and "
                         f"{tuple(b.shape)} on {b.device}")
    if a.device.type == "cpu":
        return transpose_sum_hw_plain(a, b)
    B, H, W, D = a.shape
    y = torch.empty((B, W, H, D), dtype=a.dtype, device=a.device)
    lib = _build.load("transpose", _SIGS)
    rc = lib.transpose_sum_hw_launch(_build.ptr(a), _build.ptr(b),
                                     _build.ptr(y), B, H, W, D,
                                     _build.stream_ptr(a))
    _build.check(lib, rc, "transpose_sum_hw")
    transpose_sum_hw.launches += 1
    return y


transpose_sum_hw.launches = 0
