"""3x3 median with edge replication: CUDA kernel wrapper.

Counterpart of the JAX package's `kernels/median_pallas.py`
(`median3_pallas`). The kernel is `csrc/median3.cu`; its plain version is
`ops.postproc.median3`.
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.kernels import _build
from tpustereo_torch.ops.postproc import median3 as median3_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # in, out, F, H, W, stream
    "median3_launch": ([_P, _P] + [_I] * 3 + [_P], _I),
}


def median3(disp: torch.Tensor) -> torch.Tensor:
    """(H, W) or (F, H, W) float32 -> the same shape: the 3x3 median of
    each pixel's window, edges replicated within each frame.

    CUDA tensors run the kernel, CPU tensors the plain version."""
    if disp.dim() not in (2, 3) or disp.numel() == 0:
        raise ValueError(f"need a non-empty (H, W) or (F, H, W) map, got "
                         f"{tuple(disp.shape)}")
    if disp.dtype != torch.float32:
        raise TypeError("disp must be float32")
    if disp.device.type == "cpu":
        return median3_plain(disp)
    if disp.device.type != "cuda":
        raise ValueError(f"unsupported device {disp.device}")
    if not disp.is_contiguous():
        raise ValueError("disp must be contiguous")
    F = disp.shape[0] if disp.dim() == 3 else 1
    H, W = disp.shape[-2:]
    out = torch.empty_like(disp)
    lib = _build.load("median3", _SIGS)
    rc = lib.median3_launch(_build.ptr(disp), _build.ptr(out), F, H, W,
                            _build.stream_ptr(disp))
    _build.check(lib, rc, "median3")
    median3.launches += 1
    return out


median3.launches = 0
