"""Connected-component labels of the speckle graph: CUDA kernel wrapper.

Counterpart of the JAX package's `kernels/cc_pallas.py`
(`connected_component_labels_pallas`). The kernel is `csrc/cc_labels.cu`, a
union-find with atomics; its plain version is
`ops.postproc.connected_component_labels`. Neither needs the TPU kernel's
VMEM gate or banded mode: any size with F*H*W < 2**31 runs whole.
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.kernels import _build
from tpustereo_torch.ops.postproc import (
    connected_component_labels as connected_component_labels_plain)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # conn_h, conn_v, lab, F, H, W, stream
    "cc_labels_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
}


def connected_component_labels(conn_h: torch.Tensor,
                               conn_v: torch.Tensor) -> torch.Tensor:
    """4-connected component labels: conn_h (F, H, W-1) and conn_v
    (F, H-1, W) bool, or (H, W-1) and (H-1, W), -> int32 labels of shape
    (F, H, W) or (H, W), each the component's minimum linear index within
    its frame (stride W).

    CUDA tensors run the kernel, CPU tensors the plain version."""
    if conn_h.dim() not in (2, 3) or conn_v.dim() != conn_h.dim():
        raise ValueError("need conn_h and conn_v of rank 2 or 3 alike")
    if conn_h.dtype != torch.bool or conn_v.dtype != torch.bool:
        raise TypeError("conn_h and conn_v must be bool")
    *batch, H, Wm1 = conn_h.shape
    W = Wm1 + 1
    if tuple(conn_v.shape) != (*batch, H - 1, W) or H < 1:
        raise ValueError(f"conn_h {tuple(conn_h.shape)} and conn_v "
                         f"{tuple(conn_v.shape)} are not (.., H, W-1) and "
                         f"(.., H-1, W)")
    if conn_h.device != conn_v.device:
        raise ValueError("conn_h and conn_v must be on one device")
    F = batch[0] if batch else 1
    if F * H * W >= 1 << 31:
        raise ValueError("connected_component_labels needs F*H*W < 2**31")
    if conn_h.device.type == "cpu":
        return connected_component_labels_plain(conn_h, conn_v)
    if conn_h.device.type != "cuda":
        raise ValueError(f"unsupported device {conn_h.device}")
    if not (conn_h.is_contiguous() and conn_v.is_contiguous()):
        raise ValueError("conn_h and conn_v must be contiguous")
    lab = torch.empty((*batch, H, W), dtype=torch.int32,
                      device=conn_h.device)
    lib = _build.load("cc_labels", _SIGS)
    rc = lib.cc_labels_launch(_build.ptr(conn_h), _build.ptr(conn_v),
                              _build.ptr(lab), F, H, W,
                              _build.stream_ptr(conn_h))
    _build.check(lib, rc, "connected_component_labels")
    connected_component_labels.launches += 1
    return lab


connected_component_labels.launches = 0
