"""Connected-component labels of the speckle graph, and speckle's mask from
the components' sizes: CUDA kernel wrappers.

Counterpart of the JAX package's `kernels/cc_pallas.py`
(`connected_component_labels_pallas`). The kernel is `csrc/cc_labels.cu`, a
block-based union-find: each tile of TILE_ROWS x TILE_COLS pixels of a
frame is labelled in shared memory, then the edges across tile borders are
united with atomics in device memory and every pixel is flattened to its
root (the defaults of `CC_TILE_ROWS` and `CC_TILE_COLS` in the source,
mirrored here for the tests). Its plain version is
`ops.postproc.connected_component_labels`. Neither needs the TPU kernel's
VMEM gate or banded mode: any size with F*H*W < 2**31 runs whole.

`connected_component_big` is speckle's mask in one call: the same kernel
counts each component's pixels while it labels (a count a tile-component
in shared memory, then one atomic a tile-component into its root's
counter) and a last pass writes valid & (size >= thresh). It stands in
for the labels, their frame offsets and `ops.postproc.component_big` (a
sort of every label and two binary searches), which its CPU route runs.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from tpustereo_torch.kernels import _build
from tpustereo_torch.ops.postproc import (
    component_big,
    connected_component_labels as connected_component_labels_plain)

TILE_ROWS, TILE_COLS = 16, 128
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # conn_h, conn_v, lab, F, H, W, stream
    "cc_labels_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
    # conn_h, conn_v, valid, lab, count, big, F, H, W, thresh, stream
    "cc_big_launch": ([_P] * 6 + [_I] * 4 + [_P], _I),
}


def _edge_shape(conn_h: torch.Tensor, conn_v: torch.Tensor, what: str):
    """The edge masks' checks: -> (batch shape, F, H, W)."""
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
        raise ValueError(f"{what} needs F*H*W < 2**31")
    if conn_h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {conn_h.device}")
    if conn_h.device.type == "cuda" and not (conn_h.is_contiguous()
                                             and conn_v.is_contiguous()):
        raise ValueError("conn_h and conn_v must be contiguous")
    return batch, F, H, W


def connected_component_labels(conn_h: torch.Tensor,
                               conn_v: torch.Tensor) -> torch.Tensor:
    """4-connected component labels: conn_h (F, H, W-1) and conn_v
    (F, H-1, W) bool, or (H, W-1) and (H-1, W), -> int32 labels of shape
    (F, H, W) or (H, W), each the component's minimum linear index within
    its frame (stride W).

    CUDA tensors run the kernel (one count per call, which launches its
    local, border and flatten passes), CPU tensors the plain version."""
    batch, F, H, W = _edge_shape(conn_h, conn_v, "connected_component_labels")
    if conn_h.device.type == "cpu":
        return connected_component_labels_plain(conn_h, conn_v)
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


def connected_component_big(conn_h: torch.Tensor, conn_v: torch.Tensor,
                            valid: torch.Tensor, thresh: int) -> torch.Tensor:
    """valid & (the pixel's 4-connected component has at least `thresh`
    pixels): the edge masks as `connected_component_labels` takes them,
    valid bool (F, H, W) or (H, W) -> bool of that shape. Components are
    frame-local; the mask is bit for bit `valid & component_big` of the
    labels offset by f*H*W.

    CUDA tensors run the labelling kernel with its size count (one count
    per call, which launches its counting local pass, the border unions,
    the sizes and the mask), CPU tensors the plain labels and
    `component_big`."""
    batch, F, H, W = _edge_shape(conn_h, conn_v, "connected_component_big")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if tuple(valid.shape) != (*batch, H, W):
        raise ValueError(f"valid must be of shape {(*batch, H, W)}")
    if valid.device != conn_h.device:
        raise ValueError("valid and the edge masks must be on one device")
    if isinstance(thresh, bool) or not isinstance(thresh, numbers.Integral):
        raise TypeError("thresh must be an integer")
    thresh = int(thresh)
    if conn_h.device.type == "cpu":
        lab = connected_component_labels_plain(conn_h, conn_v)
        base = torch.arange(0, F * H * W, H * W, dtype=torch.int32)
        big = component_big(lab.reshape(F, H * W) + base[:, None], thresh)
        return valid & big.reshape(valid.shape)
    if not valid.is_contiguous():
        raise ValueError("valid must be contiguous")
    dev = conn_h.device
    lab = torch.empty((F, H, W), dtype=torch.int32, device=dev)
    count = torch.empty_like(lab)
    big = torch.empty_like(valid)
    lib = _build.load("cc_labels", _SIGS)
    # a size is 1 .. H*W: thresholds past either end test the same
    t = min(max(thresh, 0), H * W + 1)
    rc = lib.cc_big_launch(_build.ptr(conn_h), _build.ptr(conn_v),
                           _build.ptr(valid), _build.ptr(lab),
                           _build.ptr(count), _build.ptr(big), F, H, W, t,
                           _build.stream_ptr(conn_h))
    _build.check(lib, rc, "connected_component_big")
    connected_component_big.launches += 1
    return big


connected_component_big.launches = 0
