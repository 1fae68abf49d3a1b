"""Bitonic sort of int32 keys with an optional payload: CUDA kernel wrapper
and plain version.

Counterpart of the JAX package's `kernels/bitonic_pallas.py`
(`bitonic_sort_pallas`). The kernel is `csrc/bitonic.cu`. Both versions
pad each row as the JAX function does, to max(256, next power of two) with
2^31 - 1 keys and 0 payloads, and run the same XOR-pairing network with
the same tie rule, so with equal keys the payload comes out in the JAX
kernel's order, not merely in some order. The JAX function sorts one flat
array; here every leading index is one independent sort. Unlike the TPU
kernel (`MAX_LOG2_PAIR = 21`, a VMEM and compile-time limit) any length up
to 2^30 runs.

The kernel works in tiles of 2^TILE_LOG2 elements in shared memory and
runs the substages at or above the tile GLOBAL_M to a launch (the defaults
of `BITONIC_TILE_LOG2` and `BITONIC_GLOBAL_M` in the source, mirrored here
for the tests and `chip_smoke.py`).
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.kernels import _build

IMAX = (1 << 31) - 1  # the pad key: real keys must lie below it
TILE_LOG2 = 14
GLOBAL_M = 5
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # keys, payload (or null), rows, log2 of the padded length, stream
    "bitonic_launch": ([_P, _P, _I, _I, _P], _I),
    # log2 of the padded length -> kernel launches of one call
    "bitonic_launches": ([_I], _I),
}


def padded_log2(n: int) -> int:
    """log2 of the padded length max(256, next_pow2(n))."""
    return max(8, (n - 1).bit_length())


def kernel_launches(n: int) -> int:
    """The CUDA kernel launches that one `bitonic_sort` of rows of n keys
    makes on the card (the source's own schedule, counted without
    launching; builds the library)."""
    return _build.load("bitonic", _SIGS).bitonic_launches(padded_log2(n))


def _pad(x: torch.Tensor, n2: int, fill: int) -> torch.Tensor:
    rows, n = x.shape
    out = torch.full((rows, n2), fill, dtype=torch.int32, device=x.device)
    out[:, :n] = x
    return out


def bitonic_sort_plain(keys: torch.Tensor,
                       payload: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch: the network one substage at
    a time, each a reshape to (rows, n2 / 2^(j+1), 2, 2^j) and a
    compare-exchange of its two halves."""
    *lead, n = keys.shape
    L = padded_log2(n)
    n2 = 1 << L
    ops = [_pad(keys.reshape(-1, n), n2, IMAX)]
    if payload is not None:
        ops.append(_pad(payload.reshape(-1, n), n2, 0))
    rows = ops[0].shape[0]
    for k in range(1, L + 1):
        for j in range(k - 1, -1, -1):
            m = 1 << j
            a = torch.arange(n2 // (2 * m), device=keys.device)
            asc = (((a >> (k - j - 1)) & 1) == 0)[None, :, None]
            xs = [x.reshape(rows, n2 // (2 * m), 2, m) for x in ops]
            lo, hi = xs[0][:, :, 0], xs[0][:, :, 1]
            swap = torch.where(asc, hi < lo, lo < hi)
            ops = [torch.stack([torch.where(swap, x[:, :, 1], x[:, :, 0]),
                                torch.where(swap, x[:, :, 0], x[:, :, 1])],
                               2).reshape(rows, n2) for x in xs]
    out = [x[:, :n].reshape(*lead, n) for x in ops]
    return out[0] if payload is None else tuple(out)


def bitonic_sort(keys: torch.Tensor, payload: torch.Tensor | None = None):
    """Sort int32 keys (..., n) ascending along the last axis, with an
    optional int32 payload of the same shape permuted alongside; each
    leading index is one sort. Keys must lie below 2^31 - 1, the pad key.
    Returns the sorted keys, or (keys, payload).

    CUDA tensors run the kernel (one count per call, which launches its
    tile and fused global passes: `kernel_launches(n)` of them), CPU
    tensors the plain version."""
    if keys.dim() < 1 or keys.numel() == 0 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be a non-empty int32 tensor, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if payload is not None and (payload.shape != keys.shape
                                or payload.dtype != torch.int32
                                or payload.device != keys.device):
        raise ValueError("payload must be int32 of the keys' shape and "
                         "device")
    *lead, n = keys.shape
    L = padded_log2(n)
    if L > 30:
        raise ValueError(f"n = {n} > 2^30 unsupported")
    if keys.device.type == "cpu":
        return bitonic_sort_plain(keys, payload)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    rows = keys.numel() // n
    if rows > 65535:
        raise ValueError(f"{rows} rows > 65535 unsupported")
    k = _pad(keys.reshape(rows, n), 1 << L, IMAX)
    p = None if payload is None else _pad(payload.reshape(rows, n), 1 << L, 0)
    lib = _build.load("bitonic", _SIGS)
    rc = lib.bitonic_launch(_build.ptr(k),
                            None if p is None else _build.ptr(p), rows, L,
                            _build.stream_ptr(keys))
    _build.check(lib, rc, "bitonic_sort")
    bitonic_sort.launches += 1
    out = [x[:, :n].reshape(*lead, n) for x in (k, p) if x is not None]
    return out[0] if payload is None else tuple(out)


bitonic_sort.launches = 0
