"""d_L / d_R consistency check, alone or with the epipolar-intersection map
of the Hirschmueller fill: CUDA kernel wrappers and plain versions.

Counterpart of the JAX package's `kernels/lr_pallas.py`
(`dr_consistency_pallas`, `with_hits` False and True). The kernels are in
`csrc/lr_check.cu`. All take d_r as the fused path's index map in the
shifted-column convention (see `kernels.sgm.sweep_bwd_wta`) and disp in
true units.
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.kernels import _build

_BIG = 1 << 20
# pixels of the flattened (rows, W) map a block of the hits kernel takes:
# LR_THREADS * LR_GROUPS * 4 in `csrc/lr_check.cu`
HITS_TILE = 2048
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # d_r, disp, ok, n, W, D, max_diff, d_start, stream
    "lr_check_launch": ([_P] * 3 + [ctypes.c_long] + [_I] * 4 + [_P], _I),
    # d_r, disp, ok, hits, rows, W, D, max_diff, d_start, stream
    "lr_hits_launch": ([_P] * 4 + [_I] * 5 + [_P], _I),
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


def dr_consistency_hits_plain(d_r: torch.Tensor, disp: torch.Tensor,
                              num_disp: int, max_diff: int,
                              d_start: int = 0):
    """The hits kernel's function in plain PyTorch: `dr_consistency_plain`,
    and the hits map by one shifted compare per disparity index."""
    W = d_r.shape[-1]
    d_r = d_r.to(torch.int32)
    in_image = torch.arange(W, device=d_r.device) >= d_start
    hits = torch.zeros(d_r.shape, dtype=torch.bool, device=d_r.device)
    for j in range(min(num_disp, W)):
        hits[..., j:] |= (((d_r[..., :W - j] - j).abs() <= max_diff)
                          & in_image[:W - j])
    return (dr_consistency_plain(d_r, disp, num_disp, max_diff, d_start),
            hits)


def _check(d_r: torch.Tensor, disp: torch.Tensor, num_disp: int,
           d_start: int) -> None:
    if d_r.shape != disp.shape or d_r.dim() < 1 or d_r.numel() == 0:
        raise ValueError(f"need equal non-empty shapes, got "
                         f"{tuple(d_r.shape)} and {tuple(disp.shape)}")
    if d_r.dtype != torch.int32 or disp.dtype != torch.float32:
        raise TypeError("d_r must be int32 and disp float32")
    if d_r.device != disp.device:
        raise ValueError("d_r and disp must be on one device")
    if num_disp <= 0 or d_start < 0:
        raise ValueError("need num_disp > 0 and d_start >= 0")
    if d_r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {d_r.device}")
    if d_r.device.type == "cuda" and not (d_r.is_contiguous()
                                          and disp.is_contiguous()):
        raise ValueError("d_r and disp must be contiguous")


def dr_consistency(d_r: torch.Tensor, disp: torch.Tensor, num_disp: int,
                   max_diff: int, d_start: int = 0) -> torch.Tensor:
    """|d_L(x) - d_r(x - d_L(x))| <= max_diff in disparity-index units,
    d_L = round(disp) - d_start; (..., W) int32 + float32 -> bool.

    Lookups with d_L outside [0, min(D, W)) or at a column < d_start fail.
    CUDA tensors run the kernel, CPU tensors the plain version."""
    _check(d_r, disp, num_disp, d_start)
    if d_r.device.type == "cpu":
        return dr_consistency_plain(d_r, disp, num_disp, max_diff, d_start)
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


def dr_consistency_hits(d_r: torch.Tensor, disp: torch.Tensor,
                        num_disp: int, max_diff: int, d_start: int = 0):
    """`dr_consistency` and the epipolar-intersection map in one pass:
    -> (ok, hits), both bool of d_r's shape, with hits[x] iff some
    j < min(D, W) has x - j >= d_start and |d_r[x - j] - j| <= max_diff.
    Any W runs: the kernel takes tiles of `HITS_TILE` pixels.

    CUDA tensors run the kernel, CPU tensors the plain version."""
    _check(d_r, disp, num_disp, d_start)
    if d_r.device.type == "cpu":
        return dr_consistency_hits_plain(d_r, disp, num_disp, max_diff,
                                         d_start)
    W = d_r.shape[-1]
    # the kernel's 16-byte loads need aligned maps
    d_r = d_r.clone() if d_r.data_ptr() % 16 else d_r
    disp = disp.clone() if disp.data_ptr() % 16 else disp
    ok = torch.empty(d_r.shape, dtype=torch.bool, device=d_r.device)
    hits = torch.empty_like(ok)
    lib = _build.load("lr_check", _SIGS)
    rc = lib.lr_hits_launch(_build.ptr(d_r), _build.ptr(disp), _build.ptr(ok),
                            _build.ptr(hits), d_r.numel() // W, W, num_disp,
                            max_diff, d_start, _build.stream_ptr(d_r))
    _build.check(lib, rc, "dr_consistency_hits")
    dr_consistency_hits.launches += 1
    return ok, hits


dr_consistency_hits.launches = 0
