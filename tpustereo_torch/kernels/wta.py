"""WTA + uniqueness + subpixel + LR check over a cost volume: CUDA kernel
wrapper and plain version.

Counterpart of the JAX package's `kernels/wta_pallas.py` (`wta_lr_pallas`).
The kernel is `csrc/wta_lr.cu`; it reads the plain (B, H, W, D) volume,
uint8 (the census cost of the census_wta mode), int16 (the aggregated SGM
volume) or int32 (the SAD volume), with no padding.
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.kernels import _build
from tpustereo_torch.kernels.sgm import MAX_D
from tpustereo_torch.ops.postproc import _right_disparity, dr_consistency
from tpustereo_torch.ops.wta import wta

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # S, disp, valid, d_R (or null), the row maps' scratch (or null), rows,
    # W, D, element bytes, uniq, subpixel, d_start, max_diff, stream
    "wta_lr_launch": ([_P] * 5 + [_I] * 8 + [_P], _I),
}


def wta_lr_plain(S: torch.Tensor, cfg: Config, with_dr: bool = False):
    """The kernel's function in plain PyTorch: `ops.wta`, then
    `valid &= ops.lr_check` (`dr_consistency` of `_right_disparity`), and
    that right-view map when asked."""
    disp, _, valid = wta(S, cfg)
    d_R = None
    if cfg.disp12_max_diff >= 0 or with_dr:
        d_R = _right_disparity(S, cfg.min_disparity)
    if cfg.disp12_max_diff >= 0:
        valid &= dr_consistency(d_R, disp, S.shape[-1], cfg.disp12_max_diff,
                                cfg.min_disparity)
    return (disp, valid, d_R) if with_dr else (disp, valid)


def wta_lr(S: torch.Tensor, cfg: Config, with_dr: bool = False):
    """(B, H, W, D) uint8, int16 or int32 volume -> (disp float32, valid
    bool), each (B, H, W), and with `with_dr` also the right-view WTA map
    d_R int32 (B, H, W) in true units indexed by the right column
    (`ops.postproc._right_disparity`). int32 costs must lie below 2^20, as
    every SAD volume of block <= 64 does (255 * block^2): the kernel packs
    cost and index into one int, and the right-view map fills columns past
    the image with 2^20 in both versions.

    disp is in true units (`cfg.min_disparity` added, subpixel applied);
    valid is the uniqueness test and, when `cfg.disp12_max_diff >= 0`, the
    LR check against the right-view WTA of the same volume. CUDA tensors
    run the kernel, CPU tensors the plain version."""
    if S.dim() != 4 or S.numel() == 0:
        raise ValueError(f"S must be a non-empty (B, H, W, D) volume, got "
                         f"{tuple(S.shape)}")
    if S.dtype not in (torch.uint8, torch.int16, torch.int32):
        raise TypeError(f"S must be uint8, int16 or int32, got {S.dtype}")
    if S.shape[-1] > MAX_D:
        raise ValueError(f"D = {S.shape[-1]} > {MAX_D} unsupported")
    if S.device.type == "cpu":
        return wta_lr_plain(S, cfg, with_dr)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    if not S.is_contiguous():
        raise ValueError("S must be contiguous")
    B, H, W, D = S.shape
    lib = _build.load("wta_lr", _SIGS)
    disp = torch.empty((B, H, W), dtype=torch.float32, device=S.device)
    valid = torch.empty((B, H, W), dtype=torch.bool, device=S.device)
    d_R = (torch.empty((B, H, W), dtype=torch.int32, device=S.device)
           if with_dr else None)
    # the right-view rows as packed minima, for the LR check and d_R
    need_map = with_dr or cfg.disp12_max_diff >= 0
    dmap = (torch.empty((B, H, W), dtype=torch.int32, device=S.device)
            if need_map else None)
    rc = lib.wta_lr_launch(
        _build.ptr(S), _build.ptr(disp), _build.ptr(valid),
        _build.ptr(d_R) if with_dr else None,
        _build.ptr(dmap) if need_map else None, B * H, W, D,
        S.element_size(), cfg.uniqueness_ratio, int(cfg.subpixel),
        cfg.min_disparity, cfg.disp12_max_diff, _build.stream_ptr(S))
    _build.check(lib, rc, "wta_lr")
    wta_lr.launches += 1
    return (disp, valid, d_R) if with_dr else (disp, valid)


wta_lr.launches = 0
