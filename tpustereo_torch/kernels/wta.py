"""WTA + uniqueness + subpixel + LR check over a cost volume: CUDA kernel
wrapper and plain version.

Counterpart of the JAX package's `kernels/wta_pallas.py` (`wta_lr_pallas`).
The kernel is `csrc/wta_lr.cu`; it reads the plain (B, H, W, D) volume,
uint8 (the census cost of the census_wta mode) or int16, with no padding.
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.kernels import _build
from tpustereo_torch.kernels.sgm import MAX_D
from tpustereo_torch.ops.postproc import lr_check
from tpustereo_torch.ops.wta import wta

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "wta_lr_smem_bytes": ([_I], ctypes.c_size_t),
    # S, disp, valid, rows, W, D, int16, uniq, subpixel, d_start, max_diff,
    # stream
    "wta_lr_launch": ([_P] * 3 + [_I] * 8 + [_P], _I),
}


def wta_lr_plain(S: torch.Tensor, cfg: Config):
    """The kernel's function in plain PyTorch: `ops.wta`, then
    `valid &= ops.lr_check`."""
    disp, _, valid = wta(S, cfg)
    return disp, valid & lr_check(S, disp, cfg)


def wta_lr(S: torch.Tensor, cfg: Config):
    """(B, H, W, D) uint8 or int16 volume -> (disp float32, valid bool),
    each (B, H, W).

    disp is in true units (`cfg.min_disparity` added, subpixel applied);
    valid is the uniqueness test and, when `cfg.disp12_max_diff >= 0`, the
    LR check against the right-view WTA of the same volume. CUDA tensors
    run the kernel, CPU tensors the plain version."""
    if S.dim() != 4 or S.numel() == 0:
        raise ValueError(f"S must be a non-empty (B, H, W, D) volume, got "
                         f"{tuple(S.shape)}")
    if S.dtype not in (torch.uint8, torch.int16):
        raise TypeError(f"S must be uint8 or int16, got {S.dtype}")
    if S.shape[-1] > MAX_D:
        raise ValueError(f"D = {S.shape[-1]} > {MAX_D} unsupported")
    if S.device.type == "cpu":
        return wta_lr_plain(S, cfg)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    if not S.is_contiguous():
        raise ValueError("S must be contiguous")
    B, H, W, D = S.shape
    lib = _build.load("wta_lr", _SIGS)
    if lib.wta_lr_smem_bytes(W) > _build.SMEM_MAX:
        raise ValueError(f"image width {W} exceeds the kernel's shared "
                         f"memory ({_build.SMEM_MAX} bytes, 9 per column)")
    disp = torch.empty((B, H, W), dtype=torch.float32, device=S.device)
    valid = torch.empty((B, H, W), dtype=torch.bool, device=S.device)
    rc = lib.wta_lr_launch(
        _build.ptr(S), _build.ptr(disp), _build.ptr(valid), B * H, W, D,
        int(S.dtype == torch.int16), cfg.uniqueness_ratio, int(cfg.subpixel),
        cfg.min_disparity, cfg.disp12_max_diff, _build.stream_ptr(S))
    _build.check(lib, rc, "wta_lr")
    wta_lr.launches += 1
    return disp, valid


wta_lr.launches = 0
