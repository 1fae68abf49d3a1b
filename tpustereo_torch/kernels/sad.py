"""Fused SAD block matching + WTA: CUDA kernel wrapper and plain version.

Counterpart of the JAX package's `kernels/sad_pallas.py`
(`sad_wta_pallas`). The kernel is `csrc/sad_wta.cu`; it never writes the
(B, H, W, D) cost volume to device memory. Its plain version builds the
volume with `ops.sad.sad_volume`.
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.kernels import _build
from tpustereo_torch.ops.postproc import _right_disparity
from tpustereo_torch.ops.sad import sad_volume
from tpustereo_torch.ops.wta import wta

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "sad_wta_fits": ([_I, _I], _I),
    # left, right, disp, valid, d_r, B, H, W, D, block, d_start, uniq,
    # subpixel, with_dr, stream
    "sad_wta_launch": ([_P] * 5 + [_I] * 9 + [_P], _I),
}


def sad_wta_fits(W: int, block: int) -> bool:
    """Whether the wrapper takes images of width W at this block: the limit
    of the kernel's first design (one band row of 512 threads x 8 pixels,
    W <= 4096, and that row's two int32 sum rows plus the block's two uint8
    image rows within shared memory), kept so that configurations route as
    before; the tiled kernel itself takes any width. The same formula as
    the C export `sad_wta_fits`, so the pipeline picks its route alike on
    the CPU and on the card."""
    return W <= 4096 and (8 + 2 * block) * W <= _build.SMEM_MAX


def sad_wta_plain(left: torch.Tensor, right: torch.Tensor, cfg: Config):
    """The kernel's function in plain PyTorch: `sad_volume`, `ops.wta` and
    `_right_disparity` at d_start 0 (the shifted-column index map)."""
    S = sad_volume(left, right, cfg.num_disparities, cfg.sad_block,
                   cfg.min_disparity)
    disp, _, valid = wta(S, cfg)
    d_r = _right_disparity(S, 0) if cfg.disp12_max_diff >= 0 else None
    return disp, valid, d_r


def sad_wta(left: torch.Tensor, right: torch.Tensor, cfg: Config):
    """(B, H, W) uint8 x2 -> (disp float32, valid bool, d_r int32 or None),
    each (B, H, W).

    disp is in true units (`cfg.min_disparity` added, subpixel applied);
    valid is the uniqueness test; d_r[x] = argmin_k S(x + k, k) is the
    right-view index map in the shifted-column convention of the JAX
    `sad_wta_pallas`, for `kernels.lr.dr_consistency`, or None when
    `cfg.disp12_max_diff < 0`. Any block size whose costs stay below
    2^20 (255 * block^2, so block <= 64) is exact; the JAX kernel's
    block <= 11 gate is a TPU limit. CUDA tensors run the kernel, CPU
    tensors the plain version."""
    block = cfg.sad_block
    if left.shape != right.shape or left.dim() != 3 or left.numel() == 0:
        raise ValueError(f"need two equal non-empty (B, H, W) images, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    if left.dtype != torch.uint8 or right.dtype != torch.uint8:
        raise TypeError("images must be uint8")
    if left.device != right.device:
        raise ValueError("images must be on one device")
    if not 1 <= block or 255 * block * block >= 1 << 20:
        raise ValueError(f"sad_block {block} out of [1, 64]: the packed "
                         f"argmin needs every cost below 2^20")
    if left.device.type == "cpu":
        return sad_wta_plain(left, right, cfg)
    if left.device.type != "cuda":
        raise ValueError(f"unsupported device {left.device}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("images must be contiguous")
    B, H, W = left.shape
    lib = _build.load("sad_wta", _SIGS)
    if not lib.sad_wta_fits(W, block):
        raise ValueError(f"image width {W} at block {block} is past "
                         f"sad_wta_fits (W <= 4096 and (8 + 2 * block) * W "
                         f"<= {_build.SMEM_MAX}); such configurations take "
                         f"the volume route")
    dev = left.device
    with_dr = cfg.disp12_max_diff >= 0
    disp = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    valid = torch.empty((B, H, W), dtype=torch.bool, device=dev)
    d_r = (torch.empty((B, H, W), dtype=torch.int32, device=dev)
           if with_dr else None)
    rc = lib.sad_wta_launch(
        _build.ptr(left), _build.ptr(right), _build.ptr(disp),
        _build.ptr(valid), _build.ptr(d_r) if with_dr else None, B, H, W,
        cfg.num_disparities, block, cfg.min_disparity, cfg.uniqueness_ratio,
        int(cfg.subpixel), int(with_dr), _build.stream_ptr(left))
    _build.check(lib, rc, "sad_wta")
    sad_wta.launches += 1
    return disp, valid, d_r


sad_wta.launches = 0
