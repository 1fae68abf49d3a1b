"""SGM sweeps and the fused backward sweep + WTA: CUDA kernel wrappers and
plain versions.

Counterparts of the JAX package's `kernels/sgm_pallas.py`: `sgm_sweep`
(`csrc/sgm_sweep.cu`), `sweep_bwd_wta` (`csrc/bwd_wta.cu`) and
`sgm_select`, the Python composition that `sgm_select_pallas` is. The
kernels take the plain (B, H, W, D) layout for every direction; nothing is
padded or transposed.
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.kernels import _build
from tpustereo_torch.ops.postproc import _right_disparity
from tpustereo_torch.ops.sgm import DIRS_4, DIRS_8, path_costs
from tpustereo_torch.ops.wta import wta

_P, _I = ctypes.c_void_p, ctypes.c_int
_SWEEP_SIGS = {
    # C, S, B, H, W, D, dy, dx, p1, p2, stream
    "sgm_sweep_launch": ([_P, _P] + [_I] * 8 + [_P], _I),
}
_BWD_SIGS = {
    # C, S7, disp, valid, d_r, rows, W, D, p1, p2, uniq, subpixel,
    # d_start, stream
    "bwd_wta_launch": ([_P] * 5 + [_I] * 8 + [_P], _I),
}
MAX_D = 512  # 32 lanes x 16 registers of carry per warp


def _check_volume(C: torch.Tensor, S: torch.Tensor, name: str) -> None:
    if C.dim() != 4 or C.numel() == 0 or C.dtype != torch.uint8:
        raise ValueError(f"C must be a non-empty (B, H, W, D) uint8 volume, "
                         f"got {C.dtype} {tuple(C.shape)}")
    if S.shape != C.shape or S.dtype != torch.int16:
        raise ValueError(f"{name} must be int16 of C's shape "
                         f"{tuple(C.shape)}, got {S.dtype} {tuple(S.shape)}")
    if S.device != C.device:
        raise ValueError(f"C and {name} must be on one device")
    if C.shape[-1] > MAX_D:
        raise ValueError(f"D = {C.shape[-1]} > {MAX_D} unsupported")
    if C.device.type == "cuda" and not (C.is_contiguous()
                                        and S.is_contiguous()):
        raise ValueError(f"C and {name} must be contiguous")
    if C.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {C.device}")


# ---------------------------------------------------------------------------
# one directional sweep
# ---------------------------------------------------------------------------

def sgm_sweep_plain(C: torch.Tensor, S: torch.Tensor, dy: int, dx: int,
                    p1: int, p2: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (`ops.sgm`)."""
    S += path_costs(C, dy, dx, p1, p2)
    return S


def sgm_sweep(C: torch.Tensor, S: torch.Tensor, dy: int, dx: int, p1: int,
              p2: int) -> torch.Tensor:
    """S += L_r for direction r = (dy, dx), in place; returns S.

    C (B, H, W, D) uint8, S int16 of the same shape. In place because S is
    the pipeline's one accumulator of the seven sweeps (it saves a volume).
    CUDA tensors run the kernel, CPU tensors the plain version."""
    _check_volume(C, S, "S")
    if (dy, dx) not in DIRS_8:
        raise ValueError(f"direction {(dy, dx)} is not one of {DIRS_8}")
    if not 0 <= p1 <= p2:
        raise ValueError("need 0 <= p1 <= p2")
    if C.device.type == "cpu":
        return sgm_sweep_plain(C, S, dy, dx, p1, p2)
    B, H, W, D = C.shape
    lib = _build.load("sgm_sweep", _SWEEP_SIGS)
    rc = lib.sgm_sweep_launch(_build.ptr(C), _build.ptr(S), B, H, W, D, dy,
                              dx, p1, p2, _build.stream_ptr(C))
    _build.check(lib, rc, "sgm_sweep")
    sgm_sweep.launches += 1
    return S


sgm_sweep.launches = 0


# ---------------------------------------------------------------------------
# backward (W) sweep fused with WTA + uniqueness + subpixel + d_R
# ---------------------------------------------------------------------------

def sweep_bwd_wta_plain(C: torch.Tensor, S7: torch.Tensor, cfg: Config):
    """The kernel's function in plain PyTorch (`ops.sgm`, `ops.wta`,
    `ops.postproc._right_disparity` at d_start 0, which is the shifted-column
    index map)."""
    S = S7.to(torch.int32) + path_costs(C, 0, -1, cfg.p1, cfg.p2)
    disp, _, valid = wta(S, cfg)
    return disp, valid, _right_disparity(S, 0)


def sweep_bwd_wta(C: torch.Tensor, S7: torch.Tensor, cfg: Config):
    """Complete S = S7 + L_W and select: -> (disp float32, valid bool,
    d_r int32), each (B, H, W).

    disp is in true units (`cfg.min_disparity` added); valid is the
    uniqueness test; d_r[x] = argmin_k S(x + k, k) is the right-view index
    map in the shifted-column convention of the JAX `sweep_bwd_wta`, for
    `kernels.lr.dr_consistency`. CUDA tensors run the kernel, CPU tensors
    the plain version."""
    _check_volume(C, S7, "S7")
    if C.device.type == "cpu":
        return sweep_bwd_wta_plain(C, S7, cfg)
    B, H, W, D = C.shape
    dev = C.device
    disp = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    valid = torch.empty((B, H, W), dtype=torch.bool, device=dev)
    d_r = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    lib = _build.load("bwd_wta", _BWD_SIGS)
    rc = lib.bwd_wta_launch(
        _build.ptr(C), _build.ptr(S7), _build.ptr(disp), _build.ptr(valid),
        _build.ptr(d_r), B * H, W, D, cfg.p1, cfg.p2, cfg.uniqueness_ratio,
        int(cfg.subpixel), cfg.min_disparity, _build.stream_ptr(C))
    _build.check(lib, rc, "sweep_bwd_wta")
    sweep_bwd_wta.launches += 1
    return disp, valid, d_r


sweep_bwd_wta.launches = 0


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

def sgm_select(C: torch.Tensor, cfg: Config):
    """Aggregation + WTA + uniqueness + subpixel + right-view disparity.

    The sweeps of every direction but W accumulate into one int16 S7; the
    backward sweep completes S column by column and selects, so the full S
    is never stored. C (B, H, W, D) uint8 -> (disp, valid, d_r) as in
    `sweep_bwd_wta`."""
    S7 = torch.zeros(C.shape, dtype=torch.int16, device=C.device)
    for dy, dx in (DIRS_4 if cfg.paths == 4 else DIRS_8):
        if (dy, dx) != (0, -1):
            sgm_sweep(C, S7, dy, dx, cfg.p1, cfg.p2)
    return sweep_bwd_wta(C, S7, cfg)
