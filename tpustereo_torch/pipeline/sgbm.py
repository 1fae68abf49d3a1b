"""End-to-end stereo pipeline (the part of the JAX `pipeline/sgbm.py` the
port runs so far): a cost and selection stage per mode, then the LR check,
speckle and the 3x3 median.

Mirrors the JAX fused branches of `sgbm` and `sgbm_frames`, then
`_postproc_frames`:

* 'sgm': the census cost volume, the directional sweeps accumulated into
  one int16 S7, the backward sweep fused with WTA / uniqueness / subpixel /
  d_R, then `valid &= dr_consistency`;
* 'census_wta': the census cost volume, then WTA / uniqueness / subpixel /
  LR check over it in one kernel (`wta_lr`);
* 'sad': the SAD plane sweep fused with WTA / uniqueness / subpixel / d_R
  (`sad_wta`, no volume in memory), then `valid &= dr_consistency`;

then, for every mode, speckle over the stacked frames (`ops.speckle_frames`
with the CUDA labelling kernel), `where(valid, disp, -1.0)` and the median
over the stack. Frames are a batch dimension written out, so
`frames_per_step` changes nothing numerically. Everything runs on the
device of the input tensors: CUDA tensors through the kernels, CPU tensors
through their plain versions.

Out of this slice (each raises `NotImplementedError` naming its ROADMAP
item): gap fills, adaptive P2, and configurations outside the kernels'
limits (D > 512; for SGM, paths * (census_bits + P2) >= 4096).
"""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.kernels import (census_cost_volume,
                                     connected_component_labels,
                                     dr_consistency, median3, sad_wta,
                                     sgm_select, wta_lr)
from tpustereo_torch.ops.postproc import speckle_frames

INVALID = -1.0


def check_slice(cfg: Config) -> None:
    """Raise `NotImplementedError` for a configuration the port cannot run
    yet (ROADMAP.md, "Modules still to port"). Census windows over 64 bits
    need no check here: `Config` refuses them."""
    todo = []
    if cfg.fill_mode != "off":
        todo.append(f"fill_mode={cfg.fill_mode!r} (ROADMAP: gap fills)")
    if cfg.mode == "sgm" and cfg.adaptive_p2:
        todo.append("adaptive_p2 (ROADMAP: adaptive P2 maps)")
    if cfg.num_disparities > 512:
        todo.append("num_disparities > 512 (ROADMAP: wide configs)")
    if (cfg.mode == "sgm"
            and cfg.paths * (cfg.max_census_cost + cfg.p2) >= 4096):
        todo.append("paths * (census_bits + p2) >= 4096 (ROADMAP: wide "
                    "configs)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def _select(left: torch.Tensor, right: torch.Tensor, cfg: Config):
    """The mode's cost and selection stages, LR check included:
    (F, H, W) uint8 x2 -> (disp float32, valid bool)."""
    D, d0 = cfg.num_disparities, cfg.min_disparity
    if cfg.mode == "sad":
        disp, valid, d_r = sad_wta(left, right, cfg)
    else:
        C = census_cost_volume(left, right, D, cfg.max_census_cost,
                               cfg.census_window, d0)
        if cfg.mode == "census_wta":
            return wta_lr(C, cfg)
        disp, valid, d_r = sgm_select(C, cfg)
    if cfg.disp12_max_diff >= 0:
        valid &= dr_consistency(d_r, disp, D, cfg.disp12_max_diff, d0)
    return disp, valid


def sgbm_frames(left: torch.Tensor, right: torch.Tensor,
                cfg: Config) -> torch.Tensor:
    """(F, H, W) uint8 x2 -> (F, H, W) float32 disparity, invalid = -1."""
    check_slice(cfg)
    disp, valid = _select(left, right, cfg)
    valid = speckle_frames(disp, valid, cfg, cc=connected_component_labels)
    out = torch.where(valid, disp, INVALID)
    if cfg.median_filter:
        out = median3(out)
    return out


def sgbm(left: torch.Tensor, right: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Single pair: (H, W) uint8 x2 -> (H, W) float32."""
    return sgbm_frames(left[None], right[None], cfg)[0]


def sgbm_batched(left: torch.Tensor, right: torch.Tensor,
                 cfg: Config) -> torch.Tensor:
    """(B, H, W) uint8 x2 -> (B, H, W) float32, `cfg.frames_per_step`
    frames per set of kernel launches when that divides B, else one."""
    B = left.shape[0]
    F = cfg.frames_per_step if B % cfg.frames_per_step == 0 else 1
    return torch.cat([sgbm_frames(left[i:i + F], right[i:i + F], cfg)
                      for i in range(0, B, F)])
