"""Public API: `match_pair`, `match_batch`, `match_pair_tiled` and
`run_sequence`, numpy in and numpy out.

They run on the CUDA card unless the caller passes `device="cpu"`, and
raise when CUDA is absent: there is no quiet CPU fallback.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from tpustereo_torch.config import Config
from tpustereo_torch.pipeline import sgbm, sgbm_batched


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


def _as_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3:  # RGB -> gray (ITU-R 601 integer approximation)
        img = (img @ np.array([0.299, 0.587, 0.114])).astype(np.uint8)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return img


def match_pair(left: np.ndarray, right: np.ndarray,
               cfg: Optional[Config] = None, device="cuda") -> np.ndarray:
    """Disparity for one rectified pair. (H, W) uint8 -> (H, W) float32,
    invalid = -1.0."""
    cfg = cfg or Config()
    dev = _device(device)
    l8 = torch.from_numpy(np.ascontiguousarray(_as_u8(left)))
    r8 = torch.from_numpy(np.ascontiguousarray(_as_u8(right)))
    out = sgbm(l8.to(dev), r8.to(dev), cfg)
    return out.cpu().numpy()


def match_batch(lefts: np.ndarray, rights: np.ndarray,
                cfg: Optional[Config] = None, device="cuda") -> np.ndarray:
    """Disparity for a batch of pairs. (B, H, W) -> (B, H, W) float32."""
    cfg = cfg or Config()
    dev = _device(device)
    l8 = torch.from_numpy(np.ascontiguousarray(lefts, dtype=np.uint8))
    r8 = torch.from_numpy(np.ascontiguousarray(rights, dtype=np.uint8))
    return sgbm_batched(l8.to(dev), r8.to(dev), cfg).cpu().numpy()


def match_pair_tiled(left: np.ndarray, right: np.ndarray,
                     cfg: Optional[Config] = None, mesh=None,
                     device="cuda") -> np.ndarray:
    """Disparity for one rectified pair, its rows in strips over the mesh's
    strip axis (`dist.sgbm_tiled`; halo or exact mode by
    `cfg.exact_tiling`). (H, W) uint8 -> (H, W) float32, invalid = -1.0.
    Without a mesh, `cfg.strips` strips on `device`; with one, on the
    mesh's device."""
    from tpustereo_torch import dist   # dist.mesh imports api
    cfg = cfg or Config()
    if mesh is None:
        mesh = dist.make_mesh(1, cfg.strips, device=device)
    l8 = torch.from_numpy(np.ascontiguousarray(_as_u8(left)))
    r8 = torch.from_numpy(np.ascontiguousarray(_as_u8(right)))
    return dist.sgbm_tiled(l8, r8, cfg, mesh).cpu().numpy()


def run_sequence(pairs: Iterable, calib, cfg: Optional[Config] = None,
                 odometry_cfg=None, device="cuda", mesh=None) -> np.ndarray:
    """Stereo odometry over an iterable of (left, right) frames
    (SURVEY.md §4.4). Returns the trajectory as (N, 4, 4) world <- camera
    poses. With `cfg.strips > 1` the matcher is the strip-tiled one over
    `mesh` (by default `cfg.strips` strips on `device`)."""
    from tpustereo_torch.odometry import StereoOdometry  # it imports api
    odo = StereoOdometry(calib, cfg or Config(), odometry_cfg, device=device,
                         mesh=mesh)
    for left, right in pairs:
        odo.step(np.asarray(left), np.asarray(right))
    return odo.trajectory()
