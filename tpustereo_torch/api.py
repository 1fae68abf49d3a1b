"""Public API: `match_pair` and `match_batch`, numpy in and numpy out.

They run on the CUDA card unless the caller passes `device="cpu"`, and
raise when CUDA is absent: there is no quiet CPU fallback.
"""

from __future__ import annotations

from typing import Optional

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
