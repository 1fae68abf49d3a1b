"""Carry state from the JAX package to the port.

The system has no learned weights: its state is the frozen `Config`, the
odometry's `OdometryConfig`, and the odometry checkpoints, which both
packages write and read in one `.npz` layout. `config_from_jax` takes
`dataclasses.asdict(jax_cfg)` (python values, the census window as a tuple
or list) and returns the port's `Config` with the same fields, so both
packages compute the same thing; `odometry_config_from_jax` does the same
for `OdometryConfig`. `sweep_carry_from_jax` takes one direction of the
JAX sweep kernel's ring carry to the port's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from tpustereo_torch.config import Config
from tpustereo_torch.odometry.backend import OdometryConfig


def _values(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"fields the port's {cls.__name__} lacks: "
                         f"{sorted(unknown)}")
    return {k: v.item() if hasattr(v, "item") else v for k, v in d.items()}


def config_from_jax(d: Dict[str, Any]) -> Config:
    return Config.from_dict(_values(Config, d))


def odometry_config_from_jax(d: Dict[str, Any]) -> OdometryConfig:
    return OdometryConfig(**_values(OdometryConfig, d))


def sweep_carry_from_jax(fin: np.ndarray, W: int, D: int) -> torch.Tensor:
    """One direction's slice (N_pad, D_pad) of the JAX `sgm_sweep`'s
    (K, N_pad, D_pad) q-form ring carry -> the port's (1, W, D) int32 carry
    of one frame, without the padded columns and disparity lanes."""
    fin = np.asarray(fin)
    if fin.ndim != 2 or fin.shape[0] < W or fin.shape[1] < D:
        raise ValueError(f"need an (N_pad >= {W}, D_pad >= {D}) slab, got "
                         f"{fin.shape}")
    return torch.from_numpy(np.ascontiguousarray(fin[:W, :D],
                                                 dtype=np.int32))[None]
