"""Carry state from the JAX package to the port.

The system has no learned weights: its state is the frozen `Config`, the
odometry's `OdometryConfig`, and the odometry checkpoints, which both
packages write and read in one `.npz` layout. `config_from_jax` takes
`dataclasses.asdict(jax_cfg)` (python values, the census window as a tuple
or list) and returns the port's `Config` with the same fields, so both
packages compute the same thing; `odometry_config_from_jax` does the same
for `OdometryConfig`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

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
