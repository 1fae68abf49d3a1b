"""Carry state from the JAX package to the port.

The system has no learned weights: its whole state is the frozen `Config`.
`config_from_jax` takes `dataclasses.asdict(jax_cfg)` (python values, the
census window as a tuple or list) and returns the port's `Config` with the
same fields, so both packages compute the same thing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from tpustereo_torch.config import Config


def config_from_jax(d: Dict[str, Any]) -> Config:
    names = {f.name for f in dataclasses.fields(Config)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"fields the port's Config lacks: {sorted(unknown)}")
    vals = {k: v.item() if hasattr(v, "item") else v for k, v in d.items()}
    return Config.from_dict(vals)
