"""Batch data parallelism: the frame pairs split over the mesh's data axis,
each shard through the single-device pipeline, as the JAX package's
`dist/batching.py` shards them over its chips. On the mesh's one device
(`dist.mesh`) the whole batch is one shard."""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.dist.mesh import Mesh
from tpustereo_torch.pipeline import sgbm_batched


def sgbm_data_parallel(left: torch.Tensor, right: torch.Tensor, cfg: Config,
                       mesh: Mesh) -> torch.Tensor:
    """(B, H, W) uint8 x2 -> (B, H, W) float32, the batch over the data
    axis. B must divide by the data axis's size."""
    n = mesh.shape["data"]
    if left.shape[0] % n:
        raise ValueError(f"batch {left.shape[0]} does not divide by the data "
                         f"axis {n}")
    dev = mesh.device
    return sgbm_batched(left.to(dev), right.to(dev), cfg)
