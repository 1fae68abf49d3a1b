"""Batch data parallelism: the frame pairs split over the mesh's data
axis, each shard through the single-device pipeline, as the JAX package's
`dist/batching.py` shards them over its chips, with no collective during
compute. On a one-process mesh (`dist.mesh`) the whole batch is one
shard; across ranks each rank runs its own shard and the shards are
gathered over the data axis once they are done."""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.dist import comm
from tpustereo_torch.dist.mesh import Mesh
from tpustereo_torch.pipeline import sgbm_batched


def sgbm_data_parallel(left: torch.Tensor, right: torch.Tensor, cfg: Config,
                       mesh: Mesh) -> torch.Tensor:
    """(B, H, W) uint8 x2 -> (B, H, W) float32, the batch over the data
    axis. B must divide by the data axis's size. Across ranks every rank
    passes the whole batch and gets the whole output; the ranks of one
    data shard (its strips) compute it alike, as the JAX mesh replicates
    it over its strip axis."""
    n = mesh.shape["data"]
    if left.shape[0] % n:
        raise ValueError(f"batch {left.shape[0]} does not divide by the data "
                         f"axis {n}")
    dev = mesh.device
    if mesh.ranks is None:
        return sgbm_batched(left.to(dev), right.to(dev), cfg)
    F = left.shape[0] // n
    shard = slice(mesh.ranks.data * F, (mesh.ranks.data + 1) * F)
    out = sgbm_batched(left[shard].to(dev), right[shard].to(dev), cfg)
    return comm.all_gather_frames(out, mesh.ranks.data_group)
