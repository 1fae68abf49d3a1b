"""The disparity axis split over the mesh's strip axis, the JAX package's
`dist/disp_shard.py`: each slice of D builds and searches its own part of
the cost volume, and one minimum over the packed cost * shift + d resolves
the winner, ties to the smallest d as the single-device argmin. For the
WTA-on-raw-cost modes (census_wta, sad): SGM couples every d. Plain
PyTorch (the JAX function has no Pallas kernel). On a one-process mesh the
slices run in turn; across ranks each rank of the strip axis runs its own
slice and `comm.all_reduce_min` combines them, as the JAX `pmin` does."""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.dist import comm
from tpustereo_torch.dist.mesh import Mesh
from tpustereo_torch.ops import census, cost_volume, sad_volume
from tpustereo_torch.ops.wta import next_pow2


def wta_disparity_sharded(left: torch.Tensor, right: torch.Tensor,
                          cfg: Config, mesh: Mesh) -> torch.Tensor:
    """(H, W) uint8 x2 -> (H, W) float32 integer disparity, the disparity
    axis in slices over the strip axis. Raw WTA: no uniqueness, subpixel or
    post-processing."""
    if cfg.mode not in ("sad", "census_wta"):
        raise ValueError(f"mode {cfg.mode!r}: SGM couples the disparities; "
                         f"strip-tile it instead")
    n, D = mesh.shape["strip"], cfg.num_disparities
    if D % n:
        raise ValueError(f"num_disparities {D} does not divide by the strip "
                         f"axis {n}")
    dev = mesh.device
    left, right = left.to(dev), right.to(dev)
    Dl = D // n
    shift = next_pow2(max(D, 2))
    if cfg.mode == "sad":
        full = sad_volume(left, right, D, cfg.sad_block, cfg.min_disparity)
    else:
        cl = census(left, cfg.census_window)
        cr = census(right, cfg.census_window)

    def packed_min(i: int) -> torch.Tensor:
        """The minimum of cost * shift + d over slice i of D."""
        if cfg.mode == "sad":
            vol = full[..., i * Dl:(i + 1) * Dl]
        else:
            vol = cost_volume(cl, cr, Dl, cfg.max_census_cost,
                              cfg.min_disparity + i * Dl).to(torch.int32)
        jj = i * Dl + torch.arange(Dl, dtype=torch.int32, device=dev)
        return (vol * shift + jj).amin(-1)

    if mesh.ranks is not None:
        best = comm.all_reduce_min(packed_min(mesh.ranks.strip),
                                   mesh.ranks.strip_group)
    else:
        best = packed_min(0)
        for i in range(1, n):
            best = torch.minimum(best, packed_min(i))
    return ((best & (shift - 1)) + cfg.min_disparity).to(torch.float32)
