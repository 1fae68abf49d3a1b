"""The disparity axis split over the mesh's strip axis, the JAX package's
`dist/disp_shard.py`: each slice of D builds and searches its own part of
the cost volume, and one minimum over the packed cost * shift + d resolves
the winner, ties to the smallest d as the single-device argmin. For the
WTA-on-raw-cost modes (census_wta, sad): SGM couples every d. Plain
PyTorch (the JAX function has no Pallas kernel); on the mesh's one device
the slices run in turn."""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config
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
    best = None
    for i in range(n):
        if cfg.mode == "sad":
            vol = full[..., i * Dl:(i + 1) * Dl]
        else:
            vol = cost_volume(cl, cr, Dl, cfg.max_census_cost,
                              cfg.min_disparity + i * Dl).to(torch.int32)
        jj = i * Dl + torch.arange(Dl, dtype=torch.int32, device=dev)
        local = (vol * shift + jj).amin(-1)
        best = local if best is None else torch.minimum(best, local)
    return ((best & (shift - 1)) + cfg.min_disparity).to(torch.float32)
