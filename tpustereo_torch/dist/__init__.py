"""Strip tiling, batch data parallelism and the disparity axis split, over a
mesh of devices in one process or of ranks, one process a device: the
counterpart of the JAX package's `dist/`."""

from tpustereo_torch.dist.mesh import init_distributed, make_mesh  # noqa: F401
from tpustereo_torch.dist.tiling import (  # noqa: F401
    halo_exchange, sgbm_strip, sgbm_tiled, sgbm_tiled_batched, strip_rows)
from tpustereo_torch.dist.batching import sgbm_data_parallel  # noqa: F401
from tpustereo_torch.dist.disp_shard import wta_disparity_sharded  # noqa: F401
