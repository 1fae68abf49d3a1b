"""Golden reference implementations (the parity oracle chain), the port's
own copies of the JAX package's `golden/`:

1. `sgbm_numpy` — loop/NumPy implementation of the exact recurrences;
   the pipeline must be bit-exact against it on the integer stages.
2. `opencv_ref` — cv2.StereoSGBM / cv2.StereoBM adapters; parity at the
   disparity-map / metric level (different cost function: BT vs census).
3. Synthetic pairs with analytic ground truth (`data.synthetic`).
"""

from tpustereo_torch.golden.sgbm_numpy import (  # noqa: F401
    INVALID,
    census_numpy,
    cost_volume_numpy,
    sad_volume_numpy,
    aggregate_numpy,
    aggregate_path_numpy,
    wta_numpy,
    lr_check_numpy,
    speckle_numpy,
    median3_numpy,
    sgbm_numpy,
)
