"""The port's `kernels.sgm` plain path (sweeps + backward sweep + WTA + d_R)
against the JAX `sgm_select_pallas` in interpret mode, on the CPU.

Interpret mode is slow (about 10 s a case at 21 x 45, D = 16), so these
cases have a file of their own. Tolerance: valid and d_r bit-exact; float
disparity within atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustereo.config import Config as JConfig
from tpustereo.kernels import sgm_select_pallas
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.kernels import sgm_select


@pytest.mark.parametrize("paths", [4, 8])
def test_sgm_select_plain_matches_pallas_interpret(rng, paths):
    H, W, D = 21, 45, 16
    C = rng.integers(0, 25, (H, W, D), dtype=np.uint8)
    img = rng.integers(0, 256, (H, W), dtype=np.uint8)
    jcfg = JConfig(num_disparities=D, paths=paths, p1=7, p2=90)
    ref = sgm_select_pallas(jnp.asarray(C), jcfg, jnp.asarray(img),
                            interpret=True)
    disp, valid, d_r = sgm_select(torch.from_numpy(C)[None],
                                  config_from_jax(dataclasses.asdict(jcfg)))
    np.testing.assert_allclose(disp[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(d_r[0].numpy(), np.asarray(ref[2]))
