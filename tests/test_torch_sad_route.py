"""SAD configurations that the fused `sad_wta` kernel cannot take, on the
CPU: `kernels.sad.sad_wta_fits` at its two limits, and `sgbm_batched` past
them, which must take the volume route (`sgbm_volume` + `select_and_refine`)
as the JAX `sgbm` does past `_sad_fused_ok`. `sad_wta` is patched to raise
in the pipeline module, so a pass shows the volume route was taken; the
output is held against the JAX `sgbm_batched` with `backend="jnp"`.

Tolerance: the invalid pattern exact; float disparity within atol 1e-6.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustereo.config import PRESETS as JPRESETS
from tpustereo.pipeline import sgbm_batched as j_sgbm_batched
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.kernels.sad import sad_wta_fits
from tpustereo_torch.pipeline import sgbm_batched

psgbm = importlib.import_module("tpustereo_torch.pipeline.sgbm")


@pytest.mark.parametrize("W,block,fits", [
    (4096, 5, True), (4097, 5, False), (4096, 9, True), (5000, 9, False),
    (2964, 35, True), (2964, 36, False), (2964, 63, False), (1242, 64, True),
    (1, 1, True)])
def test_sad_wta_fits_at_its_limits(W, block, fits):
    assert sad_wta_fits(W, block) is fits


def _pairs(shape, n=2, disparity=6.0):
    ps = [synthetic_pair(shape, disparity=disparity + f, slope=0.02,
                         seed=700 + f)[:2] for f in range(n)]
    return np.stack([p[0] for p in ps]), np.stack([p[1] for p in ps])


def _refuse(*args, **kwargs):
    raise AssertionError("sad_wta was called past its limits")


# (H, W, D, block, disp12_max_diff): past the 4096-column row limit, and a
# block whose band row overflows shared memory at Middlebury full width
@pytest.mark.parametrize("H,W,D,block,d12", [(8, 5000, 16, 9, -1),
                                             (8, 5000, 16, 9, 1),
                                             (8, 2964, 32, 63, -1),
                                             (8, 2964, 32, 63, 1)])
def test_sad_past_the_fused_kernel_takes_the_volume_route(monkeypatch, H, W,
                                                          D, block, d12):
    assert not sad_wta_fits(W, block)
    L, R = _pairs((H, W))
    jcfg = JPRESETS["tsukuba_sad"].replace(
        num_disparities=D, sad_block=block, disp12_max_diff=d12,
        backend="jnp")
    ref = np.asarray(j_sgbm_batched(jnp.asarray(L), jnp.asarray(R), jcfg))
    monkeypatch.setattr(psgbm, "sad_wta", _refuse)
    got = sgbm_batched(torch.from_numpy(L), torch.from_numpy(R),
                       config_from_jax(dataclasses.asdict(jcfg))).numpy()
    assert (ref >= 0).mean() > 0.3      # the comparison sees real matches
    np.testing.assert_array_equal(got == -1.0, ref == -1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_sad_within_the_limits_keeps_the_fused_kernel(monkeypatch):
    L, R = _pairs((8, 300))
    cfg = psgbm.Config(mode="sad", num_disparities=16, sad_block=9)
    monkeypatch.setattr(psgbm, "sad_wta", _refuse)
    with pytest.raises(AssertionError, match="sad_wta"):
        sgbm_batched(torch.from_numpy(L), torch.from_numpy(R), cfg)
