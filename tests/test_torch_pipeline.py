"""The port's pipeline (`tpustereo_torch.pipeline`) against the JAX
`pipeline` with `backend="jnp"`, on the CPU, at a small size: the KITTI SGM
preset without speckle and the median, and the full preset with both.

Tolerance: the pattern of -1.0 invalids bit-exact; disparity within
atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustereo.config import PRESETS as JPRESETS
from tpustereo.pipeline import sgbm as j_sgbm
from tpustereo.pipeline import sgbm_batched as j_sgbm_batched
from tpustereo_torch import api
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.pipeline import sgbm_batched


def _slice(**kw):
    """The slice config: kitti_sgm8 without speckle and median, at D=32."""
    return JPRESETS["kitti_sgm8"].replace(
        speckle_window_size=0, median_filter=False, num_disparities=32,
        frames_per_step=2, **kw)


def _full(**kw):
    """The full kitti_sgm8 preset (speckle window 100, range 2, the 3x3
    median), at D=32."""
    return JPRESETS["kitti_sgm8"].replace(num_disparities=32,
                                          frames_per_step=2, **kw)


def _batch(B=4, shape=(33, 49)):
    ps = [synthetic_pair(shape, disparity=4.0 + f, slope=0.03,
                         seed=200 + f)[:2] for f in range(B)]
    return np.stack([p[0] for p in ps]), np.stack([p[1] for p in ps])


def _same(got, ref):
    np.testing.assert_array_equal(got == -1.0, ref == -1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(min_disparity=3),
                                dict(paths=4),
                                dict(uniqueness_ratio=0, subpixel=False,
                                     disp12_max_diff=-1)],
                         ids=["slice", "min_disp3", "paths4", "bare"])
def test_sgbm_batched_matches_jax_jnp(kw):
    L, R = _batch()
    jcfg = _slice(backend="jnp", **kw)
    ref = np.asarray(j_sgbm_batched(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = sgbm_batched(torch.from_numpy(L), torch.from_numpy(R),
                       config_from_jax(dataclasses.asdict(jcfg)))
    assert (ref >= 0).mean() > 0.5      # the comparison sees real matches
    _same(got.numpy(), ref)


def test_frames_per_step_changes_nothing():
    L, R = _batch()
    cfg = config_from_jax(dataclasses.asdict(_slice()))
    a = sgbm_batched(torch.from_numpy(L), torch.from_numpy(R), cfg)
    b = sgbm_batched(torch.from_numpy(L), torch.from_numpy(R),
                     cfg.replace(frames_per_step=1))
    assert torch.equal(a, b)


def test_match_pair_cpu_matches_jax(small_pair):
    L, R, _, _ = small_pair
    jcfg = _slice(backend="jnp")
    ref = np.asarray(j_sgbm(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = api.match_pair(L, R, config_from_jax(dataclasses.asdict(jcfg)),
                         device="cpu")
    _same(got, ref)


@pytest.mark.slow
def test_sgbm_batched_matches_jax_pallas_interpret():
    L, R = _batch(B=2, shape=(24, 40))
    jcfg = _slice(backend="pallas")
    ref = np.asarray(j_sgbm_batched(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = api.match_batch(L, R, config_from_jax(dataclasses.asdict(jcfg)),
                          device="cpu")
    _same(got, ref)


@pytest.mark.parametrize("kw", [dict(), dict(speckle_window_size=20),
                                dict(paths=4, min_disparity=3)],
                         ids=["preset", "window20", "paths4_min_disp3"])
def test_full_preset_matches_jax_jnp(kw):
    L, R = _batch()
    jcfg = _full(backend="jnp", **kw)
    ref = np.asarray(j_sgbm_batched(jnp.asarray(L), jnp.asarray(R), jcfg))
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    L, R = torch.from_numpy(L), torch.from_numpy(R)
    got = sgbm_batched(L, R, cfg)
    assert (ref >= 0).mean() > 0.5
    _same(got.numpy(), ref)
    # both new stages change the output, so the comparison exercises them
    off = sgbm_batched(L, R, cfg.replace(speckle_window_size=0,
                                         median_filter=False))
    speckled = sgbm_batched(L, R, cfg.replace(median_filter=False))
    assert not torch.equal(speckled == -1.0, off == -1.0)
    assert not torch.equal(got, speckled)


def test_full_preset_frames_per_step_changes_nothing():
    L, R = (torch.from_numpy(a) for a in _batch())
    cfg = config_from_jax(dataclasses.asdict(_full()))
    a = sgbm_batched(L, R, cfg)
    for F in (1, 4):
        assert torch.equal(a, sgbm_batched(L, R,
                                           cfg.replace(frames_per_step=F)))


def test_match_pair_full_preset_matches_jax(small_pair):
    L, R, _, _ = small_pair
    jcfg = _full(backend="jnp")
    ref = np.asarray(j_sgbm(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = api.match_pair(L, R, config_from_jax(dataclasses.asdict(jcfg)),
                         device="cpu")
    _same(got, ref)


@pytest.mark.slow
def test_full_preset_matches_jax_pallas_interpret():
    L, R = _batch(B=2, shape=(24, 40))
    jcfg = _full(backend="pallas")
    ref = np.asarray(j_sgbm_batched(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = api.match_batch(L, R, config_from_jax(dataclasses.asdict(jcfg)),
                          device="cpu")
    _same(got, ref)
