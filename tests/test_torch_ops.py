"""Parity of the port's plain PyTorch ops (`tpustereo_torch.ops`) with the
JAX package's jnp ops, on the CPU.

Same inputs, made from a seed with numpy, go through both. Tolerance:
integer outputs (census, C, L/S, d_int, d_R, every valid mask) bit-exact;
float disparity within atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustereo import ops as jops
from tpustereo.config import Config as JConfig
from tpustereo.ops.postproc import _right_disparity as j_right_disparity
from tpustereo.ops.postproc import dr_consistency as j_dr_consistency
from tpustereo_torch import ops
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.ops.postproc import _right_disparity, dr_consistency

D = 32


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def volume(small_pair):
    L, R, _, _ = small_pair
    C = jops.cost_volume(jops.census(jnp.asarray(L)),
                         jops.census(jnp.asarray(R)), D, 24)
    return L, C, _t(C)


@pytest.fixture(scope="module")
def agg(volume):
    L, C, Ct = volume
    S = jops.aggregate(C, JConfig(num_disparities=D), jnp.asarray(L))
    return S, _t(S)


@pytest.mark.parametrize("window", [(5, 5), (7, 9), (5, 13)])
def test_census_matches_jax(small_pair, window):
    L = small_pair[0]
    planes = np.asarray(jops.census(jnp.asarray(L), window)).astype(np.uint64)
    word = planes[..., 0]
    if planes.shape[-1] > 1:
        word = word | (planes[..., 1] << np.uint64(32))
    got = ops.census(_t(L), window).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, word)


@pytest.mark.parametrize("d_start", [0, 3])
@pytest.mark.parametrize("window", [(5, 5), (5, 13)])
def test_cost_volume_matches_jax(small_pair, d_start, window):
    L, R, _, _ = small_pair
    bits = window[0] * window[1] - 1
    ref = jops.cost_volume(jops.census(jnp.asarray(L), window),
                           jops.census(jnp.asarray(R), window), D, bits,
                           d_start=d_start)
    got = ops.cost_volume(ops.census(_t(L), window),
                          ops.census(_t(R), window), D, bits, d_start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("direction", [(0, 1), (0, -1), (1, 0), (-1, 0),
                                       (1, 1), (1, -1), (-1, 1), (-1, -1)])
def test_aggregate_path_matches_jax(volume, direction):
    L, C, Ct = volume
    jcfg = JConfig(num_disparities=D, p1=7, p2=90)
    ref = jops.aggregate_path(C, *direction, jcfg, jnp.asarray(L))
    got = ops.aggregate_path(Ct, *direction,
                             config_from_jax(dataclasses.asdict(jcfg)))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("paths", [4, 8])
def test_aggregate_matches_jax(volume, paths):
    L, C, Ct = volume
    jcfg = JConfig(num_disparities=D, paths=paths)
    ref = jops.aggregate(C, jcfg, jnp.asarray(L))
    got = ops.aggregate(Ct, config_from_jax(dataclasses.asdict(jcfg)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("uniq", [0, 10])
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("d_start", [0, 5])
def test_wta_matches_jax(agg, uniq, subpixel, d_start):
    S, St = agg
    jcfg = JConfig(num_disparities=D, uniqueness_ratio=uniq,
                   subpixel=subpixel, min_disparity=d_start)
    ref = jops.wta(S, jcfg)
    got = ops.wta(St, config_from_jax(dataclasses.asdict(jcfg)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("d_start", [0, 4])
def test_right_disparity_matches_jax(agg, d_start):
    S, St = agg
    np.testing.assert_array_equal(_right_disparity(St, d_start).numpy(),
                                  np.asarray(j_right_disparity(S, d_start)))


@pytest.mark.parametrize("shape", [(40, 72, 32), (6, 20, 32)],
                         ids=["W>D", "W<D"])
@pytest.mark.parametrize("d_start", [0, 3])
def test_dr_consistency_matches_jax(rng, shape, d_start):
    H, W, nd = shape
    d_r = rng.integers(0, nd + d_start, (H, W), dtype=np.int32)
    disp = rng.uniform(d_start - 0.5, d_start + nd - 0.5,
                       (H, W)).astype(np.float32)
    for max_diff in (0, 1, 2):
        ref = j_dr_consistency(jnp.asarray(d_r), jnp.asarray(disp), nd,
                               max_diff, d_start)
        got = dr_consistency(_t(d_r), _t(disp), nd, max_diff, d_start)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=f"max_diff={max_diff}")


@pytest.mark.parametrize("max_diff", [-1, 1])
def test_lr_check_matches_jax(agg, max_diff):
    S, St = agg
    jcfg = JConfig(num_disparities=D, disp12_max_diff=max_diff)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    disp = jops.wta(S, jcfg)[0]
    ref = jops.lr_check(S, disp, jcfg)
    got = ops.lr_check(St, _t(disp), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
