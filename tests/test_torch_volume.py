"""The SGM volume route of the port on the CPU, and the relayout kernels.

The plain versions of `kernels.transpose_hw`, `transpose_sum_hw` and
`sgm_sweep_bidir` against the JAX Pallas transposes in interpret mode and
the JAX jnp path costs; `kernels.aggregate_volume` against the JAX
`aggregate_pallas` (interpret) and jnp `aggregate`; `pipeline.sgbm_volume`
and `select_and_refine` against the JAX `sgbm_volume` and `sgbm`; the
dispatch of SGM configurations past the fused bound; and the `BIDIR_VERT`
route of `sgm_select`. Inputs are made from a seed with numpy and handed to
both packages.

Tolerance: integer volumes and every valid mask bit-exact; float disparity
within atol 1e-6.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustereo import ops as jops
from tpustereo.config import PRESETS as JPRESETS
from tpustereo.config import Config as JConfig
from tpustereo.kernels import aggregate_pallas
from tpustereo.kernels.transpose_pallas import (transpose_hw_pallas,
                                                transpose_sum_hw_pallas)
from tpustereo.pipeline import sgbm as j_sgbm
from tpustereo.pipeline import sgbm_batched as j_sgbm_batched
from tpustereo.pipeline import sgbm_volume as j_sgbm_volume
from tpustereo_torch import api, kernels
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.pipeline import (select_and_refine, sgbm, sgbm_batched,
                                      sgbm_volume)

# the modules (the packages re-export functions of the same names)
ksgm = importlib.import_module("tpustereo_torch.kernels.sgm")
psgbm = importlib.import_module("tpustereo_torch.pipeline.sgbm")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


def _same(got, ref):
    np.testing.assert_array_equal(got == -1.0, ref == -1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _pair(shape=(33, 49), disparity=5.0, seed=300):
    return synthetic_pair(shape, disparity=disparity, slope=0.03,
                          seed=seed)[:2]


def _batch(B=4, shape=(33, 49), disparity=4.0):
    ps = [_pair(shape, disparity + f, 400 + f) for f in range(B)]
    return np.stack([p[0] for p in ps]), np.stack([p[1] for p in ps])


def _cost(rng, shape, top=25):
    return rng.integers(0, top, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# the relayout kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(24, 48, 128), (13, 150, 128)],
                         ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_transpose_hw_matches_pallas_interpret(rng, shape, dtype):
    x = rng.integers(0, 200 if dtype == np.uint8 else 30000, shape,
                     dtype=dtype)
    ref = transpose_hw_pallas(jnp.asarray(x), interpret=True)
    got = kernels.transpose_hw(_t(x)[None])
    assert got.dtype == _t(x).dtype and got.is_contiguous()
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(24, 48, 128), (13, 150, 128)],
                         ids=["aligned", "unaligned"])
def test_transpose_sum_hw_matches_pallas_interpret(rng, shape):
    # values near the int16 limits, so some sums wrap in both versions
    a = rng.integers(-32768, 32767, shape, dtype=np.int16)
    b = rng.integers(-32768, 32767, shape, dtype=np.int16)
    ref = transpose_sum_hw_pallas(jnp.asarray(a), jnp.asarray(b),
                                  interpret=True)
    got = kernels.transpose_sum_hw(_t(a)[None], _t(b)[None])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))


def test_transposes_keep_the_batch(rng):
    x = _t(rng.integers(0, 9, (3, 5, 7, 4), dtype=np.int16))
    y = _t(rng.integers(0, 9, (3, 5, 7, 4), dtype=np.int16))
    got = kernels.transpose_hw(x)
    got_sum = kernels.transpose_sum_hw(x, y)
    assert got.shape == got_sum.shape == (3, 7, 5, 4)
    for f in range(3):
        assert torch.equal(got[f], x[f].transpose(0, 1))
        assert torch.equal(got_sum[f], (x[f] + y[f]).transpose(0, 1))


@pytest.mark.parametrize("dxs", [(0, 1, -1), (0,), (-1,)],
                         ids=["8path", "4path", "one_diagonal"])
@pytest.mark.parametrize("shape", [(21, 45, 16), (7, 3, 24)],
                         ids=["W>H", "W<H"])
def test_sweep_bidir_plain_matches_jax_paths(rng, dxs, shape):
    H, W, D = shape
    C = _cost(rng, (2, H, W, D))
    jcfg = JConfig(num_disparities=D, p1=7, p2=90)
    Sd, Su = kernels.sgm_sweep_bidir(_t(C), dxs, jcfg.p1, jcfg.p2)
    assert Sd.dtype == Su.dtype == torch.int16
    img = jnp.zeros((H, W), jnp.uint8)    # read only by adaptive P2
    for f in range(2):
        Cj = jnp.asarray(C[f])
        ref_d = sum(np.asarray(jops.aggregate_path(Cj, 1, dx, jcfg, img),
                               np.int32) for dx in dxs)
        ref_u = sum(np.asarray(jops.aggregate_path(Cj, -1, dx, jcfg, img),
                               np.int32) for dx in dxs)
        np.testing.assert_array_equal(Sd[f].numpy(), ref_d)
        np.testing.assert_array_equal(Su[f].numpy(), ref_u)


def test_relayout_wrappers_refuse_bad_inputs():
    x = torch.zeros((1, 4, 5, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.transpose_hw(x)
    with pytest.raises(ValueError):
        kernels.transpose_hw(torch.zeros((4, 5, 8), dtype=torch.uint8))
    a = torch.zeros((1, 4, 5, 8), dtype=torch.int16)
    with pytest.raises(TypeError):
        kernels.transpose_sum_hw(a, a.to(torch.uint8))
    with pytest.raises(ValueError):
        kernels.transpose_sum_hw(a, a[:, :3])
    C = torch.zeros((1, 4, 5, 8), dtype=torch.uint8)
    for dxs in ((), (0, 0), (2,)):
        with pytest.raises(ValueError):
            kernels.sgm_sweep_bidir(C, dxs, 10, 120)
    with pytest.raises(ValueError):
        kernels.sgm_sweep_bidir(C.to(torch.int16), (0,), 10, 120)


# ---------------------------------------------------------------------------
# aggregate_volume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("geometry", ["fixture48x64", "unaligned_min_disp3"])
def test_aggregate_volume_matches_jax(small_pair, paths, geometry):
    L, R, _, _ = small_pair
    D, d0 = 16, 0
    if geometry == "unaligned_min_disp3":
        L, R = _pair((13, 37), 4.0, 301)
        d0 = 3
    jcfg = JConfig(num_disparities=D, min_disparity=d0, paths=paths, p1=7,
                   p2=90)
    cl = jops.census(jnp.asarray(L), jcfg.census_window)
    cr = jops.census(jnp.asarray(R), jcfg.census_window)
    C = jops.cost_volume(cl, cr, D, jcfg.max_census_cost, d_start=d0)
    ref_jnp = np.asarray(jops.aggregate(C, jcfg, jnp.asarray(L)))
    ref_pallas = np.asarray(aggregate_pallas(C, jcfg, jnp.asarray(L),
                                             interpret=True))
    got = kernels.aggregate_volume(_t(C)[None].to(torch.uint8), _cfg(jcfg))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got[0].numpy(), ref_jnp)
    np.testing.assert_array_equal(got[0].numpy(), ref_pallas)


# ---------------------------------------------------------------------------
# sgbm_volume and select_and_refine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("mode", ["sgm", "census_wta"])
def test_sgbm_volume_matches_jax(mode, backend):
    L, R = _pair((24, 40), 4.0, 302)
    jcfg = JConfig(mode=mode, num_disparities=16, paths=4, min_disparity=2,
                   backend=backend)
    ref = np.asarray(j_sgbm_volume(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = sgbm_volume(_t(L)[None], _t(R)[None], _cfg(jcfg))
    assert got.dtype == torch.int16 and str(ref.dtype) == "int16"
    np.testing.assert_array_equal(got[0].numpy(), ref)


def test_sgbm_volume_sad_matches_jax():
    L, R = _pair((24, 40), 4.0, 303)
    jcfg = JPRESETS["tsukuba_sad"].replace(num_disparities=16,
                                           backend="jnp")
    ref = np.asarray(j_sgbm_volume(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = sgbm_volume(_t(L)[None], _t(R)[None], _cfg(jcfg))
    np.testing.assert_array_equal(got[0].numpy(), ref)


@pytest.mark.parametrize("kw", [dict(), dict(paths=8, min_disparity=3),
                                dict(mode="census_wta"),
                                dict(mode="sad", sad_block=9),
                                dict(mode="sad", sad_block=13)],
                         ids=["sgm4", "sgm8_min_disp3", "census_wta",
                              "sad9", "sad13"])
def test_volume_route_matches_jax_sgbm(kw):
    """sgbm_volume + select_and_refine against the JAX sgbm on a small
    middlebury_sgm4 (the preset, at D = 32) and variations of it."""
    L, R = _pair((33, 49), 6.0, 304)
    jcfg = JPRESETS["middlebury_sgm4"].replace(num_disparities=32,
                                               backend="jnp", **kw)
    ref = np.asarray(j_sgbm(jnp.asarray(L), jnp.asarray(R), jcfg))
    cfg = _cfg(jcfg)
    S = sgbm_volume(_t(L)[None], _t(R)[None], cfg)
    got = select_and_refine(S, cfg)[0].numpy()
    assert (ref >= 0).mean() > 0.5      # the comparison sees real matches
    _same(got, ref)


@pytest.mark.parametrize("block", [13, 63])
def test_wta_lr_on_int32_sad_volume_matches_jax(block):
    """The int32 SAD volume of a block over 11, LR check on, through
    `kernels.wta_lr` against the JAX `ops.wta` + `ops.lr_check`, the JAX
    `_select_and_refine`'s route for it. Block 63 puts costs near 2^20."""
    L, R = _pair((24, 40), 4.0, 307)
    jcfg = JPRESETS["tsukuba_sad"].replace(num_disparities=16, sad_block=block,
                                           disp12_max_diff=1, backend="jnp")
    S = jops.sad_volume(jnp.asarray(L), jnp.asarray(R), 16, block)
    d_ref, _, v_ref = jops.wta(S, jcfg)
    v_ref = v_ref & jops.lr_check(S, d_ref, jcfg)
    disp, valid = kernels.wta_lr(_t(S)[None], _cfg(jcfg))
    assert int(np.asarray(S).max()) >= 255 * 121
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(v_ref))
    np.testing.assert_allclose(disp[0].numpy(), np.asarray(d_ref), rtol=0,
                               atol=1e-6)


def test_select_and_refine_refuses_sad_costs_past_2_20():
    cfg = _cfg(JPRESETS["tsukuba_sad"].replace(num_disparities=16,
                                               sad_block=65))
    S = torch.zeros((1, 8, 16, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^20"):
        select_and_refine(S, cfg)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_sgbm_batched_past_the_fused_bound_matches_jax(backend):
    """4 * (24 + 1000) >= 4096: both packages take the volume route."""
    L, R = _batch(B=2, shape=(24, 40))
    jcfg = JPRESETS["middlebury_sgm4"].replace(
        num_disparities=16, p2=1000, frames_per_step=2, backend=backend)
    ref = np.asarray(j_sgbm_batched(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = sgbm_batched(_t(L), _t(R), _cfg(jcfg))
    assert (ref >= 0).mean() > 0.3
    _same(got.numpy(), ref)


def test_p2_600_runs_the_volume_route(monkeypatch):
    """8 * (24 + 600) >= 4096 takes the volume route; 8 * (24 + 120) does
    not. Both equal the JAX sgbm."""
    calls = []

    def volume(*args):
        calls.append(args[-1])
        return sgbm_volume(*args)

    monkeypatch.setattr(psgbm, "sgbm_volume", volume)
    L, R = _pair((24, 40), 4.0, 305)
    for p2, route in ((600, 1), (120, 0)):
        jcfg = JPRESETS["kitti_sgm8"].replace(num_disparities=16, p2=p2,
                                              backend="jnp")
        ref = np.asarray(j_sgbm(jnp.asarray(L), jnp.asarray(R), jcfg))
        calls.clear()
        got = api.match_pair(L, R, _cfg(jcfg), device="cpu")
        assert len(calls) == route, p2
        _same(got, ref)


# ---------------------------------------------------------------------------
# the BIDIR_VERT route of sgm_select
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paths", [4, 8])
def test_bidir_vert_route_equals_default(rng, monkeypatch, paths):
    C = _t(_cost(rng, (2, 21, 45, 16)))
    cfg = _cfg(JConfig(num_disparities=16, paths=paths, p1=7, p2=90))
    ref = ksgm.sgm_select(C, cfg)
    monkeypatch.setattr(ksgm, "BIDIR_VERT", True)
    got = ksgm.sgm_select(C, cfg)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("kw", [dict(), dict(paths=4, min_disparity=3)],
                         ids=["kitti_sgm8", "paths4_min_disp3"])
def test_bidir_vert_pipeline_matches_jax(monkeypatch, kw):
    monkeypatch.setattr(ksgm, "BIDIR_VERT", True)
    L, R = _pair((33, 49), 5.0, 306)
    jcfg = JPRESETS["kitti_sgm8"].replace(num_disparities=32, backend="jnp",
                                          **kw)
    ref = np.asarray(j_sgbm(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = sgbm(_t(L), _t(R), _cfg(jcfg))
    assert (ref >= 0).mean() > 0.5
    _same(got.numpy(), ref)
