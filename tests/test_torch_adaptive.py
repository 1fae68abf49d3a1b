"""Adaptive P2 in the port on the CPU: the port's `p2_map` against the JAX
`ops.sgm.p2_map` (and its quotient exhaustively against numpy), the plain
path costs against the JAX `aggregate_path` / `aggregate`, the sweep
wrappers' plain versions with the left image against the JAX Pallas
`sgm_sweep` / `sweep_bwd_wta` with `p2_maps` in interpret mode, and
`sgbm_batched` / `sgbm_volume` + `select_and_refine` with
`adaptive_p2=True` against the JAX pipeline with `backend="jnp"`, on both
SGM routes.

The JAX adaptive Pallas pipeline tests are slow, so the interpret-mode
comparisons stay at a few rows and D <= 40, and the pipelines go against
jnp. Inputs are made from a seed with numpy and handed to both packages.

Tolerance: integer outputs bit-exact; float disparity within atol 1e-6.
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
from tpustereo.kernels.sgm_pallas import _p2_stack
from tpustereo.kernels.sgm_pallas import sgm_sweep as j_sgm_sweep
from tpustereo.kernels.sgm_pallas import sweep_bwd_wta as j_sweep_bwd_wta
from tpustereo.pipeline import sgbm as j_sgbm
from tpustereo.pipeline import sgbm_batched as j_sgbm_batched
from tpustereo_torch import kernels
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.ops import sgm as tsgm
from tpustereo_torch.pipeline import (select_and_refine, sgbm_batched,
                                      sgbm_volume)
from tpustereo_torch.pipeline.sgbm import S16_BOUND, check_slice

ksgm = importlib.import_module("tpustereo_torch.kernels.sgm")

P1, P2 = 7, 90


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


def _same(got, ref):
    np.testing.assert_array_equal(got == -1.0, ref == -1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _batch(B=4, shape=(33, 49), disparity=4.0, seed=500):
    ps = [synthetic_pair(shape, disparity=disparity + f, slope=0.03,
                         seed=seed + f)[:2] for f in range(B)]
    return np.stack([p[0] for p in ps]), np.stack([p[1] for p in ps])


# ---------------------------------------------------------------------------
# p2_map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", tsgm.DIRS_8)
@pytest.mark.parametrize("shape,p1,p2,d0", [
    ((6, 11), 7, 90, 0), ((1, 9), 7, 90, 0), ((8, 1), 7, 90, 0),
    ((5, 7), 40, 40, 3)], ids=["6x11", "H1", "W1", "p1_eq_p2_min_disp3"])
def test_p2_map_matches_jax(rng, direction, shape, p1, p2, d0):
    """Per frame of a stack of 3 (gradients never read across frames);
    P1 = P2 makes every map at least P1 + 1 > P2."""
    imgs = rng.integers(0, 256, (3, *shape), dtype=np.uint8)
    jcfg = JConfig(num_disparities=16, min_disparity=d0, p1=p1, p2=p2,
                   adaptive_p2=True)
    got = tsgm.p2_map(_t(imgs), *direction, _cfg(jcfg))
    assert got.dtype == torch.int32 and got.shape == imgs.shape
    for f in range(3):
        ref = np.asarray(jops.sgm.p2_map(jnp.asarray(imgs[f]), *direction,
                                         jcfg))
        np.testing.assert_array_equal(got[f].numpy(), ref)
    if p1 == p2:
        assert int(got.min()) == p1 + 1


def test_p2_map_scalar_without_adaptive(rng):
    img = _t(rng.integers(0, 256, (2, 4, 5), dtype=np.uint8))
    got = tsgm.p2_map(img, 1, -1, _cfg(JConfig(p2=77)))
    assert torch.equal(got, torch.full(img.shape, 77, dtype=torch.int32))


def test_p2_quotient_exhaustive():
    """max(P1 + 1, P2 // max(1, g)) for every P2 <= 4095 and g <= 255
    against numpy, the domain the JAX package checks its float quotient
    over: row 1 of the image is g above row 0 at column g."""
    img = torch.zeros((2, 256), dtype=torch.uint8)
    img[1] = torch.arange(256, dtype=torch.uint8)
    g = np.arange(256)
    for p2 in range(4096):
        got = tsgm.adaptive_p2_map(img, 1, 0, 0, p2)[1].numpy()
        np.testing.assert_array_equal(got, np.maximum(1, p2 // np.maximum(
            1, g)), err_msg=f"P2 = {p2}")


# ---------------------------------------------------------------------------
# the plain path costs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", tsgm.DIRS_8)
def test_aggregate_path_matches_jax(rng, direction):
    C = rng.integers(0, 25, (2, 7, 10, 16), dtype=np.uint8)
    imgs = rng.integers(0, 256, (2, 7, 10), dtype=np.uint8)
    jcfg = JConfig(num_disparities=16, p1=P1, p2=P2, adaptive_p2=True)
    got = tsgm.aggregate_path(_t(C), *direction, _cfg(jcfg), _t(imgs))
    for f in range(2):
        ref = jops.aggregate_path(jnp.asarray(C[f]), *direction, jcfg,
                                  jnp.asarray(imgs[f]))
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(ref))


@pytest.mark.parametrize("paths", [4, 8])
def test_aggregate_matches_jax(small_pair, paths):
    L, R, _, _ = small_pair
    jcfg = JConfig(num_disparities=16, paths=paths, min_disparity=2, p1=P1,
                   p2=P2, adaptive_p2=True)
    cl = jops.census(jnp.asarray(L), jcfg.census_window)
    cr = jops.census(jnp.asarray(R), jcfg.census_window)
    C = jops.cost_volume(cl, cr, 16, jcfg.max_census_cost, d_start=2)
    ref = np.asarray(jops.aggregate(C, jcfg, jnp.asarray(L)))
    got = tsgm.aggregate(_t(C)[None], _cfg(jcfg), _t(L)[None])
    np.testing.assert_array_equal(got[0].numpy(), ref)
    # the adaptive map changes the sums here
    scalar = tsgm.aggregate(_t(C)[None], _cfg(jcfg.replace(
        adaptive_p2=False)))
    assert not torch.equal(got, scalar)


def test_aggregate_needs_the_image_under_adaptive(rng):
    C = _t(rng.integers(0, 25, (1, 4, 5, 8), dtype=np.uint8))
    with pytest.raises(ValueError, match="left image"):
        tsgm.aggregate(C, _cfg(JConfig(num_disparities=8, adaptive_p2=True)))
    with pytest.raises(ValueError, match="img"):
        tsgm.path_costs(C, 1, 0, P1, P2, torch.zeros((1, 4, 6),
                                                     dtype=torch.uint8))


# ---------------------------------------------------------------------------
# the sweep wrappers' plain versions against the JAX Pallas kernels
# ---------------------------------------------------------------------------

def _jax_sweep(C, S0, img, dy, dx, p1, p2):
    """L_r (S0 None) or S0 + L_r of one (H, W, D) frame by the JAX sweep
    with its adaptive maps (`_p2_stack`), in interpret mode."""
    horizontal = dy == 0
    frame = C.transpose(1, 0, 2) if horizontal else C   # (T, N, D)
    T, N, D = frame.shape
    Np, Dp = _round_up(N, 8), _round_up(D, 128)
    pad = ((0, 0), (0, Np - N), (0, Dp - D))
    S_in = None
    if S0 is not None:
        s = S0.transpose(1, 0, 2) if horizontal else S0
        S_in = jnp.asarray(np.pad(s, pad))
    maps = _p2_stack(jnp.asarray(img), [(dy, dx)],
                     JConfig(p1=p1, p2=p2, adaptive_p2=True), horizontal, T,
                     Np)
    reverse = (dx if horizontal else dy) < 0
    S = j_sgm_sweep(jnp.asarray(np.pad(frame, pad)), S_in,
                    (0 if horizontal else dx,), reverse, p1, p2, N, D,
                    p2_maps=maps, interpret=True)
    S = np.asarray(S)[:, :N, :D]
    return S.transpose(1, 0, 2) if horizontal else S


@pytest.mark.parametrize("form", ["write", "add"])
@pytest.mark.parametrize("direction", tsgm.DIRS_8)
def test_sweep_matches_pallas_interpret(rng, direction, form):
    B, H, W, D = 2, 6, 11, 40
    C = rng.integers(0, 25, (B, H, W, D), dtype=np.uint8)
    imgs = rng.integers(0, 256, (B, H, W), dtype=np.uint8)
    S0 = (rng.integers(-500, 500, C.shape, dtype=np.int16)
          if form == "add" else None)
    S = None if S0 is None else _t(S0)
    got = kernels.sgm_sweep(_t(C), S, *direction, P1, P2, _t(imgs))
    assert got.dtype == torch.int16 and got.shape == C.shape
    for f in range(B):
        ref = _jax_sweep(C[f], None if S0 is None else S0[f], imgs[f],
                         *direction, P1, P2)
        np.testing.assert_array_equal(got[f].numpy(), ref)


@pytest.mark.parametrize("W,d0", [(11, 0), (13, 2)])
def test_sweep_bwd_wta_matches_pallas_interpret(rng, W, d0):
    """The W sweep with the adaptive map of direction (0, -1), on S7 the
    sum of the other seven adaptive path costs; disp within 1e-6."""
    H, D = 6, 24
    C = rng.integers(0, 25, (1, H, W, D), dtype=np.uint8)
    img = rng.integers(0, 256, (1, H, W), dtype=np.uint8)
    jcfg = JConfig(num_disparities=D, min_disparity=d0, p1=P1, p2=P2,
                   adaptive_p2=True)
    cfg = _cfg(jcfg)
    S7 = None
    for r in tsgm.DIRS_8:
        if r != (0, -1):
            S7 = kernels.sgm_sweep(_t(C), S7, *r, P1, P2, _t(img))
    disp, valid, d_r = kernels.sweep_bwd_wta(_t(C), S7, cfg, _t(img))

    Np, Dp = _round_up(H, 8), _round_up(D, 128)
    pad = ((0, 0), (0, Np - H), (0, Dp - D))
    Ct = np.pad(C[0].transpose(1, 0, 2), pad)
    St = np.pad(S7[0].numpy().transpose(1, 0, 2), pad)
    maps = _p2_stack(jnp.asarray(img[0]), [(0, -1)], jcfg, True, W, Np)
    rd, rv, rr = (np.asarray(v) for v in j_sweep_bwd_wta(
        jnp.asarray(Ct), jnp.asarray(St), jcfg, w_real=W, d_real=D,
        p2_maps=maps, d_start=d0, interpret=True))
    np.testing.assert_array_equal(valid[0].numpy(), rv[:H, :W])
    np.testing.assert_array_equal(d_r[0].numpy(), rr[:H, :W])
    np.testing.assert_allclose(disp[0].numpy(), rd[:H, :W], rtol=0,
                               atol=1e-6)


def test_wrappers_refuse_a_bad_image(rng):
    C = _t(rng.integers(0, 25, (1, 4, 5, 8), dtype=np.uint8))
    S7 = torch.zeros(C.shape, dtype=torch.int16)
    cfg = _cfg(JConfig(num_disparities=8, adaptive_p2=True))
    for bad in (torch.zeros((1, 4, 5), dtype=torch.int16),
                torch.zeros((1, 5, 4), dtype=torch.uint8)):
        with pytest.raises(ValueError, match="img"):
            kernels.sgm_sweep(C, None, 1, 0, P1, P2, bad)
        with pytest.raises(ValueError, match="img"):
            kernels.sweep_bwd_wta(C, S7, cfg, bad)
    with pytest.raises(ValueError, match="left image"):
        kernels.sgm_select(C, cfg)
    with pytest.raises(ValueError, match="left image"):
        kernels.aggregate_volume(C, cfg)


def test_cpu_adaptive_forms_count_no_launch(rng):
    C = _t(rng.integers(0, 25, (1, 4, 6, 16), dtype=np.uint8))
    img = _t(rng.integers(0, 256, (1, 4, 6), dtype=np.uint8))
    kernels.reset_launch_counts()
    S = kernels.sgm_sweep(C, None, 1, 0, P1, P2, img)
    kernels.sgm_sweep(C, S, -1, 0, P1, P2, img)
    kernels.sweep_bwd_wta(C, S, _cfg(JConfig(num_disparities=16)), img)
    assert kernels.launch_counts()["sgm_sweep"] == 0
    assert set(kernels.sgm_sweep.builds.values()) == {0}
    assert set(kernels.sweep_bwd_wta.builds.values()) == {0}


# ---------------------------------------------------------------------------
# the pipelines against the JAX jnp pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(paths=8, min_disparity=3),
    dict(paths=4, min_disparity=2, fill_mode="background"),
    dict(paths=8, min_disparity=1, fill_mode="hirschmuller"),
    dict(paths=8, p1=10, p2=10),
    dict(paths=4, p2=1100, min_disparity=2),
    dict(paths=8, p2=600, fill_mode="hirschmuller")],
    ids=["fused8_d3", "fused4_background", "fused8_hirschmuller",
         "fused8_p1_eq_p2", "volume4_past_fused_bound",
         "volume8_hirschmuller"])
def test_sgbm_batched_matches_jax_jnp(kw):
    """kitti_sgm8 with adaptive P2 at D = 32, F = 2 (speckle and the
    median on); P2 past the fused bound takes the volume route."""
    L, R = _batch()
    jcfg = JPRESETS["kitti_sgm8"].replace(
        num_disparities=32, frames_per_step=2, adaptive_p2=True,
        backend="jnp", **kw)
    ref = np.asarray(j_sgbm_batched(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = sgbm_batched(_t(L), _t(R), _cfg(jcfg)).numpy()
    assert (ref >= 0).mean() > 0.5      # the comparison sees real matches
    _same(got, ref)


@pytest.mark.parametrize("kw", [dict(), dict(paths=8, min_disparity=3,
                                             fill_mode="hirschmuller")],
                         ids=["middlebury_sgm4", "sgm8_d3_hirschmuller"])
def test_volume_route_matches_jax_sgbm(kw):
    """sgbm_volume + select_and_refine with adaptive P2 against the JAX
    sgbm (jnp) on a small middlebury_sgm4, and its volume against the JAX
    sgbm_volume."""
    L, R = _batch(2, (33, 49), 6.0, 520)
    jcfg = JPRESETS["middlebury_sgm4"].replace(
        num_disparities=32, adaptive_p2=True, backend="jnp", **kw)
    cfg = _cfg(jcfg)
    S = sgbm_volume(_t(L), _t(R), cfg)
    got = select_and_refine(S, cfg).numpy()
    for f in range(2):
        np.testing.assert_array_equal(S[f].numpy(), np.asarray(
            jops.aggregate(jops.cost_volume(
                jops.census(jnp.asarray(L[f]), jcfg.census_window),
                jops.census(jnp.asarray(R[f]), jcfg.census_window), 32,
                jcfg.max_census_cost, d_start=jcfg.min_disparity), jcfg,
                jnp.asarray(L[f]))))
        ref = np.asarray(j_sgbm(jnp.asarray(L[f]), jnp.asarray(R[f]), jcfg))
        assert (ref >= 0).mean() > 0.5
        _same(got[f], ref)


def test_volume_route_equals_fused_route():
    """The same adaptive configuration through both routes: equal."""
    L, R = _batch(2, (29, 45), 5.0, 530)
    cfg = _cfg(JPRESETS["kitti_sgm8"].replace(num_disparities=32,
                                              adaptive_p2=True))
    fused = sgbm_batched(_t(L), _t(R), cfg)
    volume = select_and_refine(sgbm_volume(_t(L), _t(R), cfg), cfg)
    assert torch.equal(fused, volume)


def test_bidir_vert_takes_the_default_schedule(monkeypatch):
    """Under adaptive P2 `sgm_select` never calls `sgm_sweep_bidir`, with
    `BIDIR_VERT` or without, and gives the same output; with the scalar
    P2 `BIDIR_VERT` does call it."""
    L, R = _batch(2, (21, 37), 4.0, 540)
    cfg = _cfg(JPRESETS["kitti_sgm8"].replace(num_disparities=16,
                                              frames_per_step=2,
                                              adaptive_p2=True))
    calls = []
    bidir = ksgm.sgm_sweep_bidir

    def counted(*a, **k):
        calls.append(1)
        return bidir(*a, **k)
    monkeypatch.setattr(ksgm, "sgm_sweep_bidir", counted)
    ref = sgbm_batched(_t(L), _t(R), cfg)
    monkeypatch.setattr(ksgm, "BIDIR_VERT", True)
    got = sgbm_batched(_t(L), _t(R), cfg)
    assert torch.equal(got, ref) and not calls
    sgbm_batched(_t(L), _t(R), cfg.replace(adaptive_p2=False))
    assert calls


def test_check_slice_bounds_adaptive_sums_by_p1_plus_1():
    """With P1 = P2 the adaptive map reaches P1 + 1: a P2 whose scalar
    sums fit int16 S can overflow it under adaptive P2."""
    base = _cfg(JConfig(paths=8))
    c = base.max_census_cost
    p = S16_BOUND // 8 - c - 1        # 8 (c + p) < 2^15 <= 8 (c + p + 1)
    scalar = base.replace(p1=p, p2=p)
    check_slice(scalar)
    check_slice(scalar.replace(p1=p - 1, adaptive_p2=True))
    with pytest.raises(NotImplementedError, match="2\\^15"):
        check_slice(scalar.replace(adaptive_p2=True))


def test_config_from_jax_carries_adaptive_p2():
    jcfg = JPRESETS["kitti_sgm8"].replace(adaptive_p2=True)
    cfg = _cfg(jcfg)
    assert cfg.adaptive_p2 is True
    assert cfg.replace(adaptive_p2=False) == _cfg(JPRESETS["kitti_sgm8"])
