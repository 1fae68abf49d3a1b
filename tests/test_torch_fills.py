"""The port's gap fills on the CPU: `fill_background`, `fill_hirschmuller`
(its ray holds), `lr_hits` and `lr_hits_from_volume` against the JAX jnp
ops; the hits kernel's plain version against `dr_consistency_pallas(
with_hits=True)` in interpret mode; `wta_lr`'s right-view map; and the
pipeline with each fill, for every mode and past the fused bound, with the
bitonic speckle toggle off and on, against the JAX `sgbm_batched` with
`backend="jnp"`.

Tolerance: masks and fills bit-exact; whole pipelines, the pattern of -1.0
invalids exact and disparity within atol 1e-6.
"""

import dataclasses
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustereo.config import PRESETS as JPRESETS
from tpustereo.config import Config as JConfig
from tpustereo.kernels import dr_consistency_pallas
from tpustereo.ops import postproc as jpost
from tpustereo.pipeline import sgbm_batched as j_sgbm_batched
from tpustereo_torch import Config, kernels
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.ops import postproc as post
from tpustereo_torch.pipeline import (select_and_refine, sgbm_batched,
                                      sgbm_volume)

psgbm = importlib.import_module("tpustereo_torch.pipeline.sgbm")

# (H, W, invalid share): a map with gaps, one row, one column, a tiny map,
# a sparse map and a fully invalid one
MAPS = [(48, 64, 0.5), (1, 30, 0.3), (30, 1, 0.3), (5, 7, 0.2),
        (20, 33, 0.9), (9, 11, 1.0)]
MAP_IDS = ["48x64", "H1", "W1", "5x7", "sparse", "all_invalid"]


def _map(H, W, p, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 40, (H, W)).astype(np.float32)
    d[rng.random((H, W)) < p] = -1.0
    return d, rng.random((H, W)) < 0.5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("H,W,p", MAPS, ids=MAP_IDS)
def test_fill_background_matches_jax(H, W, p):
    d, _ = _map(H, W, p)
    ref = np.asarray(jpost.fill_background(jnp.asarray(d)))
    np.testing.assert_array_equal(post.fill_background(_t(d)).numpy(), ref)


@pytest.mark.parametrize("H,W,p", MAPS, ids=MAP_IDS)
def test_fill_hirschmuller_matches_jax(H, W, p):
    d, mismatch = _map(H, W, p, seed=1)
    ref = np.asarray(jpost.fill_hirschmuller(jnp.asarray(d),
                                             jnp.asarray(mismatch)))
    got = post.fill_hirschmuller(_t(d), _t(mismatch)).numpy()
    np.testing.assert_array_equal(got, ref)
    if 0 < p < 1:
        assert not np.array_equal(got, d)     # something was filled


def test_sort8_network_sorts():
    """The fill's exchange network sorts every 0/1 input of 8 (the 0-1
    principle: then it sorts every input) and random floats with ties."""
    bits = (np.arange(256)[:, None] >> np.arange(8)) & 1
    rng = np.random.default_rng(8)
    floats = rng.integers(0, 5, (500, 8)).astype(np.float32)
    for x in (bits.astype(np.float32), floats):
        s = list(torch.from_numpy(x).T)
        for i, j in post.SORT8_NET:
            s[i], s[j] = torch.minimum(s[i], s[j]), torch.maximum(s[i], s[j])
        np.testing.assert_array_equal(torch.stack(s, 1).numpy(),
                                      np.sort(x, axis=1))


@pytest.mark.parametrize("dy,dx", [(1, 1), (1, -1), (-1, 1), (-1, -1)])
def test_hold_diag_matches_jax(dy, dx):
    d, _ = _map(23, 37, 0.7, seed=2)
    ref = np.asarray(jpost._hold_diag(jnp.asarray(d), jnp.asarray(d >= 0),
                                      dy, dx))
    # the port's pair of rays (1, dy * dx), (-1, -dy * dx); dy picks one
    got = post._hold_diags(_t(d), _t(d >= 0), dy * dx)[0 if dy > 0 else 1]
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fills_run_per_frame():
    """A stack of frames (one fully invalid) fills as each frame alone."""
    frames = [_map(17, 29, p, seed=3 + i) for i, p in
              enumerate((0.4, 1.0, 0.8))]
    d = np.stack([f[0] for f in frames])
    mm = np.stack([f[1] for f in frames])
    got_h = post.fill_hirschmuller(_t(d), _t(mm)).numpy()
    got_b = post.fill_background(_t(d)).numpy()
    for f in range(3):
        np.testing.assert_array_equal(got_h[f], np.asarray(
            jpost.fill_hirschmuller(jnp.asarray(d[f]), jnp.asarray(mm[f]))))
        np.testing.assert_array_equal(got_b[f], np.asarray(
            jpost.fill_background(jnp.asarray(d[f]))))
    assert (got_h[1] == -1.0).all() and (got_b[1] == -1.0).all()


@pytest.mark.parametrize("d0,D,max_diff", [(0, 16, 1), (3, 16, 0),
                                           (5, 32, 2), (0, 48, 1)])
def test_lr_hits_matches_jax(d0, D, max_diff):
    rng = np.random.default_rng(4)
    jcfg = JConfig(num_disparities=D, min_disparity=d0,
                   disp12_max_diff=max_diff)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    d_R = rng.integers(d0, d0 + D, (10, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        post.lr_hits(_t(d_R), cfg).numpy(),
        np.asarray(jpost.lr_hits(jnp.asarray(d_R), jcfg)))
    S = rng.integers(0, 30, (6, 25, D)).astype(np.int16)
    np.testing.assert_array_equal(
        post.lr_hits_from_volume(_t(S), cfg).numpy(),
        np.asarray(jpost.lr_hits_from_volume(jnp.asarray(S), jcfg)))


@pytest.mark.parametrize("shape", [(40, 72, 32), (6, 20, 32), (1, 1, 8),
                                   (7, 1, 16)],
                         ids=["W>D", "W<D", "1x1", "W1"])
@pytest.mark.parametrize("d_start", [0, 5])
def test_hits_plain_matches_pallas_interpret(shape, d_start):
    H, W, D = shape
    rng = np.random.default_rng(5)
    d_r = rng.integers(0, D, (H, W), dtype=np.int32)
    disp = rng.uniform(d_start - 0.5, d_start + D - 0.5,
                       (H, W)).astype(np.float32)
    for max_diff in (0, 1, 2):
        ok_ref, hits_ref = dr_consistency_pallas(
            jnp.asarray(d_r), jnp.asarray(disp), D, max_diff,
            interpret=True, with_hits=True, d_start=d_start)
        ok, hits = kernels.dr_consistency_hits(_t(d_r), _t(disp), D,
                                               max_diff, d_start)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref),
                                      err_msg=f"ok, max_diff={max_diff}")
        np.testing.assert_array_equal(hits.numpy(), np.asarray(hits_ref),
                                      err_msg=f"hits, max_diff={max_diff}")
        assert torch.equal(ok, kernels.dr_consistency(
            _t(d_r), _t(disp), D, max_diff, d_start))


@pytest.mark.parametrize("d0", [0, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32])
def test_wta_lr_right_map_matches_jax(d0, dtype):
    rng = np.random.default_rng(6)
    S = rng.integers(0, 25, (2, 9, 30, 16)).astype(dtype)
    cfg = Config(num_disparities=16, min_disparity=d0, disp12_max_diff=1)
    disp, valid, d_R = kernels.wta_lr(_t(S), cfg, with_dr=True)
    for f in range(2):
        np.testing.assert_array_equal(d_R[f].numpy(), np.asarray(
            jpost._right_disparity(jnp.asarray(S[f]), d0)))
    disp0, valid0 = kernels.wta_lr(_t(S), cfg)
    assert torch.equal(disp, disp0) and torch.equal(valid, valid0)


@pytest.mark.parametrize("d0", [0, 3, 40])
def test_volume_hits_equal_lr_hits(d0):
    """The volume route's hits (wta_lr's d_R in the shifted-column
    convention, through the hits kernel's function) equal `lr_hits` of
    the true-unit map."""
    rng = np.random.default_rng(7)
    S = _t(rng.integers(0, 25, (2, 9, 30, 16)).astype(np.int16))
    cfg = Config(num_disparities=16, min_disparity=d0, disp12_max_diff=1)
    disp, _, d_R = kernels.wta_lr(S, cfg, with_dr=True)
    _, hits = kernels.dr_consistency_hits(
        psgbm._shifted_columns(d_R, d0), disp, 16, 1, d0)
    assert torch.equal(hits, post.lr_hits(d_R, cfg))


# ---------------------------------------------------------------------------
# the pipeline with fills against the JAX jnp pipeline
# ---------------------------------------------------------------------------

PIPELINES = {
    "sgm_hirschmuller": dict(fill_mode="hirschmuller"),
    "sgm_background": dict(fill_mode="background"),
    "sgm_hirschmuller_d0": dict(fill_mode="hirschmuller", min_disparity=3,
                                paths=4),
    "sgm_past_bound": dict(fill_mode="hirschmuller", paths=4, p2=1000),
    "sad_hirschmuller": dict(mode="sad", sad_block=5, disp12_max_diff=1,
                             fill_mode="hirschmuller"),
    "sad_background": dict(mode="sad", sad_block=5, fill_mode="background"),
    "census_wta_hirschmuller": dict(mode="census_wta", disp12_max_diff=1,
                                    fill_mode="hirschmuller",
                                    min_disparity=2),
    "census_wta_background": dict(mode="census_wta",
                                  fill_mode="background"),
}


def _batch(B=4, shape=(33, 49)):
    ps = [synthetic_pair(shape, disparity=4.0 + f, slope=0.03,
                         seed=200 + f)[:2] for f in range(B)]
    return np.stack([p[0] for p in ps]), np.stack([p[1] for p in ps])


def _jcfg(name):
    return JPRESETS["kitti_sgm8"].replace(num_disparities=32,
                                          frames_per_step=2, backend="jnp",
                                          **PIPELINES[name])


@functools.lru_cache(maxsize=None)
def _jax_ref(name):
    L, R = _batch()
    return np.asarray(j_sgbm_batched(jnp.asarray(L), jnp.asarray(R),
                                     _jcfg(name)))


def _same(got, ref):
    np.testing.assert_array_equal(got == -1.0, ref == -1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bitonic", [False, True], ids=["sort", "bitonic"])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_fills_match_jax_jnp(name, bitonic, monkeypatch):
    monkeypatch.setattr(post, "BITONIC_SPECKLE", bitonic)
    L, R = _batch()
    cfg = config_from_jax(dataclasses.asdict(_jcfg(name)))
    got = sgbm_batched(_t(L), _t(R), cfg).numpy()
    _same(got, _jax_ref(name))
    # the fill filled something: the unfilled run has more invalid pixels
    off = sgbm_batched(_t(L), _t(R), cfg.replace(fill_mode="off")).numpy()
    assert (got == -1.0).sum() < (off == -1.0).sum()


def test_hirschmuller_hits_matter():
    """Hits from the fused route equal those of the plain volume route, and
    the classification changes the fill: all-mismatch differs."""
    L, R = (_t(a) for a in _batch(B=2))
    cfg = Config(num_disparities=32, fill_mode="hirschmuller",
                 speckle_window_size=100, median_filter=False)
    disp, valid, hits = psgbm._select(L, R, cfg)
    S = sgbm_volume(L, R, cfg)
    assert torch.equal(hits, post.lr_hits_from_volume(S.to(torch.int32),
                                                      cfg))
    gaps = torch.where(valid, disp, -1.0)
    assert not torch.equal(post.fill_hirschmuller(gaps, hits),
                           post.fill_hirschmuller(gaps, torch.ones_like(
                               hits)))
    vol = select_and_refine(S, cfg)
    fused = psgbm._postproc(disp, valid, hits, cfg)
    assert torch.equal(vol, fused)
