"""The SAD and census_wta modes of the port on the CPU.

`ops.sad.sad_volume` against the JAX jnp `sad_volume`; the plain versions
of the two mode kernels (`kernels.sad.sad_wta_plain`,
`kernels.wta.wta_lr_plain`) against the JAX Pallas kernels in interpret
mode; and the pipeline (`pipeline.sgbm_batched`, `api.match_batch`)
against the JAX `sgbm_batched` with `backend="jnp"`. Inputs are made from a
seed with numpy and handed to both packages.

Tolerance: integer outputs and every valid mask bit-exact; float disparity
within atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustereo import ops as jops
from tpustereo.config import PRESETS as JPRESETS
from tpustereo.config import Config as JConfig
from tpustereo.kernels import sad_wta_pallas, wta_lr_pallas
from tpustereo.pipeline import sgbm_batched as j_sgbm_batched
from tpustereo_torch import PRESETS, api, kernels
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.kernels.sad import sad_wta_plain
from tpustereo_torch.kernels.wta import wta_lr_plain
from tpustereo_torch.ops import census, cost_volume, sad_volume
from tpustereo_torch.pipeline import sgbm_batched


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


def _same(got, ref):
    np.testing.assert_array_equal(got == -1.0, ref == -1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _batch(B=4, shape=(33, 61), disparity=5.0):
    ps = [synthetic_pair(shape, disparity=disparity + f, slope=0.03,
                         seed=500 + f)[:2] for f in range(B)]
    return np.stack([p[0] for p in ps]), np.stack([p[1] for p in ps])


# ---------------------------------------------------------------------------
# ops.sad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d_start", [0, 3])
@pytest.mark.parametrize("block", [5, 9, 11, 13, 8])
def test_sad_volume_matches_jax(rng, block, d_start):
    L = rng.integers(0, 256, (2, 21, 30), dtype=np.uint8)
    R = rng.integers(0, 256, (2, 21, 30), dtype=np.uint8)
    got = sad_volume(_t(L), _t(R), 16, block, d_start)
    assert got.dtype == torch.int32 and got.shape == (2, 21, 30, 16)
    for f in range(2):
        ref = jops.sad_volume(jnp.asarray(L[f]), jnp.asarray(R[f]), 16,
                              block, d_start=d_start)
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(ref))


def test_sad_volume_search_wider_than_image(rng):
    L = rng.integers(0, 256, (12, 20), dtype=np.uint8)
    R = rng.integers(0, 256, (12, 20), dtype=np.uint8)
    ref = jops.sad_volume(jnp.asarray(L), jnp.asarray(R), 40, 9, d_start=3)
    got = sad_volume(_t(L), _t(R), 40, 9, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# kernels.sad: the fused SAD plane sweep
# ---------------------------------------------------------------------------

# the knob matrix of tests/test_pallas.py::test_sad_fused_matches_jnp
SAD_KNOBS = [(16, 5, 0, 0, False, -1), (32, 9, 0, 10, True, 1),
             (32, 9, 3, 10, True, -1), (16, 11, 0, 0, True, 1),
             (32, 5, 3, 5, False, 2), (16, 9, 0, 10, False, 0),
             (128, 9, 0, 10, True, 1),    # D > W
             (96, 9, 40, 10, True, 1)]    # large min_disparity, D > W - d0


@pytest.fixture(scope="module")
def sad_pair():
    L, R, _, _ = synthetic_pair((45, 70), disparity=8.0, slope=0.05, seed=3)
    return L, R


@pytest.mark.parametrize("D,blk,d0,uniq,subp,d12", SAD_KNOBS)
def test_sad_wta_plain_matches_pallas_interpret(sad_pair, D, blk, d0, uniq,
                                                subp, d12):
    L, R = sad_pair
    jcfg = JConfig(mode="sad", num_disparities=D, sad_block=blk,
                   min_disparity=d0, uniqueness_ratio=uniq, subpixel=subp,
                   disp12_max_diff=d12)
    d_ref, v_ref, dr_ref = sad_wta_pallas(jnp.asarray(L), jnp.asarray(R),
                                          jcfg, interpret=True)
    disp, valid, d_r = sad_wta_plain(_t(L)[None], _t(R)[None], _cfg(jcfg))
    np.testing.assert_allclose(disp[0].numpy(), np.asarray(d_ref), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(v_ref))
    if d12 < 0:
        assert d_r is None and dr_ref is None
        return
    # The maps agree wherever the LR check reads them. The Pallas kernel
    # masks the columns x < min_disparity (right columns < 0) to plane 0;
    # the port keeps argmin_k S(x + k, k) there, as `_right_disparity` and
    # `sweep_bwd_wta` do. The check never reads those columns.
    dr_ref = np.asarray(dr_ref)
    np.testing.assert_array_equal(d_r[0, :, d0:].numpy(), dr_ref[:, d0:])
    ok = kernels.dr_consistency(d_r[0], disp[0], D, d12, d0)
    ok_ref = kernels.dr_consistency(_t(dr_ref), disp[0], D, d12, d0)
    assert torch.equal(ok, ok_ref)
    # and the fused LR result is the volume path's `ops.lr_check`
    jS = jops.sad_volume(jnp.asarray(L), jnp.asarray(R), D, blk, d_start=d0)
    lr_ref = jops.lr_check(jS, jnp.asarray(disp[0].numpy()), jcfg)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(lr_ref))


# ---------------------------------------------------------------------------
# kernels.wta: WTA + LR over a volume
# ---------------------------------------------------------------------------

def _int16_volume(rng, H=19, W=43, D=16):
    return rng.integers(0, 1000, (H, W, D)).astype(np.int16)


def _census_volume(small_pair, D=32, d0=0):
    L, R, _, _ = small_pair
    return cost_volume(census(_t(L)), census(_t(R)), D, 24, d0).numpy()


@pytest.mark.parametrize("kind,uniq,subp,d12,d0", [
    ("int16", 10, True, 1, 0), ("int16", 0, False, -1, 0),
    ("int16", 10, True, 2, 3), ("int16", 5, False, 0, 4),
    ("census", 10, True, -1, 0), ("census", 10, True, 1, 0),
    ("census", 0, True, 1, 3), ("census", 10, False, 2, 5)])
def test_wta_lr_plain_matches_pallas_interpret(rng, small_pair, kind, uniq,
                                               subp, d12, d0):
    S = (_int16_volume(rng) if kind == "int16"
         else _census_volume(small_pair, d0=d0))
    jcfg = JConfig(num_disparities=S.shape[-1], uniqueness_ratio=uniq,
                   subpixel=subp, disp12_max_diff=d12, min_disparity=d0)
    d_ref, v_ref = wta_lr_pallas(jnp.asarray(S), jcfg, interpret=True)
    disp, valid = wta_lr_plain(_t(S)[None], _cfg(jcfg))
    np.testing.assert_allclose(disp[0].numpy(), np.asarray(d_ref), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(v_ref))
    if d12 >= 0:       # the LR check changes the result it is held to
        unchecked = wta_lr_plain(_t(S)[None],
                                 _cfg(jcfg.replace(disp12_max_diff=-1)))[1]
        assert not torch.equal(valid, unchecked)


def test_mode_wrappers_take_the_plain_path_on_cpu(rng, small_pair):
    kernels.reset_launch_counts()
    L, R, _, _ = small_pair
    cfg = PRESETS["tsukuba_sad"].replace(num_disparities=16,
                                         disp12_max_diff=1)
    a = kernels.sad_wta(_t(L)[None], _t(R)[None], cfg)
    b = sad_wta_plain(_t(L)[None], _t(R)[None], cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    S = _t(_int16_volume(rng))[None]
    for x, y in zip(kernels.wta_lr(S, cfg), wta_lr_plain(S, cfg)):
        assert torch.equal(x, y)
    assert set(kernels.launch_counts().values()) == {0}


def test_mode_wrappers_refuse_bad_inputs():
    img = torch.zeros((1, 8, 16), dtype=torch.uint8)
    cfg = PRESETS["tsukuba_sad"]
    with pytest.raises(TypeError):
        kernels.sad_wta(img.float(), img, cfg)
    with pytest.raises(ValueError):
        kernels.sad_wta(img[0], img[0], cfg)
    with pytest.raises(ValueError):
        kernels.sad_wta(img, img[:, :4], cfg)
    with pytest.raises(ValueError, match="2\\^20"):
        kernels.sad_wta(img, img, cfg.replace(sad_block=65))
    C = torch.zeros((1, 8, 16, 16), dtype=torch.uint8)
    with pytest.raises(TypeError):
        kernels.wta_lr(C.long(), cfg)
    with pytest.raises(ValueError):
        kernels.wta_lr(C[0], cfg)
    with pytest.raises(ValueError):
        kernels.wta_lr(torch.zeros((1, 2, 4, 600), dtype=torch.int16), cfg)


# ---------------------------------------------------------------------------
# the pipeline against the JAX pipeline
# ---------------------------------------------------------------------------

MODE_CASES = {
    "sad": ("tsukuba_sad", dict()),
    "sad_lr_min_disp2": ("tsukuba_sad", dict(disp12_max_diff=1,
                                             min_disparity=2)),
    "sad_block8_speckle_median_f2": ("tsukuba_sad", dict(
        sad_block=8, disp12_max_diff=1, speckle_window_size=20,
        median_filter=True, frames_per_step=2)),
    "census_wta": ("middlebury_census_wta", dict()),
    "census_wta_lr_min_disp3": ("middlebury_census_wta", dict(
        disp12_max_diff=1, min_disparity=3)),
    "census_wta_speckle_median_f4": ("middlebury_census_wta", dict(
        disp12_max_diff=0, speckle_window_size=20, median_filter=True,
        frames_per_step=4)),
}


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_mode_pipeline_matches_jax_jnp(case):
    name, kw = MODE_CASES[case]
    L, R = _batch()
    jcfg = JPRESETS[name].replace(num_disparities=16, backend="jnp", **kw)
    ref = np.asarray(j_sgbm_batched(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = sgbm_batched(_t(L), _t(R), _cfg(jcfg))
    assert (ref >= 0).mean() > 0.3      # the comparison sees real matches
    _same(got.numpy(), ref)


@pytest.mark.parametrize("name", ["tsukuba_sad", "middlebury_census_wta"])
def test_preset_through_match_batch_matches_jax(name):
    """The preset as it stands (D = 64 / 128), on small frames."""
    L, R = _batch(B=2, shape=(24, 150), disparity=20.0)
    jcfg = JPRESETS[name].replace(backend="jnp")
    ref = np.asarray(j_sgbm_batched(jnp.asarray(L), jnp.asarray(R), jcfg))
    cfg = _cfg(jcfg)
    assert cfg.replace(backend="auto") == PRESETS[name]
    got = api.match_batch(L, R, cfg, device="cpu")
    assert (ref >= 0).mean() > 0.3
    _same(got, ref)


@pytest.mark.parametrize("name", ["tsukuba_sad", "middlebury_census_wta"])
def test_mode_frames_per_step_changes_nothing(name):
    L, R = (_t(a) for a in _batch())
    cfg = PRESETS[name].replace(num_disparities=16, disp12_max_diff=1,
                                speckle_window_size=20, median_filter=True)
    a = sgbm_batched(L, R, cfg)
    for F in (2, 4):
        assert torch.equal(a, sgbm_batched(L, R,
                                           cfg.replace(frames_per_step=F)))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["tsukuba_sad", "middlebury_census_wta"])
def test_mode_pipeline_matches_jax_pallas_interpret(name):
    L, R = _batch(B=2, shape=(24, 40))
    jcfg = JPRESETS[name].replace(num_disparities=16, backend="pallas",
                                  disp12_max_diff=1, frames_per_step=2)
    ref = np.asarray(j_sgbm_batched(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = api.match_batch(L, R, _cfg(jcfg), device="cpu")
    _same(got, ref)
