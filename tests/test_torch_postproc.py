"""The port's speckle and median (`tpustereo_torch.ops.postproc`, and the
CPU path of `kernels.connected_component_labels` / `kernels.median3`)
against the JAX package on the CPU: the jnp ops and the Pallas kernels
in interpret mode, on inputs made from a numpy seed.

Tolerance: labels, valid masks and medians bit-exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import hilbert_path_mask
from tests.test_torch_gpu import CC_MASKS, _cc_masks, _conn, _hilbert_mask
from tpustereo.ops import postproc as jops
from tpustereo.config import Config as JConfig
from tpustereo.kernels import connected_component_labels_pallas, median3_pallas
from tpustereo_torch import kernels, ops
from tpustereo_torch.convert import config_from_jax


def _jcc(conn_h, conn_v, ref):
    """The JAX labelling of one frame's edge masks, by `ref`."""
    h, v = jnp.asarray(conn_h.numpy()), jnp.asarray(conn_v.numpy())
    if ref == "pallas":
        return np.asarray(connected_component_labels_pallas(h, v,
                                                            interpret=True))
    return np.asarray(jops.connected_component_labels(h, v))


def test_hilbert_mask_is_conftests():
    np.testing.assert_array_equal(_hilbert_mask(4), hilbert_path_mask(4))


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
@pytest.mark.parametrize("name", CC_MASKS)
def test_cc_labels_match_jax(name, ref):
    if name == "w1" and ref == "jnp":
        # the jnp labelling cannot take W = 1 (it reduces an empty conn_h);
        # the kernel can, and so can its transpose, a one-row image
        v = _cc_masks(name)
        got = ops.connected_component_labels(*_conn(v))
        ref_t = ops.connected_component_labels(*_conn(np.ascontiguousarray(
            v.T)))
        np.testing.assert_array_equal(got.numpy().T, ref_t.numpy())
        np.testing.assert_array_equal(
            ref_t.numpy(), _jcc(*_conn(np.ascontiguousarray(v.T)), "jnp"))
        return
    v = _cc_masks(name)
    conn_h, conn_v = _conn(v)
    got = ops.connected_component_labels(conn_h, conn_v)
    assert got.dtype == torch.int32 and got.shape == v.shape
    frames = [(conn_h, conn_v)] if v.ndim == 2 else list(zip(conn_h, conn_v))
    ref_labels = np.stack([_jcc(h, c, ref) for h, c in frames])
    np.testing.assert_array_equal(got.numpy().reshape(ref_labels.shape),
                                  ref_labels)


@pytest.mark.parametrize("name", ["p0.55", "frames3", "h1", "w1"])
def test_cc_wrapper_cpu_is_plain(name):
    conn_h, conn_v = _conn(_cc_masks(name))
    kernels.reset_launch_counts()
    got = kernels.connected_component_labels(conn_h, conn_v)
    assert torch.equal(got, ops.connected_component_labels(conn_h, conn_v))
    assert kernels.connected_component_labels.launches == 0


def test_cc_wrapper_refuses_bad_inputs():
    h = torch.zeros((4, 7), dtype=torch.bool)
    v = torch.zeros((3, 8), dtype=torch.bool)
    with pytest.raises(TypeError):
        kernels.connected_component_labels(h.int(), v)
    with pytest.raises(ValueError):
        kernels.connected_component_labels(h, v[:2])
    with pytest.raises(ValueError):
        kernels.connected_component_labels(h[None], v)


def _speckle_maps(F=1, H=30, W=44, seed=3):
    """Piecewise-constant disparity on random 3x4 blocks, with half-pixel
    steps inside blocks and invalid holes: components of many sizes."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 12, (F, H // 3 + 1, W // 4 + 1))
    disp = np.repeat(np.repeat(blocks, 3, 1), 4, 2)[:, :H, :W].astype(
        np.float32)
    disp += rng.choice(np.float32([0.0, 0.5, 1.0]), (F, H, W))
    valid = rng.random((F, H, W)) > 0.15
    return disp, valid


def _jcfg(window, rng_):
    return JConfig(num_disparities=32, speckle_window_size=window,
                   speckle_range=rng_, backend="jnp")


@pytest.mark.parametrize("window", [1, 20, 100])
@pytest.mark.parametrize("srange", [0, 2])
def test_speckle_matches_jax(window, srange):
    disp, valid = _speckle_maps()
    jcfg = _jcfg(window, srange)
    ref = np.asarray(jops.speckle(jnp.asarray(disp[0]),
                                  jnp.asarray(valid[0]), jcfg))
    got = ops.speckle(torch.from_numpy(disp[0]), torch.from_numpy(valid[0]),
                      config_from_jax(dataclasses.asdict(jcfg)))
    np.testing.assert_array_equal(got.numpy(), ref)
    if window > 1:
        assert (ref != valid[0]).any()      # the filter removed something


@pytest.mark.parametrize("window", [1, 20, 100])
@pytest.mark.parametrize("srange", [0, 2])
def test_speckle_frames_matches_jax(window, srange):
    disp, valid = _speckle_maps(F=3, seed=4)
    jcfg = _jcfg(window, srange)
    ref = np.asarray(jops.speckle_frames(jnp.asarray(disp),
                                         jnp.asarray(valid), jcfg))
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    d, v = torch.from_numpy(disp), torch.from_numpy(valid)
    got = ops.speckle_frames(d, v, cfg)
    np.testing.assert_array_equal(got.numpy(), ref)
    # through the kernel wrapper's CPU path, as the pipeline calls it
    got_k = ops.speckle_frames(d, v, cfg, cc=kernels.connected_component_labels)
    assert torch.equal(got_k, got)


@pytest.mark.parametrize("srange", [0, 2])
def test_speckle_labels_match_jax(srange):
    disp, valid = _speckle_maps(seed=8)
    jcfg = _jcfg(50, srange)
    ref = np.asarray(jops.speckle_labels(jnp.asarray(disp[0]),
                                         jnp.asarray(valid[0]), jcfg))
    got = ops.speckle_labels(torch.from_numpy(disp[0]),
                             torch.from_numpy(valid[0]),
                             config_from_jax(dataclasses.asdict(jcfg)))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("thresh", [1, 3, 40])
def test_component_big_matches_jax(thresh):
    rng = np.random.default_rng(9)
    v = rng.random((3, 24, 40)) < 0.6
    lab = ops.connected_component_labels(*_conn(v))
    lab = lab + torch.arange(3, dtype=torch.int32)[:, None, None] * 24 * 40
    flat = lab.reshape(3 * 24, 40)
    ref = np.asarray(jops.component_big(jnp.asarray(flat.numpy()), thresh))
    np.testing.assert_array_equal(ops.component_big(flat, thresh).numpy(),
                                  ref)


MEDIAN_SHAPES = [(24, 40), (1, 17), (2, 9), (13, 1), (11, 2), (1, 1),
                 (3, 21, 37), (2, 1, 6), (2, 7, 2)]


def _median_input(shape, seed=11):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 60, shape).astype(np.float32)
    d[rng.random(shape) < 0.3] = -1.0
    return d


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
@pytest.mark.parametrize("shape", MEDIAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in MEDIAN_SHAPES])
def test_median3_matches_jax(shape, ref):
    d = _median_input(shape)
    if ref == "pallas":
        want = np.asarray(median3_pallas(jnp.asarray(d), interpret=True))
    else:
        frames = d if d.ndim == 3 else d[None]
        want = np.stack([np.asarray(jops.median3(jnp.asarray(f)))
                         for f in frames]).reshape(shape)
    got = ops.median3(torch.from_numpy(d))
    assert got.shape == d.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper's CPU path is the plain version
    assert torch.equal(kernels.median3(torch.from_numpy(d)), got)


def test_median3_wrapper_refuses_bad_inputs():
    with pytest.raises(TypeError):
        kernels.median3(torch.zeros((4, 5), dtype=torch.float64))
    with pytest.raises(ValueError):
        kernels.median3(torch.zeros((2, 2, 4, 5)))
    with pytest.raises(ValueError):
        kernels.median3(torch.zeros((0, 5)))
