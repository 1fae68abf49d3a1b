"""The port's bitonic sort (kernel 12) and the speckle sizes through it, on
the CPU: `bitonic_sort`'s plain version against `bitonic_sort_pallas` in
interpret mode, keys and payload, with heavy key duplication, including
the Pallas blocked schedule with small parts; `component_big_sorted`
against the JAX `component_big(use_pallas=True)` and the port's default;
`speckle_frames` with `BITONIC_SPECKLE` on against off.

Tolerance: bit-exact, payload order included: both run one network with
one tie rule, so equal keys leave their payloads in the same order.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpustereo.kernels.bitonic_pallas as bp
from tpustereo.kernels import bitonic_sort_pallas
from tpustereo.ops import postproc as jpost
from tpustereo_torch import Config, kernels
from tpustereo_torch.kernels.bitonic import bitonic_sort_plain, padded_log2
from tpustereo_torch.ops import postproc as post

psgbm = importlib.import_module("tpustereo_torch.pipeline.sgbm")


def _keys(n, top, seed=0):
    return np.random.default_rng(seed).integers(0, top, (n,)).astype(
        np.int32)


def _check_against_pallas(k):
    n = k.shape[0]
    idx = np.arange(n, dtype=np.int32)
    ref_k = np.asarray(bitonic_sort_pallas(jnp.asarray(k), interpret=True))
    got_k = kernels.bitonic_sort(torch.from_numpy(k))
    np.testing.assert_array_equal(got_k.numpy(), ref_k)
    np.testing.assert_array_equal(ref_k, np.sort(k))
    ref_k, ref_p = bitonic_sort_pallas(jnp.asarray(k), jnp.asarray(idx),
                                       interpret=True)
    got_k, got_p = kernels.bitonic_sort(torch.from_numpy(k),
                                        torch.from_numpy(idx))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(k[got_p.numpy()], got_k.numpy())


@pytest.mark.parametrize("n", [100, 256, 700, 2100, 5000])
def test_bitonic_matches_pallas_interpret(n):
    _check_against_pallas(_keys(n, 50, seed=n))


@pytest.mark.parametrize("n", [2100, 5000])
def test_bitonic_matches_pallas_multipart(n, monkeypatch):
    """The Pallas blocked schedule (parts of 2^10, cross-part exchanges,
    the tail kernel) is the same network: same payload order."""
    monkeypatch.setattr(bp, "_PART_LOG2", 10)
    _check_against_pallas(_keys(n, 60, seed=n + 1))


@pytest.mark.parametrize("n", [1, 3, 257, 1000])
def test_bitonic_sorts_with_few_distinct_keys(n):
    k = _keys(n, 3, seed=n)
    got_k, got_p = kernels.bitonic_sort(torch.from_numpy(k),
                                        torch.arange(n, dtype=torch.int32))
    np.testing.assert_array_equal(got_k.numpy(), np.sort(k))
    assert sorted(got_p.tolist()) == list(range(n))
    np.testing.assert_array_equal(k[got_p.numpy()], got_k.numpy())


def test_bitonic_rows_are_independent_sorts():
    rng = np.random.default_rng(3)
    k = rng.integers(0, 40, (2, 3, 700)).astype(np.int32)
    p = rng.integers(-5, 5, (2, 3, 700)).astype(np.int32)
    got_k, got_p = kernels.bitonic_sort(torch.from_numpy(k),
                                        torch.from_numpy(p))
    assert got_k.shape == k.shape and got_p.shape == p.shape
    for a in range(2):
        for b in range(3):
            rk, rp = bitonic_sort_plain(torch.from_numpy(k[a, b]),
                                        torch.from_numpy(p[a, b]))
            assert torch.equal(got_k[a, b], rk)
            assert torch.equal(got_p[a, b], rp)


def test_bitonic_padding_matches_jax():
    for n in (1, 255, 256, 257, 465750):
        assert 1 << padded_log2(n) == max(256, 1 << (n - 1).bit_length())
    assert padded_log2(465750) == 19


def test_bitonic_refuses_bad_inputs():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.bitonic_sort(k.long())
    with pytest.raises(ValueError):
        kernels.bitonic_sort(torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.bitonic_sort(k, torch.zeros(7, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.bitonic_sort(k, k.float())


def _labels(H, W, p, seed):
    from tpustereo_torch.ops import connected_component_labels
    v = torch.from_numpy(np.random.default_rng(seed).random((H, W)) < p)
    return connected_component_labels(v[:, :-1] & v[:, 1:],
                                      v[:-1, :] & v[1:, :])


@pytest.mark.parametrize("thresh", [1, 5, 40])
def test_component_big_sorted_matches_jax(thresh):
    lab = _labels(20, 36, 0.55, seed=4)
    ref = np.asarray(jpost.component_big(jnp.asarray(lab.numpy()), thresh,
                                         use_pallas=True, interpret=True))
    got = post.component_big_sorted(lab, thresh, kernels.bitonic_sort)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got, post.component_big(lab, thresh))
    assert torch.equal(got, post.component_big_sorted(lab, thresh))


def test_component_big_sorted_frames_match_per_frame():
    labs = torch.stack([_labels(24, 31, p, seed=5 + i)
                        for i, p in enumerate((0.5, 0.6, 0.7))])
    got = post.component_big_sorted(labs, 12, kernels.bitonic_sort)
    for f in range(3):
        assert torch.equal(got[f], post.component_big(labs[f], 12))


@pytest.mark.parametrize("window", [20, 100])
def test_speckle_frames_bitonic_matches_default(window, monkeypatch):
    rng = np.random.default_rng(6)
    disp = torch.from_numpy(rng.integers(0, 5, (3, 29, 41)).astype(
        np.float32))
    valid = torch.from_numpy(rng.random((3, 29, 41)) < 0.8)
    cfg = Config(speckle_window_size=window, speckle_range=1)
    ref = post.speckle_frames(disp, valid, cfg)
    monkeypatch.setattr(post, "BITONIC_SPECKLE", True)
    kernels.reset_launch_counts()
    got = post.speckle_frames(disp, valid, cfg, sort=kernels.bitonic_sort)
    assert torch.equal(got, ref) and not torch.equal(ref, valid)
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain
