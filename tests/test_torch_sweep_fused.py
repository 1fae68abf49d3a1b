"""The port's fused sweep `kernels.sgm_sweep_fused` on the CPU: the sum over
`dxs` of the path costs of one scan order, against the JAX `sgm_sweep(C,
S_in, dxs, reverse, ...)` in interpret mode (scalar P2, and adaptive P2
with the JAX `p2_maps` from its `_p2_stack`); `sgm_select` and
`aggregate_volume`, which run it on their 8-path routes, against
`sgm_select_pallas` and `aggregate_pallas` in interpret mode; the
wrapper's refusals and launch counts.

The JAX sweep takes one frame in its (T, N, D) layout with D padded to
128 and N to 8 (zeros, as `aggregate_pallas` pads them); `reverse` is the
up order, dy = -1. Inputs are made from a seed with numpy and handed to
both packages.

Tolerance: int16 volumes bit-exact; float disparity within atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustereo.config import Config as JConfig
from tpustereo.kernels import aggregate_pallas, sgm_select_pallas
from tpustereo.kernels.sgm_pallas import _p2_stack
from tpustereo.kernels.sgm_pallas import sgm_sweep as j_sgm_sweep
from tpustereo_torch import kernels
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.kernels.sgm import sgm_sweep_fused_plain
from tpustereo_torch.ops.sgm import path_costs

P1, P2 = 7, 90
DXS = [(0, 1, -1), (1, -1), (0,)]
# (H, W, D): a frame taller than wide, one wider than tall
GEOMETRIES = [(6, 11, 16), (9, 4, 40)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _jax_fused(C, S0, img, dy, dxs, p1=P1, p2=P2):
    """sum over dxs of L_(dy, dx) of one (H, W, D) frame (plus S0 where
    given) by the JAX sweep in interpret mode; img the adaptive maps'
    image, or None for the scalar P2."""
    T, N, D = C.shape
    Np, Dp = _round_up(N, 8), _round_up(D, 128)
    pad = ((0, 0), (0, Np - N), (0, Dp - D))
    S_in = None if S0 is None else jnp.asarray(np.pad(S0, pad))
    maps = None
    if img is not None:
        maps = _p2_stack(jnp.asarray(img), [(dy, dx) for dx in dxs],
                         JConfig(p1=p1, p2=p2, adaptive_p2=True), False, T,
                         Np)
    S = j_sgm_sweep(jnp.asarray(np.pad(C, pad)), S_in, tuple(dxs), dy < 0,
                    p1, p2, N, D, p2_maps=maps, interpret=True)
    return np.asarray(S)[:, :N, :D]


def _inputs(rng, H, W, D, form):
    C = rng.integers(0, 25, (2, H, W, D), dtype=np.uint8)
    S0 = (rng.integers(-500, 500, C.shape, dtype=np.int16)
          if form == "add" else None)
    return C, S0


@pytest.mark.parametrize("form", ["write", "add"])
@pytest.mark.parametrize("dy", [1, -1])
@pytest.mark.parametrize("dxs", DXS)
@pytest.mark.parametrize("H,W,D", GEOMETRIES)
def test_fused_matches_pallas_interpret(rng, H, W, D, dxs, dy, form):
    C, S0 = _inputs(rng, H, W, D, form)
    S = None if S0 is None else _t(S0)
    got = kernels.sgm_sweep_fused(_t(C), S, dy, dxs, P1, P2)
    assert got.dtype == torch.int16 and got.shape == C.shape
    if S is not None:
        assert got is S
    for f in range(2):
        ref = _jax_fused(C[f], None if S0 is None else S0[f], None, dy, dxs)
        np.testing.assert_array_equal(got[f].numpy(), ref)


@pytest.mark.parametrize("form", ["write", "add"])
@pytest.mark.parametrize("dy", [1, -1])
@pytest.mark.parametrize("dxs", [(0, 1, -1), (1, -1)])
def test_fused_adaptive_matches_pallas_interpret(rng, dxs, dy, form):
    """Each direction takes the P2' of its own gradient: the JAX `p2_maps`
    hold one map a direction, built by `_p2_stack`."""
    H, W, D = 7, 10, 40
    C, S0 = _inputs(rng, H, W, D, form)
    imgs = rng.integers(0, 256, (2, H, W), dtype=np.uint8)
    S = None if S0 is None else _t(S0)
    got = kernels.sgm_sweep_fused(_t(C), S, dy, dxs, P1, P2, _t(imgs))
    for f in range(2):
        ref = _jax_fused(C[f], None if S0 is None else S0[f], imgs[f], dy,
                         dxs)
        np.testing.assert_array_equal(got[f].numpy(), ref)


@pytest.mark.parametrize("H,W,D", [(1, 5, 16), (4, 1, 33), (5, 9, 7),
                                   (3, 17, 512)])
@pytest.mark.parametrize("dy", [1, -1])
def test_fused_is_the_sum_of_the_one_direction_sweeps(rng, H, W, D, dy):
    """The write form, `out` and the add form against `sgm_sweep` one
    direction a call, at one row, one column, an odd D and D = 512, with
    P1 = P2."""
    C = _t(rng.integers(0, 256, (2, H, W, D), dtype=np.uint8))
    for p1, p2 in ((P1, P2), (40, 40)):
        ref = None
        for dx in (0, 1, -1):
            ref = kernels.sgm_sweep(C, ref, dy, dx, p1, p2)
        assert torch.equal(kernels.sgm_sweep_fused(C, None, dy, (0, 1, -1),
                                                   p1, p2), ref)
        out = torch.full(C.shape, 7, dtype=torch.int16)
        assert kernels.sgm_sweep_fused(C, None, dy, (-1, 0, 1), p1, p2,
                                       out=out) is out
        assert torch.equal(out, ref)
        S0 = _t(rng.integers(-500, 500, C.shape, dtype=np.int16))
        S = S0.clone()
        kernels.sgm_sweep_fused(C, S, dy, (1, -1, 0), p1, p2)
        assert torch.equal(S, S0 + ref)


def test_plain_sums_wrap_as_int16(rng):
    """Sums past 2^15 wrap, as the kernel's int16 stores do."""
    C = _t(rng.integers(200, 256, (1, 3, 4, 16), dtype=np.uint8))
    S = torch.full(C.shape, 32000, dtype=torch.int16)
    got = sgm_sweep_fused_plain(C, S.clone(), 1, (0, 1, -1), P1, P2)
    L = sum(path_costs(C, 1, dx, P1, P2).to(torch.int32)
            for dx in (0, 1, -1))
    want = ((S.to(torch.int32) + L + 2**15) % 2**16 - 2**15).to(torch.int16)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the compositions that run it
# ---------------------------------------------------------------------------

def _cfg(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("paths,adaptive", [(8, True), (4, True)])
def test_sgm_select_matches_pallas_interpret(rng, paths, adaptive):
    """The 8-path schedule (down and up sets fused, then E) and the 4-path
    one (one direction a launch), with adaptive P2 (the scalar cases are
    `test_torch_sgm_select.py`'s)."""
    H, W, D = 13, 29, 16
    C = rng.integers(0, 25, (H, W, D), dtype=np.uint8)
    img = rng.integers(0, 256, (H, W), dtype=np.uint8)
    jcfg = JConfig(num_disparities=D, paths=paths, p1=7, p2=90,
                   adaptive_p2=adaptive)
    ref = sgm_select_pallas(jnp.asarray(C), jcfg, jnp.asarray(img),
                            interpret=True)
    disp, valid, d_r = kernels.sgm_select(_t(C)[None], _cfg(jcfg),
                                          _t(img)[None])
    np.testing.assert_allclose(disp[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(d_r[0].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("paths,adaptive", [(8, False), (8, True),
                                            (4, False)])
def test_aggregate_volume_matches_pallas_interpret(rng, paths, adaptive):
    H, W, D = 11, 21, 16
    C = rng.integers(0, 25, (H, W, D), dtype=np.uint8)
    img = rng.integers(0, 256, (H, W), dtype=np.uint8)
    jcfg = JConfig(num_disparities=D, paths=paths, p1=7, p2=90,
                   adaptive_p2=adaptive)
    ref = np.asarray(aggregate_pallas(jnp.asarray(C), jcfg, jnp.asarray(img),
                                      interpret=True))
    got = kernels.aggregate_volume(_t(C)[None], _cfg(jcfg), _t(img)[None])
    np.testing.assert_array_equal(got[0].numpy(), ref)


# ---------------------------------------------------------------------------
# refusals and counts
# ---------------------------------------------------------------------------

def test_wrapper_refuses_bad_arguments(rng):
    C = _t(rng.integers(0, 25, (1, 4, 6, 16), dtype=np.uint8))
    S = torch.zeros(C.shape, dtype=torch.int16)
    fused = kernels.sgm_sweep_fused
    for dxs in [(), (0, 0), (2,), (0, 1, -1, 1), (1, 1, -1)]:
        with pytest.raises(ValueError, match="dxs"):
            fused(C, None, 1, dxs, P1, P2)
    for dy in (0, 2, -2):
        with pytest.raises(ValueError, match="dy"):
            fused(C, None, dy, (0,), P1, P2)
    with pytest.raises(ValueError, match="p1"):
        fused(C, None, 1, (0,), 10, 5)
    with pytest.raises(ValueError, match="uint8"):
        fused(C.to(torch.int16), None, 1, (0,), P1, P2)
    with pytest.raises(ValueError, match="uint8"):
        fused(C[0], None, 1, (0,), P1, P2)
    with pytest.raises(ValueError, match="512"):
        fused(torch.zeros((1, 2, 2, 513), dtype=torch.uint8), None, 1, (0,),
              P1, P2)
    with pytest.raises(ValueError, match="int16"):
        fused(C, S[:, :3], 1, (0,), P1, P2)
    with pytest.raises(ValueError, match="int16"):
        fused(C, S.to(torch.int32), 1, (0,), P1, P2)
    with pytest.raises(ValueError, match="write form"):
        fused(C, S, 1, (0,), P1, P2, out=S.clone())
    with pytest.raises(ValueError, match="img|image"):
        fused(C, None, 1, (0,), P1, P2,
              torch.zeros((1, 4, 5), dtype=torch.uint8))
    with pytest.raises(ValueError, match="device"):
        fused(C.to("meta"), None, 1, (0,), P1, P2)


def test_cpu_runs_count_no_launch(rng):
    C = _t(rng.integers(0, 25, (1, 4, 6, 16), dtype=np.uint8))
    kernels.sgm_sweep_fused.builds["add"] += 3
    kernels.sgm_sweep_fused.launches += 2
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["sgm_sweep_fused"] == 0
    S = kernels.sgm_sweep_fused(C, None, 1, (0, 1, -1), P1, P2)
    kernels.sgm_sweep_fused(C, S, -1, (0, 1, -1), P1, P2)
    assert kernels.sgm_sweep_fused.launches == 0
    assert kernels.sgm_sweep_fused.builds == {
        "write": 0, "add": 0, "write_adaptive": 0, "add_adaptive": 0}
