"""The port's fused sweep `kernels.sgm_sweep_fused` on the CPU: the sum over
`dxs` of the path costs of one scan order, against the JAX `sgm_sweep(C,
S_in, dxs, reverse, ...)` in interpret mode (scalar P2, and adaptive P2
with the JAX `p2_maps` from its `_p2_stack`); `sgm_select` and
`aggregate_volume`, which run it on their 8-path routes, against
`sgm_select_pallas` and `aggregate_pallas` in interpret mode; the
wrapper's refusals and launch counts.

The fused carry form (the ring hand-off of the exact strip tiling):
`sgm_sweep_fused(..., carry=, return_carry=True, img_prev=)` against the
JAX `sgm_sweep(..., init_carry=, return_final_carry=True)` with its
(K, N, D) q-form carry, both the output and the carry; chains over
strips against one pass; the refusals.

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
from tpustereo.ops import sgm as jsgm
from tpustereo_torch import kernels
from tpustereo_torch.convert import config_from_jax, sweep_carry_from_jax
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
# the carry form: the ring hand-off between strips
# ---------------------------------------------------------------------------

_BIG = 1 << 24


def _q(rng, shape, top=120):
    """A random q-form carry: each column's minimum over d is 0."""
    q = rng.integers(0, top, shape).astype(np.int32)
    return q - q.min(-1, keepdims=True)


def _jax_fused_carry(C, S0, img, prev, dy, dxs, q):
    """One (T, N, D) frame's fused sweep by the JAX Pallas sweep in
    interpret mode, seeded with the (K, N, D) q carry, padded as the exact
    tiled path pads (lanes past D hold a large value, as the tiling tests'
    one-direction carry does); under adaptive P2 each direction's map over
    the image extended by the carry's row. -> (S real part, the (K, 1, N,
    D) final carry's real columns and lanes)."""
    T, N, Dr = C.shape
    K = len(dxs)
    Np, Dp = _round_up(N, 8), _round_up(Dr, 128)
    pad = ((0, 0), (0, Np - N), (0, Dp - Dr))
    init = np.zeros((K, Np, Dp), np.int32)
    init[:, :, Dr:] = _BIG
    init[:, :N, :Dr] = q
    maps = None
    if img is not None:
        ext = np.concatenate([prev[None], img] if dy > 0
                             else [img, prev[None]])
        jcfg = JConfig(p1=P1, p2=P2, adaptive_p2=True)
        m = np.stack([np.asarray(jsgm.p2_map(jnp.asarray(ext), dy, dx, jcfg))
                      for dx in dxs], -1)
        m = m[1:] if dy > 0 else m[:-1]
        maps = jnp.asarray(np.pad(m, ((0, 0), (0, Np - N), (0, 0))))
    res, fin = j_sgm_sweep(
        jnp.asarray(np.pad(C, pad)),
        None if S0 is None else jnp.asarray(np.pad(S0, pad)), tuple(dxs),
        dy < 0, P1, P2, N, Dr, p2_maps=maps, init_carry=jnp.asarray(init),
        return_final_carry=True, interpret=True)
    fin = np.asarray(fin)
    return (np.asarray(res)[:, :N, :Dr],
            torch.stack([sweep_carry_from_jax(f, N, Dr) for f in fin]))


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("form", ["write", "add"])
@pytest.mark.parametrize("dy", [1, -1])
@pytest.mark.parametrize("dxs", [(0, 1, -1), (1, -1)])
@pytest.mark.parametrize("H,W,D", GEOMETRIES)
def test_fused_carry_matches_pallas_interpret(H, W, D, dxs, dy, form,
                                              adaptive):
    """The output and the (K, B, W, D) final carry, bit for bit, from a
    random q carry (and, under adaptive P2, the carry's image row)."""
    rng = np.random.default_rng([H, len(dxs), dy + 1, form == "add",
                                 adaptive])
    C, S0 = _inputs(rng, H, W, D, form)
    q = _q(rng, (len(dxs), 2, W, D))
    imgs = (rng.integers(0, 256, (2, H, W), dtype=np.uint8) if adaptive
            else None)
    prev = rng.integers(0, 256, (2, W), dtype=np.uint8) if adaptive else None
    S = None if S0 is None else _t(S0)
    got, fin = kernels.sgm_sweep_fused(
        _t(C), S, dy, dxs, P1, P2, None if imgs is None else _t(imgs),
        carry=_t(q), return_carry=True,
        img_prev=None if prev is None else _t(prev))
    assert fin.dtype == torch.int32 and fin.shape == (len(dxs), 2, W, D)
    if S is not None:
        assert got is S
    for f in range(2):
        ref, ref_fin = _jax_fused_carry(
            C[f], None if S0 is None else S0[f],
            None if imgs is None else imgs[f],
            None if prev is None else prev[f], dy, dxs, q[:, f])
        np.testing.assert_array_equal(got[f].numpy(), ref)
        assert torch.equal(fin[:, f], ref_fin[:, 0])


@pytest.mark.parametrize("strips", [2, 3])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("dy", [1, -1])
def test_fused_carry_chain_equals_one_pass(strips, adaptive, dy):
    """The fused sweep over strips of 11 rows, each seeded with the carry
    of the one before it in path order (the later strips' first row's
    image predecessor from img_prev), equals one pass bit for bit, and the
    last strip's carry is the pass's."""
    rng = np.random.default_rng([strips, adaptive, dy + 1])
    B, Hc, Wc, Dc = 2, 11, 9, 16
    C = _t(rng.integers(0, 40, (B, Hc, Wc, Dc), dtype=np.uint8))
    img = (_t(rng.integers(0, 256, (B, Hc, Wc), dtype=np.uint8)) if adaptive
           else None)
    dxs = (0, 1, -1)
    ref, ref_fin = kernels.sgm_sweep_fused(C, None, dy, dxs, P1, P2, img,
                                           return_carry=True)
    cuts = np.array_split(np.arange(Hc), strips)
    parts, carry = {}, None
    for rows in cuts if dy > 0 else cuts[::-1]:
        r0, r1 = int(rows[0]), int(rows[-1]) + 1
        prev = None
        if img is not None and carry is not None:
            prev = img[:, r0 - 1 if dy > 0 else r1].contiguous()
        parts[r0], carry = kernels.sgm_sweep_fused(
            C[:, r0:r1].contiguous(), None, dy, dxs, P1, P2,
            None if img is None else img[:, r0:r1].contiguous(),
            carry=carry, return_carry=True, img_prev=prev)
    got = torch.cat([parts[k] for k in sorted(parts)], 1)
    assert torch.equal(got, ref)
    assert torch.equal(carry, ref_fin)


def test_fused_carry_is_the_one_direction_carries(rng):
    """Each slab of the fused carry is its direction's `sgm_sweep` carry,
    in `dxs` order; a zero carry is a fresh start."""
    C = _t(rng.integers(0, 40, (2, 5, 7, 16), dtype=np.uint8))
    q = _t(_q(rng, (3, 2, 7, 16)))
    for dy in (1, -1):
        dxs = (1, -1, 0)
        got, fin = kernels.sgm_sweep_fused(C, None, dy, dxs, P1, P2,
                                           carry=q, return_carry=True)
        ref = None
        for k, dx in enumerate(dxs):
            ref, f = kernels.sgm_sweep(C, ref, dy, dx, P1, P2, carry=q[k],
                                       return_carry=True)
            assert torch.equal(fin[k], f)
        assert torch.equal(got, ref)
        zero = torch.zeros_like(q)
        assert torch.equal(
            kernels.sgm_sweep_fused(C, None, dy, dxs, P1, P2, carry=zero),
            kernels.sgm_sweep_fused(C, None, dy, dxs, P1, P2))


def test_fused_carry_refusals(rng):
    C = _t(rng.integers(0, 25, (2, 4, 6, 16), dtype=np.uint8))
    img = torch.zeros((2, 4, 6), dtype=torch.uint8)
    q = torch.zeros((3, 2, 6, 16), dtype=torch.int32)
    fused = kernels.sgm_sweep_fused
    for bad in (q[:2], q[:, :1], q[:, :, :5], q[..., :15], q[0],
                q.to(torch.int16), q.to(torch.int64)):
        with pytest.raises(ValueError, match="carry must be"):
            fused(C, None, 1, (0, 1, -1), P1, P2, carry=bad)
    with pytest.raises(ValueError, match="carry must be"):
        fused(C, None, 1, (0, 1), P1, P2, carry=q)
    with pytest.raises(ValueError, match="device"):
        fused(C, None, 1, (0, 1, -1), P1, P2, carry=q.to("meta"))
    with pytest.raises(ValueError, match="needs img_prev"):
        fused(C, None, 1, (0, 1, -1), P1, P2, img, carry=q)
    with pytest.raises(ValueError, match="img_prev goes with"):
        fused(C, None, 1, (0, 1, -1), P1, P2, carry=q, img_prev=img[:, 0])
    with pytest.raises(ValueError, match="img_prev goes with"):
        fused(C, None, 1, (0, 1, -1), P1, P2, img, img_prev=img[:, 0])
    with pytest.raises(ValueError, match="img_prev must be"):
        fused(C, None, 1, (0, 1, -1), P1, P2, img, carry=q,
              img_prev=img[:, 0, :5])


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
    kernels.sgm_sweep_fused(C, None, 1, (0, 1, -1), P1, P2,
                            return_carry=True)
    assert kernels.sgm_sweep_fused.launches == 0
    assert kernels.sgm_sweep_fused.builds == {
        "write": 0, "add": 0, "write_adaptive": 0, "add_adaptive": 0}
    assert kernels.sgm_sweep_fused.carry_forms == {
        "write": 0, "add": 0, "write_adaptive": 0, "add_adaptive": 0}


@pytest.mark.parametrize("D", [16, 128, 256, 512])
def test_vertical_orders(D):
    """8 paths: the down and up sets, each one fused launch up to
    `FUSED_MAX_D`, one direction a launch past it; 4 paths: S and N."""
    from tpustereo_torch.kernels.sgm import FUSED_MAX_D, vertical_orders
    orders = vertical_orders(8, D)
    if D <= FUSED_MAX_D:
        assert orders == ((1, (0, 1, -1)), (-1, (0, 1, -1)))
    else:
        assert orders == tuple((dy, (dx,)) for dy in (1, -1)
                               for dx in (0, 1, -1))
    assert vertical_orders(4, D) == ((1, (0,)), (-1, (0,)))
