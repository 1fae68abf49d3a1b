"""The port's strip tiling on the CPU: the ring carry of the sweeps and the
tiled pipelines (`tpustereo_torch.dist`), against the JAX package.

* The plain `ops.sgm._sweep` against the JAX jnp `_sweep`, with and
  without `init_carry` (raw L carries).
* `kernels.sgm.sgm_sweep_plain` with a q-form carry against the JAX Pallas
  `sgm_sweep(..., init_carry=, return_final_carry=True)` in interpret
  mode, padded as `_sgbm_strip_exact_fused` pads (N to 8, D to 128); the
  JAX carry's real columns and lanes through `convert.sweep_carry_from_jax`.
* Carry chains over strips against one untiled sweep.
* `dist.sgbm_tiled` / `sgbm_tiled_batched` against the JAX `sgbm_tiled` /
  `sgbm_tiled_batched` on `make_mesh(1, strips)` of the forced host
  devices (`tests/conftest.py`), `backend="jnp"` and once `"pallas"` in
  interpret mode, in halo and exact mode; exact mode against the port's
  untiled `sgbm`; halo mode's mismatch against it falling with the halo.
* `dist.make_mesh`.

Inputs are made from seeds with numpy and handed to both packages; the JAX
references are shared through module-scoped fixtures.

Tolerance: integer outputs (path costs, carries, the invalid pattern)
bit-exact; float disparity within 1e-5, the JAX `tests/test_dist.py` bar.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustereo.config import PRESETS as JPRESETS
from tpustereo.config import Config as JConfig
from tpustereo.dist import make_mesh as j_make_mesh
from tpustereo.dist import sgbm_tiled as j_sgbm_tiled
from tpustereo.dist import sgbm_tiled_batched as j_sgbm_tiled_batched
from tpustereo.kernels.sgm_pallas import sgm_sweep as j_sgm_sweep
from tpustereo.ops import sgm as jsgm
from tpustereo_torch import dist, kernels
from tpustereo_torch.convert import config_from_jax, sweep_carry_from_jax
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.dist.tiling import _pad_rows, _zero_oob_rows
from tpustereo_torch.kernels.sgm import sgm_sweep_plain
from tpustereo_torch.ops import sgm as tsgm
from tpustereo_torch.pipeline import sgbm

P1, P2 = 7, 90
YDIRS = [(1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)]
_BIG = 1 << 24
H, W, D = 48, 64, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


def _same(got, ref, atol=1e-5):
    np.testing.assert_array_equal(got == -1.0, ref == -1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _q(rng, shape, top=120):
    """A random q-form carry: each column's minimum over d is 0."""
    q = rng.integers(0, top, shape).astype(np.int32)
    return q - q.min(-1, keepdims=True)


# --- the plain sweep's raw-L carry against the JAX jnp sweep ---------------

@pytest.mark.parametrize("dx", [0, 1, -1])
@pytest.mark.parametrize("seeded", [False, True])
def test_sweep_carry_matches_jax(dx, seeded):
    rng = np.random.default_rng(10 + dx)
    T, N = 7, 9
    C = rng.integers(0, 60, (T, N, D)).astype(np.int32)
    p2m = rng.integers(P1 + 1, P2, (T, N)).astype(np.int32)
    init = rng.integers(0, 400, (N, D)).astype(np.int32) if seeded else None
    ref, rcarry = jsgm._sweep(jnp.asarray(C), jnp.asarray(p2m), P1, dx,
                              None if init is None else jnp.asarray(init),
                              return_carry=True)
    got, carry = tsgm._sweep(_t(C), _t(p2m), P1, dx,
                             None if init is None else _t(init),
                             return_carry=True)
    assert got.dtype == torch.int16 and carry.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(rcarry))
    assert torch.equal(tsgm._sweep(_t(C), _t(p2m), P1, dx,
                                   None if init is None else _t(init)), got)


@pytest.mark.parametrize("direction", list(tsgm.DIRS_8))
@pytest.mark.parametrize("adaptive", [False, True])
def test_aggregate_path_carry_matches_jax(direction, adaptive):
    """`aggregate_path(..., init_carry=, return_carry=True)` against the JAX
    `aggregate_path`: the path costs and the raw-L carry of the last
    scanned line, (H, D) for the horizontal paths, (W, D) for the others."""
    dy, dx = direction
    rng = np.random.default_rng([tsgm.DIRS_8.index(direction), adaptive])
    Hc, Wc = 6, 9
    C = rng.integers(0, 60, (Hc, Wc, D)).astype(np.int32)
    img = rng.integers(0, 256, (Hc, Wc), dtype=np.uint8)
    init = rng.integers(0, 400, (Hc if dy == 0 else Wc, D)).astype(np.int32)
    jcfg = JConfig(p1=P1, p2=P2, adaptive_p2=adaptive, num_disparities=D)
    ref, rcarry = jsgm.aggregate_path(jnp.asarray(C), dy, dx, jcfg,
                                      jnp.asarray(img), jnp.asarray(init),
                                      return_carry=True)
    got, carry = tsgm.aggregate_path(_t(C), dy, dx, _cfg(jcfg), _t(img),
                                     _t(init), return_carry=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(rcarry))


# --- the q-form carry of sgm_sweep_plain against the Pallas sweep ----------

def _jax_sweep_carry(C, S, dy, dx, q, p2m):
    """One (T, N, D) frame's sweep of direction (dy, dx) by the JAX Pallas
    sweep in interpret mode, seeded with the q carry (N, D), padded as the
    exact tiled path pads: -> (S real part, fin (N_pad, D_pad))."""
    T, N, Dr = C.shape
    Np, Dp = _round_up(N, 8), _round_up(Dr, 128)
    pad = ((0, 0), (0, Np - N), (0, Dp - Dr))
    init = np.zeros((1, Np, Dp), np.int32)
    init[0, :, Dr:] = _BIG     # lanes past D never win a min
    init[0, :N, :Dr] = q
    maps = None
    if p2m is not None:
        maps = jnp.asarray(np.pad(p2m, ((0, 0), (0, Np - N)))[..., None])
    res, fin = j_sgm_sweep(
        jnp.asarray(np.pad(C, pad)),
        None if S is None else jnp.asarray(np.pad(S, pad)), (dx,), dy < 0,
        P1, P2, N, Dr, p2_maps=maps, init_carry=jnp.asarray(init),
        return_final_carry=True, interpret=True)
    return np.asarray(res)[:, :N, :Dr], np.asarray(fin)[0]


@pytest.mark.parametrize("direction", YDIRS)
@pytest.mark.parametrize("form", ["write", "add"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_sweep_plain_carry_matches_pallas(direction, form, adaptive):
    dy, dx = direction
    rng = np.random.default_rng(
        [YDIRS.index(direction), form == "add", adaptive])
    T, N = 5, 11
    C = rng.integers(0, 25, (T, N, D), dtype=np.uint8)
    S0 = (rng.integers(-300, 300, C.shape).astype(np.int16)
          if form == "add" else None)
    q = _q(rng, (N, D))
    img = rng.integers(0, 256, (T, N), dtype=np.uint8) if adaptive else None
    prev = rng.integers(0, 256, (N,), dtype=np.uint8) if adaptive else None
    p2m = None
    if adaptive:   # the JAX map over the image with the carry's row
        ext = np.concatenate([prev[None], img] if dy > 0
                             else [img, prev[None]])
        m = np.asarray(jsgm.p2_map(jnp.asarray(ext), dy, dx,
                                   JConfig(p1=P1, p2=P2, adaptive_p2=True)))
        p2m = m[1:] if dy > 0 else m[:-1]
    ref, fin = _jax_sweep_carry(C, S0, dy, dx, q, p2m)
    got, carry = sgm_sweep_plain(
        _t(C)[None], None if S0 is None else _t(S0)[None], dy, dx, P1, P2,
        None if img is None else _t(img)[None], carry=_t(q)[None],
        return_carry=True, img_prev=None if prev is None else _t(prev)[None])
    np.testing.assert_array_equal(got[0].numpy(), ref)
    assert torch.equal(carry, sweep_carry_from_jax(fin, N, D))


def test_zero_carry_is_a_fresh_start(rng):
    C = torch.from_numpy(rng.integers(0, 25, (2, 6, 9, D), dtype=np.uint8))
    zero = torch.zeros((2, 9, D), dtype=torch.int32)
    for dy, dx in YDIRS:
        assert torch.equal(kernels.sgm_sweep(C, None, dy, dx, P1, P2,
                                             carry=zero),
                           kernels.sgm_sweep(C, None, dy, dx, P1, P2))


def test_sweep_write_form_into_out(rng):
    """The write form into a given volume (each strip's first sweep of the
    exact ring writes into its slice of one S)."""
    C = torch.from_numpy(rng.integers(0, 25, (2, 6, 9, D), dtype=np.uint8))
    out = torch.full(C.shape, 77, dtype=torch.int16)
    got = kernels.sgm_sweep(C, None, 1, 1, P1, P2, out=out)
    assert got is out
    assert torch.equal(out, kernels.sgm_sweep(C, None, 1, 1, P1, P2))
    with pytest.raises(ValueError, match="write form"):
        kernels.sgm_sweep(C, out, 1, 1, P1, P2, out=out)


@pytest.mark.parametrize("strips", [2, 3])
@pytest.mark.parametrize("adaptive", [False, True])
def test_sweep_carry_chain_equals_untiled(strips, adaptive):
    """The sweep over strips of 11 rows, each seeded with the carry of the
    one before it in path order, equals one untiled sweep bit for bit, and
    the last strip's carry is the untiled sweep's."""
    rng = np.random.default_rng(strips)
    B, Hc, Wc = 2, 11, 9
    C = _t(rng.integers(0, 40, (B, Hc, Wc, D), dtype=np.uint8))
    img = _t(rng.integers(0, 256, (B, Hc, Wc), dtype=np.uint8))
    cuts = np.array_split(np.arange(Hc), strips)
    for dy, dx in YDIRS:
        im = img if adaptive else None
        ref, ref_fin = kernels.sgm_sweep(C, None, dy, dx, P1, P2, im,
                                         return_carry=True)
        order = cuts if dy > 0 else cuts[::-1]
        parts, carry = {}, None
        for rows in order:
            r0, r1 = int(rows[0]), int(rows[-1]) + 1
            prev = None
            if adaptive and carry is not None:
                prev = img[:, r0 - 1 if dy > 0 else r1].contiguous()
            parts[r0], carry = kernels.sgm_sweep(
                C[:, r0:r1].contiguous(), None, dy, dx, P1, P2,
                None if im is None else im[:, r0:r1].contiguous(),
                carry=carry, return_carry=True, img_prev=prev)
        got = torch.cat([parts[k] for k in sorted(parts)], 1)
        assert torch.equal(got, ref), (dy, dx)
        assert torch.equal(carry, ref_fin), (dy, dx)


def test_sweep_carry_refusals(rng):
    C = torch.from_numpy(rng.integers(0, 25, (1, 4, 6, D), dtype=np.uint8))
    img = torch.zeros((1, 4, 6), dtype=torch.uint8)
    q = torch.zeros((1, 6, D), dtype=torch.int32)
    with pytest.raises(ValueError, match="along y"):
        kernels.sgm_sweep(C, None, 0, 1, P1, P2, carry=q)
    with pytest.raises(ValueError, match="carry must be"):
        kernels.sgm_sweep(C, None, 1, 0, P1, P2, carry=q[:, :5])
    with pytest.raises(ValueError, match="needs img_prev"):
        kernels.sgm_sweep(C, None, 1, 0, P1, P2, img, carry=q)
    with pytest.raises(ValueError, match="img_prev goes with"):
        kernels.sgm_sweep(C, None, 1, 0, P1, P2, carry=q,
                          img_prev=img[:, 0])


# --- the tiled pipelines ----------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    L, R, _, _ = synthetic_pair((H, W), disparity=6.0, slope=0.05, seed=7)
    return L, R


@pytest.fixture(scope="module")
def pair45():
    L, R, _, _ = synthetic_pair((45, W), disparity=6.0, slope=0.05, seed=3)
    return L, R


def _both(L, R, jcfg, strips):
    """(the port's sgbm_tiled on the CPU, the JAX sgbm_tiled) on one
    pair."""
    ref = np.asarray(j_sgbm_tiled(jnp.asarray(L), jnp.asarray(R), jcfg,
                                  j_make_mesh(1, strips)))
    got = dist.sgbm_tiled(_t(L), _t(R), _cfg(jcfg),
                          dist.make_mesh(1, strips, device="cpu")).numpy()
    return got, ref


def _base(**kw):
    return JConfig(**{"num_disparities": D, "speckle_window_size": 20,
                      "backend": "jnp", **kw})


CASES = {
    # halo mode, the halo inside the 24-row strips
    "halo12": (_base(paths=8, halo=12), 2),
    "halo_adaptive": (_base(paths=4, halo=12, adaptive_p2=True), 2),
    "halo_min_disp": (_base(paths=8, halo=12, min_disparity=3), 2),
    "exact_adaptive": (_base(paths=4, exact_tiling=True, adaptive_p2=True), 4),
    # the fused carry form of the down and up sets, adaptive P2 (img_prev)
    "exact8_adaptive": (_base(paths=8, exact_tiling=True, adaptive_p2=True),
                        4),
    "exact_hirschmuller": (_base(paths=8, exact_tiling=True,
                                 fill_mode="hirschmuller"), 4),
    "halo_hirschmuller": (_base(paths=8, halo=12, fill_mode="hirschmuller",
                                min_disparity=2), 2),
    "sad": (JConfig(mode="sad", num_disparities=D, disp12_max_diff=-1,
                    speckle_window_size=0, median_filter=False,
                    backend="jnp"), 4),
    "census_wta": (JConfig(mode="census_wta", num_disparities=D,
                           disp12_max_diff=-1, speckle_window_size=0,
                           median_filter=False, backend="jnp"), 4),
    "census_wta_hirschmuller": (JConfig(mode="census_wta", num_disparities=D,
                                        fill_mode="hirschmuller",
                                        backend="jnp"), 2),
    # past the fused bound: the volume route, halo and exact
    "volume_halo": (_base(paths=4, halo=12, p2=1000), 2),
    "volume_exact": (_base(paths=4, exact_tiling=True, p2=1000), 2),
}


@pytest.mark.parametrize("name", CASES)
def test_tiled_matches_jax(pair, name):
    jcfg, strips = CASES[name]
    _same(*_both(*pair, jcfg, strips))


@pytest.mark.parametrize("strips", [2, 4])
def test_tiled_exact_matches_jax_and_untiled(pair45, strips):
    """Exact mode at H = 45, not divisible by the strips: equal to the JAX
    tiled output and to the untiled pipeline, bit for bit."""
    L, R = pair45
    jcfg = _base(paths=8, exact_tiling=True)
    got, ref = _both(L, R, jcfg, strips)
    _same(got, ref)
    untiled = sgbm(_t(L), _t(R), _cfg(jcfg)).numpy()
    np.testing.assert_array_equal(got, untiled)


def test_tiled_exact_matches_pallas_ring(pair):
    """The JAX exact ring on its Pallas q-carry sweeps (interpret mode)."""
    _same(*_both(*pair, _base(paths=8, exact_tiling=True,
                              backend="pallas"), 2))


@pytest.mark.parametrize("paths,strips,d", [(8, 2, D), (8, 3, D), (4, 2, D),
                                            (8, 2, 264)])
def test_exact_ring_launches_a_scan_order_a_strip(monkeypatch, pair, paths,
                                                  strips, d):
    """With 8 paths the ring runs the fused carry form once a scan order a
    strip (the down set, then the up set: 2 * strips calls, a (3, F, W, D)
    carry across each boundary); with 4 paths, and with 8 past
    `FUSED_MAX_D` (`vertical_orders`), the one-direction carry form once a
    direction a strip. The output stays the untiled one."""
    from tpustereo_torch.kernels import sgm as ksgm
    from tpustereo_torch.kernels.sgm import vertical_orders
    calls = {"fused": [], "one": []}

    def counted(fn, key):
        def wrapper(*args, **kw):
            if "carry" in kw:
                carry = kw["carry"]
                calls[key].append((args[2], args[3], None if carry is None
                                   else tuple(carry.shape),
                                   kw["return_carry"]))
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(ksgm, "sgm_sweep_fused",
                        counted(ksgm.sgm_sweep_fused, "fused"))
    monkeypatch.setattr(ksgm, "sgm_sweep", counted(ksgm.sgm_sweep, "one"))
    L, R = pair
    cfg = _cfg(_base(paths=paths, exact_tiling=True, num_disparities=d))
    got = dist.sgbm_tiled(_t(L), _t(R), cfg,
                          dist.make_mesh(1, strips, device="cpu")).numpy()
    np.testing.assert_array_equal(got, sgbm(_t(L), _t(R), cfg).numpy())
    orders = vertical_orders(paths, d)
    fused = len(orders[0][1]) > 1
    assert fused == (paths == 8 and d == D)
    ring = calls["fused"] if fused else calls["one"]
    assert not (calls["one"] if fused else calls["fused"])
    assert len(ring) == len(orders) * strips   # one call a strip an order
    shape = (3, 1, W, d) if fused else (1, W, d)
    for o, (dy, dxs) in enumerate(orders):
        seq = ring[o * strips:(o + 1) * strips]
        assert [c[0] for c in seq] == [dy] * strips
        assert [c[1] for c in seq] == [dxs if fused else dxs[0]] * strips
        assert [c[2] for c in seq] == [None] + [shape] * (strips - 1)
        assert [c[3] for c in seq] == [True] * (strips - 1) + [False]


def test_halo_clamp_warns_in_both(pair):
    """halo 32 over 24-row strips is clamped, with the same warning."""
    L, R = pair
    jcfg = _base(paths=8, halo=32)
    with pytest.warns(UserWarning, match="halo 32 clamped to strip height "
                                         "24"):
        ref = np.asarray(j_sgbm_tiled(jnp.asarray(L), jnp.asarray(R), jcfg,
                                      j_make_mesh(1, 2)))
    with pytest.warns(UserWarning, match="halo 32 clamped to strip height "
                                         "24"):
        got = dist.sgbm_tiled(_t(L), _t(R), _cfg(jcfg),
                              dist.make_mesh(1, 2, device="cpu")).numpy()
    _same(got, ref)


def test_halo32_unclamped_over_tall_strips_matches_jax():
    """The shipped halo, 32, unclamped: 150 rows over 2 strips pad to 160
    (80-row strips, 10 padded rows), so every strip's halo is 32 real or
    edge-replicated rows, as at KITTI odometry size."""
    L, R, _, _ = synthetic_pair((150, W), disparity=6.0, slope=0.05, seed=5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # no clamp
        got, ref = _both(L, R, _base(paths=8, halo=32), 2)
    _same(got, ref)


def test_tiled_batched_matches_jax(pair):
    L, R = pair
    lefts, rights = np.stack([L, L[::-1]]), np.stack([R, R[::-1]])
    jcfg = _base(paths=4, exact_tiling=True)
    ref = np.asarray(j_sgbm_tiled_batched(jnp.asarray(lefts),
                                          jnp.asarray(rights), jcfg,
                                          j_make_mesh(2, 2)))
    got = dist.sgbm_tiled_batched(_t(lefts), _t(rights), _cfg(jcfg),
                                  dist.make_mesh(2, 2, device="cpu"))
    assert got.shape == (2, H, W)
    _same(got.numpy(), ref)
    with pytest.raises(ValueError, match="data axis"):
        dist.sgbm_tiled_batched(_t(lefts[:1]), _t(rights[:1]), _cfg(jcfg),
                                dist.make_mesh(2, 2, device="cpu"))


def test_halo_mismatch_falls_with_the_halo(pair):
    """The port's halo mode against its untiled pipeline: the mismatch
    drops from halo 2 to 12 and is small at 12, the JAX test's bars."""
    L, R = pair
    cfg = _cfg(_base(paths=8))
    ref = sgbm(_t(L), _t(R), cfg).numpy()
    mesh = dist.make_mesh(1, 2, device="cpu")
    mismatch = {}
    for halo in (2, 12):
        out = dist.sgbm_tiled(_t(L), _t(R), cfg.replace(halo=halo),
                              mesh).numpy()
        both = (ref >= 0) & (out >= 0)
        mismatch[halo] = float((np.abs(ref - out)[both] > 0.5).mean()
                               + ((ref >= 0) != (out >= 0)).mean())
    assert mismatch[12] <= mismatch[2] + 1e-9
    assert mismatch[12] < 0.03, mismatch


def test_kitti_odometry_preset_tiles_as_shipped(pair):
    """PRESETS["kitti_odometry"] unmodified but for D: halo mode, 2 strips,
    halo 32 (clamped here), through match_pair_tiled on the CPU."""
    from tpustereo_torch import PRESETS, api
    L, R = pair
    cfg = PRESETS["kitti_odometry"].replace(num_disparities=D)
    assert (cfg.strips, cfg.halo, cfg.exact_tiling) == (2, 32, False)
    jcfg = JPRESETS["kitti_odometry"].replace(num_disparities=D,
                                              backend="jnp")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = api.match_pair_tiled(L, R, cfg, device="cpu")
        ref = np.asarray(j_sgbm_tiled(jnp.asarray(L), jnp.asarray(R), jcfg,
                                      j_make_mesh(1, 2)))
    _same(got, ref)


# --- pieces -----------------------------------------------------------------

def test_pad_rows_and_zeroed_rows_follow_jax():
    """376 rows over 2 strips pad to 384 (192-row strips), by edge
    replication; the zeroed cost rows are the halos outside the image and
    the bottom padding."""
    x = torch.arange(376 * 3, dtype=torch.int32).reshape(376, 3)
    p = _pad_rows(x, 2)
    assert p.shape == (384, 3) and torch.equal(p[376:], x[-1:].expand(8, 3))
    assert _pad_rows(x[:368], 2).shape == (368, 3)
    C = torch.ones((2, 1, 192 + 2 * 5, 2, 1), dtype=torch.uint8)
    _zero_oob_rows(C, 5, 192, 376)
    zero = (C[:, 0, :, 0, 0] == 0).numpy()
    g = np.arange(2)[:, None] * 192 - 5 + np.arange(202)[None]
    np.testing.assert_array_equal(zero, (g < 0) | (g >= 376))


def test_halo_exchange_replicates_the_edges():
    x = torch.arange(2 * 4 * 3).reshape(2, 4, 3)
    e = dist.halo_exchange(x, 2)
    assert e.shape == (2, 8, 3)
    assert torch.equal(e[0, :2], x[0, :1].expand(2, 3))
    assert torch.equal(e[0, 6:], x[1, :2])
    assert torch.equal(e[1, :2], x[0, 2:])
    assert torch.equal(e[1, 6:], x[1, 3:].expand(2, 3))


def test_make_mesh():
    m = dist.make_mesh(2, 4, device="cpu")
    assert m.shape == {"data": 2, "strip": 4}
    assert m.device == torch.device("cpu")
    assert dist.make_mesh(1, 2, devices=["cpu"] * 3).shape == {"data": 1,
                                                               "strip": 2}
    with pytest.raises(ValueError, match="need 4 devices"):
        dist.make_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(NotImplementedError, match="several cards"):
        dist.make_mesh(1, 2, devices=["cpu", "meta"])
    dist.init_distributed(num_processes=1)
    # several processes initialise torch.distributed (held in
    # test_torch_dist_multirank.py); a rank outside the world is refused
    # before any connection is tried
    with pytest.raises(ValueError, match="process_id"):
        dist.init_distributed("localhost:1234", 2, 2)
