"""The port's data-width micro-benchmarks (kernel 13) on the CPU: each plain
version against the JAX function in interpret mode, bit for bit, in every
mode and dtype, on inputs made from a seed with numpy; the equivalences of
`tests/test_width_micro.py` on the port; the sentinel the port's
`sgm_step` uses; and the wrappers' contract.

Tolerance: bit-exact everywhere (integer results, and bf16 results that
both packages round after every operation).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustereo.kernels import width_micro as jwm
from tpustereo_torch import kernels

wm = importlib.import_module("tpustereo_torch.kernels.width_micro")

SGM_BIG = 1 << 24   # `csrc/common.cuh`'s sentinel for d = -1 and d = D


def _rng(seed):
    return np.random.default_rng(seed)


def _jax(fn, x, *args, **kw):
    return np.asarray(fn(jnp.asarray(x), *args, interpret=True, **kw))


def _bf16(a):
    """A float32 array's values as (jax bf16, torch bf16), both from one
    numpy array, so the two packages start from the same bits."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# sweep_micro
# ---------------------------------------------------------------------------

def _costs(seed, shape, top, dtype):
    return _rng(seed).integers(0, top, shape).astype(dtype)


@pytest.mark.parametrize("p1,p2", [(10, 120), (7, 90), (3, 1000)])
@pytest.mark.parametrize("mode,top", [("v32", 1 << 14), ("v32", 25),
                                      ("v32_i8", 128), ("swar_i8", 128),
                                      ("bf16_i8", 25), ("bf16_i8", 128)])
def test_sweep_plain_matches_jax_interpret(mode, top, p1, p2):
    """p2 = 1000 takes bf16 past 256, where it rounds: the plain version
    rounds where the JAX step does."""
    dtype = np.int8 if mode in wm.I8_MODES else np.int32
    C = _costs(1, (12, 16, 128), top, dtype)
    ref = _jax(jwm.sweep_micro, C, mode, p1, p2)
    got = wm.sweep_micro_plain(torch.from_numpy(C), mode, p1, p2)
    assert got.dtype == (torch.int16 if mode in wm.I8_MODES else torch.int32)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("p1,p2", [(10, 120), (3, 1000)])
def test_sweep_plain_matches_jax_interpret_swar(p1, p2):
    C = _costs(2, (12, 16, 128), 1 << 14, np.int32)
    P = np.asarray(jwm.pack_rows(jnp.asarray(C)))
    ref = _jax(jwm.sweep_micro, P, "swar", p1, p2)
    Pt = wm.pack_rows(torch.from_numpy(C))
    np.testing.assert_array_equal(Pt.numpy(), P)
    got = wm.sweep_micro_plain(Pt, "swar", p1, p2)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(wm.unpack_rows(got).numpy(),
                                  np.asarray(jwm.unpack_rows(jnp.asarray(ref))))


@pytest.mark.parametrize("mode,N", [("v32", 9), ("v32_i8", 9), ("bf16_i8", 10),
                                    ("swar", 9)])
def test_sweep_plain_odd_rows_match_jax(mode, N):
    """Rows are independent, so N that the JAX kernel's (8, 128) tiling
    refuses is held against the JAX function on rows padded to 16."""
    dtype = np.int8 if mode in wm.I8_MODES else np.int32
    top = 1 << 30 if mode == "swar" else 100
    C = _costs(3, (7, N, 128), top, dtype)
    if mode == "swar":
        C &= 0x3FFF3FFF
    pad = np.zeros((7, 16, 128), dtype)
    pad[:, :N] = C
    ref = _jax(jwm.sweep_micro, pad, mode)[:, :N]
    np.testing.assert_array_equal(
        wm.sweep_micro_plain(torch.from_numpy(C), mode).numpy(), ref)


@pytest.mark.parametrize("N", [18, 16])
def test_swar_i8_pairs_halves_like_v32_i8(N):
    """swar_i8 packs rows (n, n + N/2), first half high; unpacked, it is
    v32_i8 row for row (N/2 odd included, which the JAX kernel's tiling
    refuses)."""
    C = _costs(4, (9, N, 128), 128, np.int8)
    pad = np.zeros((9, 32, 128), np.int8)
    pad[:, :N] = C
    ref = _jax(jwm.sweep_micro, pad, "v32_i8")[:, :N]
    got = wm.sweep_micro_plain(torch.from_numpy(C), "swar_i8")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_port_swar_matches_v32():
    C = torch.from_numpy(_costs(5, (12, 16, 128), 25, np.int32))
    L32 = wm.sweep_micro(C, "v32")
    Ls = wm.unpack_rows(wm.sweep_micro(wm.pack_rows(C), "swar"))
    assert torch.equal(L32, Ls)


@pytest.mark.parametrize("c_max", [25, 63])
def test_port_bf16_and_swar_i8_match_v32_i8(c_max):
    """Exact while every value is an integer <= 256 (bf16) and below 2^15
    (the packed fields)."""
    C = torch.from_numpy(_costs(6, (12, 16, 128), c_max, np.int8))
    a = wm.sweep_micro(C, "v32_i8")
    assert torch.equal(a, wm.sweep_micro(C, "bf16_i8"))
    assert torch.equal(a, wm.sweep_micro(C, "swar_i8"))


@pytest.mark.parametrize("mode,top", [("v32", 1 << 14), ("v32_i8", 128)])
@pytest.mark.parametrize("p1,p2", [(10, 120), (0, 0x3FFE)])
def test_sgm_step_sentinel_gives_the_same_L(monkeypatch, mode, top, p1, p2):
    """The JAX step masks d = -1 and d = D with 0x4000, the port's
    `sgm_step` with 2^24: L is the same, since p2 < 0x4000 <= mask + p1
    keeps a masked neighbour from ever winning the min."""
    dtype = np.int8 if mode in wm.I8_MODES else np.int32
    C = _costs(7, (12, 16, 128), top, dtype)
    ref = _jax(jwm.sweep_micro, C, mode, p1, p2)
    monkeypatch.setattr(wm, "BIG16", SGM_BIG)
    got = wm.sweep_micro_plain(torch.from_numpy(C), mode, p1, p2)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# the chains
# ---------------------------------------------------------------------------

def _slab(seed, shape, lo=0, hi=200):
    return _rng(seed).integers(lo, hi, shape).astype(np.float32)


def _pair(a, dtype):
    """(jax array, torch tensor) of the float32 values a in `dtype`."""
    if dtype == "bfloat16":
        return _bf16(a)
    return jnp.asarray(a.astype(dtype)), torch.from_numpy(a.astype(dtype))


@pytest.mark.parametrize("shape", [(8, 128), (64, 128), (13, 40)])
@pytest.mark.parametrize("dtype", ["int32", "int16", "bfloat16"])
@pytest.mark.parametrize("chain", [32, 100])
def test_elem_chain_plain_matches_jax_interpret(shape, dtype, chain):
    jx, tx = _pair(_slab(8, shape, 0, 400), dtype)
    ref = np.asarray(jwm.elem_chain_micro(jx, chain, interpret=True))
    got = wm.elem_chain_micro_plain(tx, chain)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got), ref.astype(_np(got).dtype))


def test_elem_chain_int16_wraps_like_jax():
    a = _slab(9, (8, 128), -32768, 32768)
    a[0, :4] = (32767, 32766, -1, -32768)
    jx, tx = _pair(a, "int16")
    ref = np.asarray(jwm.elem_chain_micro(jx, 40, interpret=True))
    np.testing.assert_array_equal(wm.elem_chain_micro_plain(tx, 40).numpy(),
                                  ref)


@pytest.mark.parametrize("shape", [(8, 128), (64, 128), (13, 40)])
@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16", "int16"])
@pytest.mark.parametrize("chain", [32, 100])
def test_reg_chain_plain_matches_jax_interpret(shape, dtype, chain):
    jx, tx = _pair(_slab(10, shape), dtype)
    ref = np.asarray(jwm.reg_chain_micro(jx, chain, interpret=True))
    got = wm.reg_chain_micro_plain(tx, chain)
    np.testing.assert_array_equal(_np(got), ref.astype(_np(got).dtype))


def test_reg_chain_bf16_rounds():
    """bf16 rounds where int32 does not (356 against 357 in the JAX
    package's interpret run)."""
    x = torch.full((8, 128), 100, dtype=torch.int32)
    a = wm.reg_chain_micro(x, 128)
    b = wm.reg_chain_micro(x.bfloat16(), 128)
    assert not torch.equal(a, b.int())


@pytest.mark.parametrize("shape", [(8, 128), (40, 128), (9, 37), (64, 33),
                                   (2100, 3), (4100, 2)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("chain", [4, 33])
def test_roll_chain_plain_matches_jax_interpret(shape, axis, chain):
    """Lines past 2048 values too (axis 0 of (2100, 3) and (4100, 2)), which
    the JAX function takes."""
    x = _rng(11).integers(0, 1000, shape).astype(np.int32)
    ref = _jax(jwm.roll_chain_micro, x, chain, axis=axis)
    got = wm.roll_chain_micro_plain(torch.from_numpy(x), chain, axis)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("axis", [0, 1])
def test_roll_chain_is_a_roll_by_six(axis):
    x = torch.from_numpy(_rng(12).integers(0, 1000, (8, 128)).astype(
        np.int32))
    assert torch.equal(wm.roll_chain_micro(x, 4, axis=axis),
                       torch.roll(x, 6, dims=axis))


@pytest.mark.parametrize("shape", [(8, 128), (16, 40), (2, 129), (2, 2100)])
@pytest.mark.parametrize("chain", [4, 31])
def test_bf16_roll_chain_plain_matches_jax_interpret(shape, chain):
    jx, tx = _bf16(_slab(13, shape, -300, 300) / 7)
    ref = np.asarray(jwm.bf16_roll_chain_micro(jx, chain, interpret=True))
    got = wm.bf16_roll_chain_micro_plain(tx, chain)
    np.testing.assert_array_equal(_np(got), ref.astype(np.float32))


def test_elem_chain_int16_matches_int32():
    x = torch.from_numpy(_rng(14).integers(0, 100, (64, 128)).astype(
        np.int16))
    assert torch.equal(wm.elem_chain_micro(x).int(),
                       wm.elem_chain_micro(x.int()))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def test_wrappers_take_the_plain_path_on_cpu():
    kernels.reset_launch_counts()
    C = torch.from_numpy(_costs(15, (5, 8, 128), 128, np.int8))
    for mode in wm.I8_MODES:
        assert torch.equal(wm.sweep_micro(C, mode),
                           wm.sweep_micro_plain(C, mode))
    x = torch.from_numpy(_slab(16, (8, 128)).astype(np.int32))
    assert torch.equal(wm.elem_chain_micro(x, 9),
                       wm.elem_chain_micro_plain(x, 9))
    assert torch.equal(wm.reg_chain_micro(x, 9),
                       wm.reg_chain_micro_plain(x, 9))
    assert torch.equal(wm.roll_chain_micro(x, 9, axis=0),
                       wm.roll_chain_micro_plain(x, 9, 0))
    xb = x.bfloat16()
    assert torch.equal(wm.bf16_roll_chain_micro(xb, 9),
                       wm.bf16_roll_chain_micro_plain(xb, 9))
    counts = kernels.launch_counts()
    assert {"sweep_micro", "elem_chain_micro", "roll_chain_micro",
            "reg_chain_micro", "bf16_roll_chain_micro"} <= counts.keys()
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("bad,exc,match", [
    (dict(mode="v16"), ValueError, "mode"),
    (dict(C=torch.zeros((2, 8, 64), dtype=torch.int32)), ValueError, "128"),
    (dict(C=torch.zeros((2, 8, 128), dtype=torch.int16)), TypeError, "int32"),
    (dict(mode="v32_i8"), TypeError, "int8"),
    (dict(mode="swar_i8", C=torch.zeros((2, 7, 128), dtype=torch.int8)),
     ValueError, "even"),
    (dict(mode="bf16_i8", C=torch.zeros((2, 7, 128), dtype=torch.int8)),
     ValueError, "even"),
    (dict(p1=-1), ValueError, "penalties"),
    (dict(p2=0x3FFF), ValueError, "penalties"),
    (dict(C=torch.full((2, 8, 128), 1 << 14, dtype=torch.int32)), ValueError,
     "2\\^14"),
    (dict(mode="swar", C=torch.full((2, 8, 128), 0x4000 << 16,
                                    dtype=torch.int32)), ValueError, "2\\^14"),
    (dict(mode="v32_i8", C=torch.full((2, 8, 128), -1, dtype=torch.int8)),
     ValueError, "128"),
])
def test_sweep_micro_refuses_what_the_kernel_does_not_take(bad, exc, match):
    kw = dict(C=torch.zeros((2, 8, 128), dtype=torch.int32), mode="v32",
              p1=10, p2=120)
    kw.update(bad)
    with pytest.raises(exc, match=match):
        wm.sweep_micro(kw.pop("C"), **kw)


def test_chain_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        wm.elem_chain_micro(x.float())
    with pytest.raises(TypeError):
        wm.reg_chain_micro(x.long())
    with pytest.raises(TypeError):
        wm.roll_chain_micro(x.short())
    with pytest.raises(TypeError):
        wm.bf16_roll_chain_micro(x)
    with pytest.raises(ValueError):
        wm.elem_chain_micro(x[0])
    with pytest.raises(ValueError, match="axis"):
        wm.roll_chain_micro(x, axis=2)
    # lines past the kernel's limit run the plain version on the CPU
    long = torch.from_numpy(_rng(17).integers(0, 1000, (wm.MAX_LINE + 1, 2))
                            .astype(np.int32))
    assert torch.equal(wm.roll_chain_micro(long, 3, axis=0),
                       wm.roll_chain_micro_plain(long, 3, 0))
    longb = long.T.contiguous().bfloat16()
    assert torch.equal(wm.bf16_roll_chain_micro(longb, 3),
                       wm.bf16_roll_chain_micro_plain(longb, 3))
    with pytest.raises(ValueError, match=str(wm.MAX_LINE)):
        wm._roll_plan(wm.MAX_LINE + 1)
    with pytest.raises(ValueError, match="even"):
        wm.bf16_roll_chain_micro(torch.zeros((3, 8), dtype=torch.bfloat16))


@pytest.mark.parametrize("length,plan", [
    (128, (4, 32)), (2048, (64, 32)), (2047, (64, 32)), (1248, (48, 26)),
    (1, (2, 1)), (2, (2, 1)), (30, (2, 15)), (31, (3, 11)), (37, (3, 13)),
    (2049, (48, 43)), (4100, (48, 86)), (16896, (64, 264)),
    (24576, (64, 384))])
def test_roll_plan_leaves_room_for_the_wrap(length, plan):
    """The plan's T threads hold the line exactly (E each) or with one
    short value in some of them (E - 1), every thread at least 2 values
    (a roll moves at most 2 out of each), in one block; a line of 1 or 2
    values is a ring of two."""
    slots, threads = wm._roll_plan(length)
    assert (slots, threads) == plan
    assert slots in wm.ROLL_SLOTS and 1 <= threads <= wm.ROLL_MAX_THREADS
    if length <= 2:
        return
    exact = slots * threads == length
    assert exact or (slots >= 3 and slots * threads > length
                     > (slots - 1) * threads)


def test_roll_plan_covers_every_line_the_kernel_takes():
    """Every length up to `MAX_LINE` has a plan, one warp's where it fills
    32 threads exactly or is at most 96 values long; none past it."""
    for length in range(3, wm.MAX_LINE + 1):
        slots, threads = wm._roll_plan(length)
        assert slots * threads == length or (
            slots >= 3 and (slots - 1) * threads < length < slots * threads)
        if length <= 96 or (length % 32 == 0
                             and length // 32 in wm.ROLL_SLOTS):
            assert threads <= 32, length
    with pytest.raises(ValueError):
        wm._roll_plan(wm.MAX_LINE + 1)


# ---------------------------------------------------------------------------
# the chain kernel's plan
# ---------------------------------------------------------------------------

CHAIN_KINDS = {"elem": wm._ELEM, "reg": wm._REG}
CHAIN_DTYPES = {"int32": torch.int32, "int16": torch.int16,
                "bfloat16": torch.bfloat16, "float32": torch.float32}
CHAIN_CASES = [("elem", "int32"), ("elem", "int16"), ("elem", "bfloat16"),
               ("reg", "int32"), ("reg", "float32"), ("reg", "bfloat16"),
               ("reg", "int16")]
STEP17_SHAPES = [(1248, 128), (16896, 128)]


def _per_word(dtype):
    return 2 if dtype in (torch.int16, torch.bfloat16) else 1


@pytest.mark.parametrize("kind,dtype", CHAIN_CASES)
def test_chain_plan_covers_every_value(kind, dtype):
    """The kernel's map (thread t holds the values of words W t .. W t +
    W - 1, all but the last thread whole) on the plan's grid holds every
    value once and leaves no block empty: n from 1 to 3,000 (odd n for
    the 16-bit dtypes among them) and n near multiples of a word for each
    of the card's 528 x 32 threads."""
    dt, per = CHAIN_DTYPES[dtype], _per_word(CHAIN_DTYPES[dtype])
    card = wm.SMS * wm.SCHEDULERS * 32 * per
    ns = list(range(1, 3001)) + [m * card * w + d for m in (1, 2, 3, 7)
                                 for w in wm.CHAIN_WORDS
                                 for d in (-per - 1, -1, 0, 1, per + 1)]
    for n in ns:
        words, threads, blocks = wm._chain_plan(n, dt, CHAIN_KINDS[kind])
        assert words in wm.CHAIN_WORDS and threads % 128 == 0
        span = words * per
        e0 = np.arange(blocks * threads) * span
        held = np.clip(n - e0, 0, span)  # values each thread holds
        assert held.sum() == n, n
        used = np.flatnonzero(held)
        # threads 0 .. last hold values, every one of them whole but the
        # last, which holds the tail
        assert np.array_equal(used, np.arange(used.size)), n
        assert np.all(held[used[:-1]] == span) and held[used[-1]] >= 1
        assert blocks * threads - used.size < threads, n


@pytest.mark.parametrize("sms", [wm.SMS, 114])
@pytest.mark.parametrize("shape", STEP17_SHAPES)
@pytest.mark.parametrize("kind,dtype", CHAIN_CASES)
def test_chain_plan_balances_the_schedulers(shape, kind, dtype, sms):
    """At `chip_smoke.py` step 17's shapes, on the H100 SXM's 132 SMs and
    the PCIe card's 114, the busiest scheduler holds at most one warp more
    than the mean over the card's SMs x 4 (blocks of 128 threads, one warp
    on each of an SM's four), and its warps take at least one warp's
    dependent step between two of a warp's own (`CHAIN_CLOCKS`), so the
    chain's latency is covered; no other W of `CHAIN_WORDS` would give
    the busiest scheduler fewer clocks a step."""
    dt = CHAIN_DTYPES[dtype]
    n = shape[0] * shape[1]
    step, latency = wm.CHAIN_CLOCKS[CHAIN_KINDS[kind], dt]

    def busiest(words, threads, blocks):
        return -(-blocks // sms) * threads // (32 * wm.SCHEDULERS)

    words, threads, blocks = wm._chain_plan(n, dt, CHAIN_KINDS[kind], sms)
    warps = -(-n // (32 * words * _per_word(dt)))
    most = busiest(words, threads, blocks)
    assert most - warps / (sms * wm.SCHEDULERS) <= 1
    assert most * step[words] >= latency
    for w in wm.CHAIN_WORDS:
        other = (w, threads, -(-n // (_per_word(dt) * w * threads)))
        assert max(most * step[words], latency) <= max(
            busiest(*other) * step[w], latency), w


# a chain kernel's loop as `cuobjdump -sass` lists it: (kind, dtype, W)
# in the mangled name, `steps` steps a pass of `ops` on each of W words
# plus the loop's counter, compare and branch
def _sass_listing(dt, kind, w, ops, steps):
    lines = [f"\t\tFunction : _ZN12_GLOBAL__N_112chain_kernelILi{dt}ELi"
             f"{kind}ELi{w}EEEvPKvPvli",
             "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
             ".L_x_7:"]
    at = 0x10
    body = [op for _ in range(steps * w) for op in ops] + [
        "UIADD3 UR4, UR4, 0x8, URZ", "ISETP.LT.AND P0, PT, R2, UR4, PT"]
    for op in body:
        lines.append(f"        /*{at:04x}*/                   {op} ;")
        at += 0x10
    lines.append(f"        /*{at:04x}*/               @P0 BRA `(.L_x_7) ;")
    lines.append(f"        /*{at + 0x10:04x}*/                   EXIT ;")
    return "\n".join(lines)


@pytest.mark.parametrize("w", wm.CHAIN_WORDS)
def test_chain_sass_finds_a_folded_chain(w):
    """`chain_sass`'s parser counts the loop of each chain kernel, and
    `chain_folds` passes a loop that issues the JAX body's operations on
    each word every step (elem int32: x + i and the DPX add-min; reg
    float32: v + 1, min, w + 1) and fails one folded to half as many steps
    (min(min(v + 1, t) + 1, t + 1) = min(v + 2, t + 1): an exact output,
    half the instructions)."""
    from tpustereo_torch.bench import chain_sass as cs

    listing = "\n".join([
        _sass_listing(0, 0, w, ["VIADD R4, R3, UR5",
                                "VIADDMNMX R5, R5, 0x1, R4, PT"], 8),
        _sass_listing(3, 1, w, ["FADD R4, R5, 1", "FMNMX R5, R4, R6, PT",
                                "FADD R6, R6, 1"], 16),
        _sass_listing(0, 1, w, ["VIADDMNMX R5, R5, 0x2, R6, PT",
                                "VIADD R6, R6, 0x2"], 8)])
    loops = cs.chain_loops(listing)
    assert loops[f"chain elem int32 W{w}"]["total"] == 16 * w + 3
    assert loops[f"chain elem int32 W{w}"]["ops"]["VIADDMNMX"] == 8 * w
    issue = cs.chain_issue(
        {k: v for k, v in loops.items() if "reg int32" not in k},
        {"elem": 8, "reg": 16})
    assert issue[f"chain reg float32 W{w}"] == 3 * w + 3 / 16
    assert cs.chain_folds(issue) == {}
    # the reg int32 loop above runs 8 pairs of steps, each as one step's
    # instructions: 16 steps a pass
    folded = cs.chain_issue(loops, {"elem": 8, "reg": 16})
    assert cs.chain_folds(folded) == {
        f"chain reg int32 W{w}": (w + 3 / 16, 2 * w)}
