"""Data-width micro-benchmarks of the SGM sweep step: CUDA kernel wrappers
and their plain PyTorch versions.

Counterpart of the JAX package's `kernels/width_micro.py`: the same five
functions under the same names and arguments (less `interpret`). They are
on no user's path; they time the serial min-plus step that bounds the
port's sweeps (`csrc/sgm_sweep.cu`, `csrc/sgm_bidir.cu`, `csrc/bwd_wta.cu`)
at three data widths, so that a redesign of those kernels can choose its
arithmetic:

* `sweep_micro`: the axial SGM recurrence over (T, N, 128) from a zero
  carry, in int32 (`v32`, `v32_i8`: the port's shipped `sgm_step`), in
  packed signed 16-bit pairs with Hopper's DPX min-plus instructions
  (`swar`, `swar_i8`: `sgm_step_s16x2`) and in bf16 pairs (`bf16_i8`);
* `elem_chain_micro`, `reg_chain_micro`: dependent add/min chains in
  int32, int16 (s16x2), bfloat16 (bf16x2) and, for the register chain,
  float32;
* `roll_chain_micro`, `bf16_roll_chain_micro`: dependent rolls of lines
  held in registers, E consecutive values a thread: each step moves the
  top 1 or 2 values of every thread into the next by `__shfl_sync` (across
  warps through shared memory) and renames the rest.

The kernels are `csrc/width_micro.cu`. CUDA tensors run a kernel, CPU
tensors the plain version, which repeats the JAX arithmetic step by step:
the 16-bit sentinel 0x4000 and bf16's 16384, the packed field order (even
row high in `swar`, the first half high in `swar_i8`) and bf16 rounding
after every operation. Values outside the micro's domain (all integers
below 2^14, so both 16-bit fields stay exact) raise.
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.kernels import _build

BIG16 = 0x4000      # the 16-bit +inf of the JAX int32 and packed steps
BF_BIG = 16384.0    # bf16's, exact in bf16 (a power of two)
D_MICRO = 128
I8_MODES = ("v32_i8", "swar_i8", "bf16_i8")
MODES = ("v32", "swar") + I8_MODES
# values a thread the roll kernel is built for (`csrc/width_micro.cu`)
ROLL_SLOTS = (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
ROLL_MAX_THREADS = 32 * 12  # one line a block of at most 12 warps
# the longest line the roll kernel takes: 64 values in registers a thread
# of such a block (the CPU's plain version takes any)
MAX_LINE = ROLL_SLOTS[-1] * ROLL_MAX_THREADS
_DT = {torch.int32: 0, torch.int16: 1, torch.bfloat16: 2, torch.float32: 3}
_ELEM, _REG = 0, 1
# a packed word's two field sign-and-headroom bits (0xC000C000 as int32)
_FIELD_TOP = -0x3FFF4000

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGS = {
    # C, out, T, N, mode, p1, p2, stream
    "sweep_micro_launch": ([_P, _P] + [_I] * 5 + [_P], _I),
    # x, out, n, dtype, kind, chain, stream
    "chain_micro_launch": ([_P, _P, _L] + [_I] * 3 + [_P], _I),
    # x, out, lines, len, line stride, element stride, pair16, slots,
    # threads, chain, stream
    "roll_micro_launch": ([_P, _P, _I, _I, _L, _L] + [_I] * 4 + [_P], _I),
}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def pack_rows(C: torch.Tensor) -> torch.Tensor:
    """(T, N, D) small ints -> (T, N//2, D) int32: even rows in the high
    16-bit field, odd rows in the low field."""
    if C.shape[1] % 2:
        raise ValueError(f"pack_rows needs an even N, got {C.shape[1]}")
    return C[:, 0::2].int() * 65536 + C[:, 1::2].int()


def unpack_rows(P: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_rows` for non-negative fields below 2^15."""
    T, Nh, D = P.shape
    out = torch.empty((T, 2 * Nh, D), dtype=torch.int32, device=P.device)
    out[:, 0::2] = P >> 16
    out[:, 1::2] = P & 0xFFFF
    return out


def _swar_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-16-bit-field min of packed int32 words, every field in
    [0, 0x7FFF): t's field sign bit is a_f >= b_f, since 0x8000 + a_f - b_f
    cannot borrow across fields (the JAX `sgm_pallas._swar_min`)."""
    t = (a | -0x7FFF8000) - b          # 0x80008000 as int32
    m_hi = t & -0x80000000
    e_hi = m_hi >> 15                  # arithmetic: 0xFFFF0000 or 0
    m_lo = t & 0x8000
    e_lo = (m_lo - (m_lo >> 15)) | m_lo  # 0xFFFF or 0
    e = e_hi | e_lo
    return (b & e) | (a & ~e)


def _neighbours(q: torch.Tensor, big):
    """q's lane neighbours d+1 (up) and d-1 (dn), `big` where d+-1 leaves
    [0, D) (the JAX rolls by D-1 and 1, then the lane masks)."""
    up = torch.roll(q, -1, dims=1)
    up[:, -1] = big
    dn = torch.roll(q, 1, dims=1)
    dn[:, 0] = big
    return up, dn


def _step32(q, c, p1, p2):
    """The JAX `_sweep_step32`: (next carry, L)."""
    up, dn = _neighbours(q, BIG16)
    cand = torch.minimum(torch.minimum(q, torch.minimum(up, dn) + p1),
                         torch.tensor(p2, dtype=torch.int32))
    L = c + cand
    return L - L.amin(dim=1, keepdim=True), L


def _step_swar(q, c, p1, p2):
    """The JAX `_sweep_step_swar`: the packed step, the all-lanes min by
    its roll tree of `_swar_min`."""
    up, dn = _neighbours(q, BIG16 * 65536 + BIG16)
    cand = _swar_min(_swar_min(q, _swar_min(up, dn) + (p1 * 65536 + p1)),
                     torch.full_like(q, p2 * 65536 + p2))
    L = c + cand
    M = L
    for b in range(7):
        M = _swar_min(M, torch.roll(M, 1 << b, dims=1))
    return L - M, L


def _step_bf16(q, c, p1, p2):
    """The JAX `sgm_pallas._dir_step_bf16` at dx = 0: every operation in
    bf16, rounded to nearest."""
    up, dn = _neighbours(q, BF_BIG)
    bf = torch.bfloat16
    cand = torch.minimum(torch.minimum(
        q, torch.minimum(up, dn) + torch.tensor(p1, dtype=bf)),
        torch.tensor(p2, dtype=bf))
    L = c + cand
    return L - L.amin(dim=1, keepdim=True), L


def sweep_micro_plain(C: torch.Tensor, mode: str, p1: int = 10,
                      p2: int = 120) -> torch.Tensor:
    """`sweep_micro` in plain PyTorch, one step of T at a time."""
    T, N, D = C.shape
    out = torch.empty(C.shape, device=C.device,
                      dtype=torch.int16 if mode in I8_MODES else torch.int32)
    H = N // 2
    rows = H if mode == "swar_i8" else N
    dtype = torch.bfloat16 if mode == "bf16_i8" else torch.int32
    q = torch.zeros((rows, D), dtype=dtype, device=C.device)
    for t in range(T):
        c = C[t].int()
        if mode == "bf16_i8":
            q, L = _step_bf16(q, c.to(torch.bfloat16), p1, p2)
            out[t] = L.int().to(torch.int16)
        elif mode == "swar_i8":
            q, L = _step_swar(q, (c[:H] << 16) | c[H:], p1, p2)
            out[t, :H] = (L >> 16).to(torch.int16)
            out[t, H:] = (L & 0xFFFF).to(torch.int16)
        elif mode == "swar":
            q, L = _step_swar(q, c, p1, p2)
            out[t] = L
        else:
            q, L = _step32(q, c, p1, p2)
            out[t] = L.to(out.dtype)
    return out


def elem_chain_micro_plain(x: torch.Tensor, chain: int = 32) -> torch.Tensor:
    v = x.clone()
    one = torch.ones((), dtype=x.dtype)
    for i in range(chain):
        v = torch.minimum(v + one, x + torch.tensor(i, dtype=x.dtype))
    return v


def roll_chain_micro_plain(x: torch.Tensor, chain: int = 32,
                           axis: int = 1) -> torch.Tensor:
    v = x.clone()
    for i in range(chain):
        v = torch.roll(v, 1 + (i & 1), dims=axis)
    return v


def reg_chain_micro_plain(x: torch.Tensor, chain: int = 32) -> torch.Tensor:
    one = torch.ones((), dtype=x.dtype)
    v = x
    w = v + one
    for _ in range(chain):
        v = torch.minimum(v + one, w)
        w = w + one
    return v + w


def bf16_roll_chain_micro_plain(x: torch.Tensor,
                                chain: int = 32) -> torch.Tensor:
    return roll_chain_micro_plain(x, chain, axis=x.dim() - 1)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _device(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _check_cuda_input(x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError("input must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("input must be 16-byte aligned")


def _check_chain(x: torch.Tensor, chain: int, dtypes) -> None:
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"need a non-empty (N, D) slab, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"dtype {x.dtype} not in {dtypes}")
    if chain < 0:
        raise ValueError(f"chain {chain} < 0")


def _check_sweep(C: torch.Tensor, mode: str, p1: int, p2: int) -> None:
    """The micro's contract: the JAX function's asserts less the Mosaic
    alignment ones, and the value domain in which its 16-bit fields are
    exact."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if C.dim() != 3 or C.shape[2] != D_MICRO or 0 in C.shape:
        raise ValueError(f"need a non-empty (T, N, {D_MICRO}) volume, got "
                         f"{tuple(C.shape)}")
    want = torch.int8 if mode in I8_MODES else torch.int32
    if C.dtype != want:
        raise TypeError(f"mode {mode!r} takes {want}, got {C.dtype}")
    if mode in ("swar_i8", "bf16_i8") and C.shape[1] % 2:
        raise ValueError(f"mode {mode!r} pairs rows (n, n + N/2): N must be "
                         f"even, got {C.shape[1]}")
    if not (0 <= p1 and 0 <= p2 and p1 + p2 < 0x3FFF):
        raise ValueError(f"penalties p1={p1}, p2={p2} outside 0 <= p1, p2 "
                         f"and p1 + p2 < 0x3FFF (16-bit fields stay exact)")
    if mode == "swar":
        bad = (C & _FIELD_TOP) != 0
    elif mode == "v32":
        bad = (C < 0) | (C >= 1 << 14)
    else:
        bad = C < 0
    if bool(bad.any()):
        raise ValueError(f"mode {mode!r} needs every cost (every field for "
                         f"'swar') in [0, 2^14); the i8 modes in [0, 128)")


def _sweep_launch(C: torch.Tensor, mode: str, p1: int,
                  p2: int) -> torch.Tensor:
    """Launch the sweep kernel on C, already checked by `_check_sweep`
    (timed alone by `chip_smoke.py`, without the check's reduction)."""
    _check_cuda_input(C)
    T, N, _ = C.shape
    out = torch.empty(C.shape, device=C.device,
                      dtype=torch.int16 if mode in I8_MODES else torch.int32)
    lib = _build.load("width_micro", _SIGS)
    rc = lib.sweep_micro_launch(
        _build.ptr(C), _build.ptr(out), T, N, MODES.index(mode), p1, p2,
        _build.stream_ptr(C))
    _build.check(lib, rc, f"sweep_micro {mode}")
    sweep_micro.launches += 1
    return out


def sweep_micro(C: torch.Tensor, mode: str, p1: int = 10,
                p2: int = 120) -> torch.Tensor:
    """Run the axial sweep recurrence over C (T, N, 128) from a zero carry
    and return every step's L, as the JAX `sweep_micro`.

    'v32': C int32, L int32. 'swar': C int32 packed two rows a word
    (`pack_rows`: even row high), L packed the same way. 'v32_i8',
    'swar_i8', 'bf16_i8': C int8, L int16, so all three move the same
    bytes; 'swar_i8' pairs rows (n, n + N/2) in the kernel with the first
    half high, 'bf16_i8' runs the step in bf16 (N even for both). Costs
    (fields) in [0, 2^14), i8 costs in [0, 128), p1 + p2 < 0x3FFF. CUDA
    tensors run the kernel, CPU tensors the plain version."""
    _check_sweep(C, mode, p1, p2)
    if _device(C) == "cpu":
        return sweep_micro_plain(C, mode, p1, p2)
    return _sweep_launch(C, mode, p1, p2)


def _chain_launch(x: torch.Tensor, chain: int, kind: int, fn) -> torch.Tensor:
    _check_cuda_input(x)
    out = torch.empty_like(x)
    lib = _build.load("width_micro", _SIGS)
    rc = lib.chain_micro_launch(_build.ptr(x), _build.ptr(out), x.numel(),
                                _DT[x.dtype], kind, chain,
                                _build.stream_ptr(x))
    _build.check(lib, rc, fn.__name__)
    fn.launches += 1
    return out


def elem_chain_micro(x: torch.Tensor, chain: int = 32) -> torch.Tensor:
    """`chain` dependent steps of v = min(v + 1, x + i) from v = x, in x's
    dtype (int32, int16 or bfloat16, rounded after every operation):
    (N, D) -> (N, D). CUDA tensors run the kernel (int16 and bf16 two
    values a 32-bit word), CPU tensors the plain version."""
    _check_chain(x, chain, (torch.int32, torch.int16, torch.bfloat16))
    if _device(x) == "cpu":
        return elem_chain_micro_plain(x, chain)
    return _chain_launch(x, chain, _ELEM, elem_chain_micro)


def reg_chain_micro(x: torch.Tensor, chain: int = 32) -> torch.Tensor:
    """w = v + 1, then `chain` times v = min(v + 1, w); w = w + 1; returns
    v + w, all in registers, in x's dtype (int32, float32, bfloat16 or
    int16): (N, D) -> (N, D). CUDA tensors run the kernel, CPU tensors the
    plain version."""
    _check_chain(x, chain, (torch.int32, torch.float32, torch.bfloat16,
                            torch.int16))
    if _device(x) == "cpu":
        return reg_chain_micro_plain(x, chain)
    return _chain_launch(x, chain, _REG, reg_chain_micro)


def _roll_plan(length: int):
    """(E, T) for a line of `length` values: T threads, the first of them E
    consecutive values each and the rest E - 1 (all E where T * E equals
    the length; each then rolls without a wrap fix-up). The kernel needs E
    in `ROLL_SLOTS`, at least 2 values a thread (so 3 <= E unless exact),
    and T <= `ROLL_MAX_THREADS`. Of the plans it takes: the fewest warps
    (one warp a line rolls without barriers), then an exact one, then the
    smallest E. A line of 1 or 2 values is a ring of two (T = 1, E = 2)."""
    if length <= 2:
        return 2, 1
    best = None
    for e in ROLL_SLOTS:
        t = -(-length // e)
        exact = t * e == length
        if t > ROLL_MAX_THREADS or not (exact or (
                e >= 3 and t * (e - 1) < length)):
            continue
        key = (-(-t // 32), not exact, e)
        if best is None or key < best[0]:
            best = (key, e, t)
    if best is None:
        raise ValueError(f"a line of {length} > {MAX_LINE} values: the roll "
                         f"kernel holds a line in one block of "
                         f"{ROLL_MAX_THREADS} threads, {ROLL_SLOTS[-1]} "
                         f"values in registers each")
    return best[1], best[2]


def _roll_launch(x: torch.Tensor, chain: int, lines: int, length: int,
                 lstride: int, estride: int, pair16: int,
                 fn) -> torch.Tensor:
    _check_cuda_input(x)
    slots, threads = _roll_plan(length)
    out = torch.empty_like(x)
    lib = _build.load("width_micro", _SIGS)
    rc = lib.roll_micro_launch(_build.ptr(x), _build.ptr(out), lines,
                               length, lstride, estride, pair16, slots,
                               threads, chain, _build.stream_ptr(x))
    _build.check(lib, rc, fn.__name__)
    fn.launches += 1
    return out


def roll_chain_micro(x: torch.Tensor, chain: int = 32,
                     axis: int = 1) -> torch.Tensor:
    """`chain` dependent rolls by 1 + (i & 1) along `axis` (1: each row of
    D, 0: each column of N), as `torch.roll`: (N, D) int32 -> the same.
    CUDA tensors run the kernel, on lines of at most `MAX_LINE` values;
    CPU tensors the plain version, on any."""
    _check_chain(x, chain, (torch.int32,))
    if axis not in (0, 1):
        raise ValueError(f"axis {axis} not in (0, 1)")
    if _device(x) == "cpu":
        return roll_chain_micro_plain(x, chain, axis)
    N, D = x.shape
    if axis == 1:
        return _roll_launch(x, chain, N, D, D, 1, 0, roll_chain_micro)
    return _roll_launch(x, chain, D, N, 1, D, 0, roll_chain_micro)


def bf16_roll_chain_micro(x: torch.Tensor, chain: int = 32) -> torch.Tensor:
    """`chain` dependent rolls by 1 + (i & 1) along the last axis of a
    bfloat16 (N, D), N even. The kernel packs rows (2i, 2i+1) into one
    32-bit word, so one shuffle moves two values (the JAX function's roll
    through the int32 bit view). CUDA tensors run the kernel, on lines of
    at most `MAX_LINE` values; CPU tensors the plain version, on any."""
    _check_chain(x, chain, (torch.bfloat16,))
    N, D = x.shape
    if N % 2:
        raise ValueError(f"N must be even (rows are paired), got {N}")
    if _device(x) == "cpu":
        return bf16_roll_chain_micro_plain(x, chain)
    return _roll_launch(x, chain, N // 2, D, 2 * D, 1, 1,
                        bf16_roll_chain_micro)


sweep_micro.launches = 0
elem_chain_micro.launches = 0
roll_chain_micro.launches = 0
reg_chain_micro.launches = 0
bf16_roll_chain_micro.launches = 0
