"""SGM sweeps and the fused backward sweep + WTA: CUDA kernel wrappers and
plain versions, and the compositions built of them.

Counterparts of the JAX package's `kernels/sgm_pallas.py`: `sgm_sweep`
with one direction (`csrc/sgm_sweep.cu`) and with its `dxs`, the
directions of one scan order fused (`sgm_sweep_fused`,
`csrc/sgm_fused.cu`), `sgm_sweep_bidir` (`csrc/sgm_bidir.cu`),
`sweep_bwd_wta` (`csrc/bwd_wta.cu`), and the Python compositions
`sgm_select` (`sgm_select_pallas`) and `aggregate_volume`
(`aggregate_pallas`). The kernels take the plain (B, H, W, D) layout for
every direction; nothing is padded.

The default `sgm_select` needs no transpose: its sweeps read (B, H, W, D)
directly. With 8 paths it runs the JAX schedule's vertical sweeps, the
down set {S, SE, SW} and the up set {N, NE, NW} each in one fused pass
over C, then E by the one-direction kernel; with 4 paths every scan order
has one direction and the one-direction kernel runs them.
`aggregate_volume` and the `BIDIR_VERT` route of `sgm_select` keep the
JAX package's schedule, horizontal sweeps as column sweeps of the
transposed pair (`kernels.transpose`), so they run its relayout kernels.

Adaptive P2 (the JAX `p2_maps` operand of `sgm_sweep` and `sweep_bwd_wta`):
`sgm_sweep` and `sweep_bwd_wta` take the left image `img` (B, H, W) uint8
and compute each pixel's P2' = max(P1 + 1, P2 // max(1, |I(p) - I(p - r)|))
in the kernel, from the image bytes; no map is materialised. The
compositions pass the image under `cfg.adaptive_p2`, the horizontal sweeps
of `aggregate_volume` the transposed image. `sgm_sweep_bidir` stays
scalar-only: under adaptive P2 `sgm_select` runs the default schedule even
with `BIDIR_VERT`, as the JAX `sgm_select_pallas` does.

The ring hand-off between strips (the JAX `init_carry` and
`return_final_carry` of `sgm_sweep`, which `dist.tiling`'s exact mode
runs): `sgm_sweep(..., carry=q, return_carry=True)` seeds the strip's
first row from the q = L - min_d L slab of the previous strip's last row
and returns its own last row's q, one direction a launch; the fused
`sgm_sweep_fused(..., carry=q, return_carry=True)` does the same for the K
directions of one scan order in one launch, its (K, B, W, D) carry the JAX
(K, N, D) one slab a direction, in `dxs` order.
"""

from __future__ import annotations

import ctypes

import torch

from tpustereo_torch.config import Config
from tpustereo_torch.kernels import _build
from tpustereo_torch.kernels.transpose import transpose_hw, transpose_sum_hw
from tpustereo_torch.ops.postproc import _right_disparity
from tpustereo_torch.ops.sgm import (DIRS_4, DIRS_8, adaptive_p2_map,
                                    check_image, path_costs, sweep_image)
from tpustereo_torch.ops.wta import wta

_P, _I = ctypes.c_void_p, ctypes.c_int
_SWEEP_SIGS = {
    # C, S, img (null: scalar P2), carry in, carry out, img_prev (each null
    # when not given), B, H, W, D, dy, dx, p1, p2, accumulate, stream
    "sgm_sweep_launch": ([_P] * 6 + [_I] * 9 + [_P], _I),
}
_FUSED_SIGS = {
    # C, S, img (null: scalar P2), flags, edge buffer, carries between
    # bands (the last three null without an exchange), carry in, carry out,
    # img_prev (each null when not given), B, H, W, D, dy, the number of
    # directions and their dx (three slots), p1, p2, accumulate, stream
    "sgm_fused_launch": ([_P] * 9 + [_I] * 12 + [_P], _I),
    # B, W, D -> the flag ints and the int16 elements of the edge buffer
    # and of the carries between bands
    "sgm_fused_scratch": ([_I] * 3 + [_P], _I),
}
_BIDIR_SIGS = {
    # C, Sd, Su, B, H, W, D, dx, p1, p2, accumulate, packed, stream
    "sgm_bidir_launch": ([_P] * 3 + [_I] * 9 + [_P], _I),
}
_BWD_SIGS = {
    # C, S7, img (null: scalar P2), disp, valid, d_r, rows, W, D, p1, p2,
    # uniq, subpixel, d_start, stream
    "bwd_wta_launch": ([_P] * 6 + [_I] * 8 + [_P], _I),
}
MAX_D = 512  # 32 lanes x 16 registers of carry per warp

# The `sgm_select` schedule of the vertical sweeps: False (the default, as
# in the JAX package) accumulates them into S7 one direction at a time;
# True runs the down and up sweeps together (`sgm_sweep_bidir`), sums and
# transposes them in one pass, and adds the E sweep in the transposed
# layout. The outputs are the same.
BIDIR_VERT = False

# the column shifts of the down and up sets of 8 paths, in the JAX order
VERTICAL_DXS = (0, 1, -1)
# the largest D whose down and up sets of 8 paths run fused
# (`vertical_orders`): past it the fused pair loses to the six one-direction
# launches on the H100 (one 375 x 1242 frame, by graph replay: at D = 512
# 4.32 against 2.45 ms even for an s16x2 build, which csrc/sgm_fused.cu
# therefore has only up to D = 256; at D = 256 1.21 against 1.21-1.25;
# `bench/kernel_micro.py sgm_fused`)
FUSED_MAX_D = 256
# a fused sweep of more rows than this, with a diagonal, swaps its tiles'
# edges through device memory (csrc/sgm_fused.cu's FR)
EXCHANGE_ROWS = 8


def _check_cost(C: torch.Tensor) -> None:
    if C.dim() != 4 or C.numel() == 0 or C.dtype != torch.uint8:
        raise ValueError(f"C must be a non-empty (B, H, W, D) uint8 volume, "
                         f"got {C.dtype} {tuple(C.shape)}")
    if C.shape[-1] > MAX_D:
        raise ValueError(f"D = {C.shape[-1]} > {MAX_D} unsupported")
    if C.device.type == "cuda" and not C.is_contiguous():
        raise ValueError("C must be contiguous")
    if C.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {C.device}")


def _check_volume(C: torch.Tensor, S: torch.Tensor, name: str) -> None:
    _check_cost(C)
    if S.shape != C.shape or S.dtype != torch.int16:
        raise ValueError(f"{name} must be int16 of C's shape "
                         f"{tuple(C.shape)}, got {S.dtype} {tuple(S.shape)}")
    if S.device != C.device:
        raise ValueError(f"C and {name} must be on one device")
    if C.device.type == "cuda" and not S.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_img(C: torch.Tensor, img: torch.Tensor | None) -> None:
    if img is None:
        return
    check_image(img, C)
    if C.device.type == "cuda" and not img.is_contiguous():
        raise ValueError("img must be contiguous")


def _check_carry(C: torch.Tensor, dy: int, img, carry, return_carry: bool,
                 img_prev, k: int = 0) -> None:
    """The ring hand-off's operands: a (B, W, D) int32 carry, or (k, B, W,
    D) for the k directions of a fused sweep, and a (B, W) uint8 img_prev,
    y-scanning directions only."""
    if carry is None and not return_carry and img_prev is None:
        return
    B, _, W, D = C.shape
    if dy == 0:
        raise ValueError("the carry runs along y: dy must be +-1")
    named = [("carry", carry, (k, B, W, D) if k else (B, W, D), torch.int32),
             ("img_prev", img_prev, (B, W), torch.uint8)]
    for name, t, shape, dtype in named:
        if t is None:
            continue
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != C.device:
            raise ValueError(f"C and {name} must be on one device")
        if C.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if img is not None and carry is not None and img_prev is None:
        raise ValueError("adaptive P2 with a carry needs img_prev, the image "
                         "row of the carry")
    if img_prev is not None and (img is None or carry is None):
        raise ValueError("img_prev goes with img and a carry")


def _p2_across(img: torch.Tensor, img_prev: torch.Tensor, dy: int, dx: int,
               p1: int, p2: int) -> torch.Tensor:
    """The adaptive P2' map of img (B, H, W) with img_prev (B, W), the row
    before its first in sweep order, as the first row's predecessors."""
    prev = img_prev[:, None]
    ext = torch.cat([prev, img] if dy > 0 else [img, prev], 1)
    m = adaptive_p2_map(ext, dy, dx, p1, p2)
    return m[:, 1:] if dy > 0 else m[:, :-1]


def p2_max(p1: int, p2: int, adaptive: bool) -> int:
    """The largest P2 a sweep can add: P2, or under adaptive P2
    max(P2, P1 + 1), which P1 = P2 reaches."""
    return max(p2, p1 + 1) if adaptive else p2


# ---------------------------------------------------------------------------
# one directional sweep
# ---------------------------------------------------------------------------

def sgm_sweep_plain(C: torch.Tensor, S: torch.Tensor | None, dy: int,
                    dx: int, p1: int, p2: int,
                    img: torch.Tensor | None = None,
                    carry: torch.Tensor | None = None,
                    return_carry: bool = False,
                    img_prev: torch.Tensor | None = None,
                    out: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch (`ops.sgm`). The carry is the
    kernel's q = L - min_d L; `ops.sgm._sweep` carries the raw L, which a q
    slab seeds exactly (the recurrence reads its predecessor only through
    q), and its returned L is turned into q here."""
    p2m = (None if img_prev is None
           else _p2_across(img, img_prev, dy, dx, p1, p2))
    res = path_costs(C, dy, dx, p1, p2, img, carry, return_carry, p2m)
    L, fin = res if return_carry else (res, None)
    if S is not None:
        S += L
        L = S
    elif out is not None:
        L = out.copy_(L)
    if not return_carry:
        return L
    return L, fin - fin.amin(-1, keepdim=True)


def sgm_sweep(C: torch.Tensor, S: torch.Tensor | None, dy: int, dx: int,
              p1: int, p2: int, img: torch.Tensor | None = None,
              carry: torch.Tensor | None = None, return_carry: bool = False,
              img_prev: torch.Tensor | None = None,
              out: torch.Tensor | None = None):
    """L_r for direction r = (dy, dx): with S None a new int16 volume
    S = L_r (the JAX `sgm_sweep(C, None, ...)`, which reads no S), or L_r
    written into `out`, an int16 volume of C's shape, where given; else
    S += L_r in place, returning S (the pipeline's one accumulator of its
    sweeps: it saves a volume).

    C (B, H, W, D) uint8, S int16 of the same shape. With img, the left
    image (B, H, W) uint8, each pixel's P2 is the adaptive P2' of the
    gradient along r (`ops.sgm.adaptive_p2_map`), else the scalar p2.

    The ring hand-off between strips (the JAX `init_carry` and
    `return_final_carry`), y-scanning directions only: `carry` (B, W, D)
    int32 is the q = L - min_d L of the row before C's first in sweep order
    (each column's minimum over d is 0), None a fresh path start; a zero
    carry gives the output of None. With `return_carry` the call returns
    (S, the q of C's last row in sweep order). Under adaptive P2 a carry
    needs `img_prev` (B, W) uint8, the image row the carry belongs to.

    CUDA tensors run the kernel, its form counted in `sgm_sweep.builds`
    ("write", "add", and "write_adaptive", "add_adaptive" with img) and,
    where it takes or returns a carry, in `sgm_sweep.carry_forms` too; CPU
    tensors the plain version."""
    if S is None:
        _check_cost(C)
    else:
        _check_volume(C, S, "S")
    if out is not None:
        if S is not None:
            raise ValueError("out goes with S None, the write form")
        _check_volume(C, out, "out")
    _check_img(C, img)
    if (dy, dx) not in DIRS_8:
        raise ValueError(f"direction {(dy, dx)} is not one of {DIRS_8}")
    if not 0 <= p1 <= p2:
        raise ValueError("need 0 <= p1 <= p2")
    _check_carry(C, dy, img, carry, return_carry, img_prev)
    if C.device.type == "cpu":
        return sgm_sweep_plain(C, S, dy, dx, p1, p2, img, carry,
                               return_carry, img_prev, out)
    add = S is not None
    if not add:
        S = (torch.empty(C.shape, dtype=torch.int16, device=C.device)
             if out is None else out)
    B, H, W, D = C.shape
    fin = (torch.empty((B, W, D), dtype=torch.int32, device=C.device)
           if return_carry else None)
    lib = _build.load("sgm_sweep", _SWEEP_SIGS)
    ptrs = [None if t is None else _build.ptr(t)
            for t in (img, carry, fin, img_prev)]
    rc = lib.sgm_sweep_launch(_build.ptr(C), _build.ptr(S), *ptrs, B, H, W,
                              D, dy, dx, p1, p2, int(add),
                              _build.stream_ptr(C))
    _build.check(lib, rc, "sgm_sweep")
    form = ("add" if add else "write") + ("" if img is None else "_adaptive")
    sgm_sweep.launches += 1
    sgm_sweep.builds[form] += 1
    if carry is not None or return_carry:
        sgm_sweep.carry_forms[form] += 1
    return (S, fin) if return_carry else S


sgm_sweep.launches = 0
sgm_sweep.builds = {"write": 0, "add": 0, "write_adaptive": 0,
                    "add_adaptive": 0}
sgm_sweep.carry_forms = dict(sgm_sweep.builds)


# ---------------------------------------------------------------------------
# the directions of one scan order in one pass
# ---------------------------------------------------------------------------

def _check_dxs(dxs) -> tuple:
    dxs = tuple(dxs)
    if not dxs or len(set(dxs)) != len(dxs) or not set(dxs) <= {-1, 0, 1}:
        raise ValueError(f"dxs must be distinct shifts of -1, 0, 1, got "
                         f"{dxs}")
    return dxs


def sgm_sweep_fused_plain(C: torch.Tensor, S: torch.Tensor | None, dy: int,
                          dxs, p1: int, p2: int,
                          img: torch.Tensor | None = None,
                          out: torch.Tensor | None = None,
                          carry: torch.Tensor | None = None,
                          return_carry: bool = False,
                          img_prev: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch: the sum over dxs of
    `ops.sgm.path_costs`, in int16 (wrapping, as the kernel's sums do);
    with a carry each direction seeded from its slab of the q-form carry,
    and with `return_carry` the q of the last row, as `sgm_sweep_plain`."""
    L, fins = None, []
    for k, dx in enumerate(dxs):
        res = sgm_sweep_plain(C, None, dy, dx, p1, p2, img,
                              None if carry is None else carry[k],
                              return_carry, img_prev)
        Lr, fin = res if return_carry else (res, None)
        fins.append(fin)
        L = Lr if L is None else L.add_(Lr)
    if S is not None:
        S += L
        L = S
    elif out is not None:
        L = out.copy_(L)
    return (L, torch.stack(fins)) if return_carry else L


def sgm_sweep_fused(C: torch.Tensor, S: torch.Tensor | None, dy: int, dxs,
                    p1: int, p2: int, img: torch.Tensor | None = None,
                    out: torch.Tensor | None = None,
                    carry: torch.Tensor | None = None,
                    return_carry: bool = False,
                    img_prev: torch.Tensor | None = None):
    """The sum over dx in dxs of L_(dy, dx), the directions of one scan
    order in one pass over C (the JAX `sgm_sweep(C, S_in, dxs, reverse,
    ...)`, dy = +1 its forward order, -1 `reverse`): with S None a new int16
    volume, or written into `out`, an int16 volume of C's shape, where
    given; else added to S in place, returning S.

    dxs: distinct column shifts from {-1, 0, +1}. C (B, H, W, D) uint8, D
    <= 512, S int16 of the same shape. With img, the left image (B, H, W)
    uint8, each direction takes the adaptive P2' of its own gradient
    I(p) - I(p - r) (`ops.sgm.adaptive_p2_map`), else the scalar p2.

    The ring hand-off between strips (the JAX `init_carry` and
    `return_final_carry` with K = len(dxs)): `carry` (K, B, W, D) int32,
    one q-form slab a direction in `dxs` order, is the q = L - min_d L of
    the row before C's first in sweep order (None a fresh path start); with
    `return_carry` the call returns (S, the (K, B, W, D) q of C's last row
    in sweep order). Under adaptive P2 a carry needs `img_prev` (B, W)
    uint8, the image row the carry belongs to.

    CUDA tensors run the kernel, its form counted in
    `sgm_sweep_fused.builds` ("write", "add", "write_adaptive",
    "add_adaptive") and, where it takes or returns a carry, in
    `sgm_sweep_fused.carry_forms` too; CPU tensors the plain version. The
    kernel keeps each direction's renormalised carry in int16, so on the
    card it takes 255 + P2 < 2^15 (`p2_max` under adaptive P2), and a
    carry of q-form values (at most 255 + P2). Any H and W: a frame with
    more tiles than the card holds blocks has each block walk several
    tiles band by band."""
    if S is None:
        _check_cost(C)
    else:
        _check_volume(C, S, "S")
    if out is not None:
        if S is not None:
            raise ValueError("out goes with S None, the write form")
        _check_volume(C, out, "out")
    _check_img(C, img)
    dxs = _check_dxs(dxs)
    if dy not in (1, -1):
        raise ValueError(f"dy must be +1 (down) or -1 (up), got {dy}")
    if not 0 <= p1 <= p2:
        raise ValueError("need 0 <= p1 <= p2")
    _check_carry(C, dy, img, carry, return_carry, img_prev, len(dxs))
    if C.device.type == "cpu":
        return sgm_sweep_fused_plain(C, S, dy, dxs, p1, p2, img, out, carry,
                                     return_carry, img_prev)
    p2_top = p2_max(p1, p2, img is not None)
    if 255 + p2_top >= 1 << 15:
        raise ValueError(f"P2 = {p2_top} unsupported: the carry q <= 255 + "
                         f"P2 must stay below 2^15")
    add = S is not None
    if not add:
        S = (torch.empty(C.shape, dtype=torch.int16, device=C.device)
             if out is None else out)
    B, H, W, D = C.shape
    lib = _build.load("sgm_fused", _FUSED_SIGS)
    flags = edges = state = None
    if H > EXCHANGE_ROWS and any(dxs):   # the tiles swap their edges
        n = (ctypes.c_longlong * 3)()
        _build.check(lib, lib.sgm_fused_scratch(B, W, D, n),
                     "sgm_sweep_fused")
        flags = torch.zeros(n[0], dtype=torch.int32, device=C.device)
        edges = torch.empty(n[1], dtype=torch.int16, device=C.device)
        state = torch.empty(n[2], dtype=torch.int16, device=C.device)
    fin = (torch.empty((len(dxs), B, W, D), dtype=torch.int32,
                       device=C.device) if return_carry else None)
    pad = dxs + (0,) * (3 - len(dxs))
    ptrs = [None if x is None else _build.ptr(x)
            for x in (img, flags, edges, state, carry, fin, img_prev)]
    rc = lib.sgm_fused_launch(_build.ptr(C), _build.ptr(S), *ptrs, B, H, W,
                              D, dy, len(dxs), *pad, p1, p2, int(add),
                              _build.stream_ptr(C))
    _build.check(lib, rc, "sgm_sweep_fused")
    form = ("add" if add else "write") + ("" if img is None else "_adaptive")
    sgm_sweep_fused.launches += 1
    sgm_sweep_fused.builds[form] += 1
    if carry is not None or return_carry:
        sgm_sweep_fused.carry_forms[form] += 1
    return (S, fin) if return_carry else S


sgm_sweep_fused.launches = 0
sgm_sweep_fused.builds = {"write": 0, "add": 0, "write_adaptive": 0,
                          "add_adaptive": 0}
sgm_sweep_fused.carry_forms = dict(sgm_sweep_fused.builds)


# ---------------------------------------------------------------------------
# down + up vertical sweeps in one kernel
# ---------------------------------------------------------------------------

def sgm_sweep_bidir_plain(C: torch.Tensor, dxs, p1: int, p2: int):
    """The kernel's function in plain PyTorch (`ops.sgm`)."""
    Sd = torch.zeros(C.shape, dtype=torch.int16, device=C.device)
    Su = torch.zeros_like(Sd)
    for dx in dxs:
        Sd += path_costs(C, 1, dx, p1, p2)
        Su += path_costs(C, -1, dx, p1, p2)
    return Sd, Su


def bidir_fits_s16x2(D: int, c_max: int, p1: int, p2: int) -> bool:
    """Whether `sgm_sweep_bidir` runs its s16x2 build, which packs the down
    and up lines as the two signed 16-bit halves of one word: every lane of
    the warp full (D = 32 K, K = 1, 2, 4, 8 or 16 disparities a lane) and
    every half exact, c_max + P1 + P2 < 2^15 (`sgm_step_s16x2` in
    `csrc/common.cuh`). Otherwise the int32 build runs. The same condition
    as the C launch's, which the wrapper calls at c_max = 255 (any uint8
    cost)."""
    return D in (32, 64, 128, 256, 512) and c_max + p1 + p2 < 1 << 15


def sgm_sweep_bidir(C: torch.Tensor, dxs, p1: int, p2: int):
    """(S_down, S_up): the sums of the path costs of the directions (1, dx)
    and (-1, dx) over the column shifts `dxs`, each int16 of C's shape.

    C (B, H, W, D) uint8. One launch per dx runs both directions; the first
    writes S_down and S_up, the later ones add to them. CUDA tensors run
    the kernel, its s16x2 or int32 build by `bidir_fits_s16x2` (counted in
    `sgm_sweep_bidir.builds`), CPU tensors the plain version."""
    dxs = _check_dxs(dxs)
    if not 0 <= p1 <= p2:
        raise ValueError("need 0 <= p1 <= p2")
    _check_cost(C)
    if C.device.type == "cpu":
        return sgm_sweep_bidir_plain(C, dxs, p1, p2)
    if C.data_ptr() % 16:
        C = C.clone()  # the kernel's 16-byte copies need an aligned volume
    B, H, W, D = C.shape
    packed = bidir_fits_s16x2(D, 255, p1, p2)
    Sd = torch.empty(C.shape, dtype=torch.int16, device=C.device)
    Su = torch.empty_like(Sd)
    lib = _build.load("sgm_bidir", _BIDIR_SIGS)
    for i, dx in enumerate(dxs):
        rc = lib.sgm_bidir_launch(_build.ptr(C), _build.ptr(Sd),
                                  _build.ptr(Su), B, H, W, D, dx, p1, p2,
                                  int(i > 0), int(packed),
                                  _build.stream_ptr(C))
        _build.check(lib, rc, "sgm_sweep_bidir")
        sgm_sweep_bidir.launches += 1
        sgm_sweep_bidir.builds["s16x2" if packed else "int32"] += 1
    return Sd, Su


sgm_sweep_bidir.launches = 0
sgm_sweep_bidir.builds = {"s16x2": 0, "int32": 0}


# ---------------------------------------------------------------------------
# backward (W) sweep fused with WTA + uniqueness + subpixel + d_R
# ---------------------------------------------------------------------------

def sweep_bwd_wta_plain(C: torch.Tensor, S7: torch.Tensor, cfg: Config,
                        img: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch (`ops.sgm`, `ops.wta`,
    `ops.postproc._right_disparity` at d_start 0, which is the shifted-column
    index map)."""
    S = S7.to(torch.int32) + path_costs(C, 0, -1, cfg.p1, cfg.p2, img)
    disp, _, valid = wta(S, cfg)
    return disp, valid, _right_disparity(S, 0)


def sweep_bwd_wta(C: torch.Tensor, S7: torch.Tensor, cfg: Config,
                  img: torch.Tensor | None = None):
    """Complete S = S7 + L_W and select: -> (disp float32, valid bool,
    d_r int32), each (B, H, W).

    disp is in true units (`cfg.min_disparity` added); valid is the
    uniqueness test; d_r[x] = argmin_k S(x + k, k) is the right-view index
    map in the shifted-column convention of the JAX `sweep_bwd_wta`, for
    `kernels.lr.dr_consistency`. With img, the left image (B, H, W)
    uint8, the W sweep takes the adaptive P2' of the gradient
    |I(x) - I(x + 1)| (as `sgm_sweep`). CUDA tensors run the kernel, its
    scalar or adaptive build counted in `sweep_bwd_wta.builds`; CPU tensors
    the plain version.

    S7 is the sum of the other seven (or three) path costs, each at most
    255 + P2 (`p2_max` under adaptive P2). The kernel holds S = S7 + L_W as
    int16, so it takes 8 * (255 + P2) < 2^15, far above the fused route's
    bound."""
    _check_volume(C, S7, "S7")
    _check_img(C, img)
    if C.device.type == "cpu":
        return sweep_bwd_wta_plain(C, S7, cfg, img)
    p2_top = p2_max(cfg.p1, cfg.p2, img is not None)
    if 8 * (255 + p2_top) >= 1 << 15:
        raise ValueError(f"P2 = {p2_top} unsupported: S = S7 + L_W must stay "
                         f"below 2^15")
    B, H, W, D = C.shape
    dev = C.device
    disp = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    valid = torch.empty((B, H, W), dtype=torch.bool, device=dev)
    d_r = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    lib = _build.load("bwd_wta", _BWD_SIGS)
    img_p = None if img is None else _build.ptr(img)
    rc = lib.bwd_wta_launch(
        _build.ptr(C), _build.ptr(S7), img_p, _build.ptr(disp),
        _build.ptr(valid), _build.ptr(d_r), B * H, W, D, cfg.p1, cfg.p2,
        cfg.uniqueness_ratio, int(cfg.subpixel), cfg.min_disparity,
        _build.stream_ptr(C))
    _build.check(lib, rc, "sweep_bwd_wta")
    sweep_bwd_wta.launches += 1
    sweep_bwd_wta.builds["scalar" if img is None else "adaptive"] += 1
    return disp, valid, d_r


sweep_bwd_wta.launches = 0
sweep_bwd_wta.builds = {"scalar": 0, "adaptive": 0}


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

def vertical_orders(paths: int, D: int) -> tuple:
    """The launches of the y-scanning sweeps of `paths` directions at D
    disparities, as (dy, dxs): with 8 paths the down set {S, SE, SW} and
    the up set {N, NE, NW}, each one fused pass (the JAX schedule's two
    vertical sweeps) up to D = `FUSED_MAX_D`, one direction a launch past
    it (the six launches are faster there; the outputs are the same); with
    4 paths S and N. Decided from the arguments alone, before any launch,
    as `kernels.sad.sad_wta_fits` is; not a fallback: `sgm_sweep_fused`
    itself takes any D up to 512."""
    if paths == 4:
        return ((1, (0,)), (-1, (0,)))
    if D <= FUSED_MAX_D:
        return ((1, VERTICAL_DXS), (-1, VERTICAL_DXS))
    return tuple((dy, (dx,)) for dy in (1, -1) for dx in VERTICAL_DXS)


def vertical_sweep(C: torch.Tensor, S: torch.Tensor | None, dy: int, dxs,
                   p1: int, p2: int, img: torch.Tensor | None = None,
                   **kw):
    """One launch of `vertical_orders`: the scan order dy's directions dxs
    in one `sgm_sweep_fused` pass, or the one direction of dxs by
    `sgm_sweep`; kw (out, carry, return_carry, img_prev) as both take
    them, a carry (len(dxs), B, W, D) for a fused pass."""
    if len(dxs) > 1:
        return sgm_sweep_fused(C, S, dy, dxs, p1, p2, img, **kw)
    return sgm_sweep(C, S, dy, dxs[0], p1, p2, img, **kw)


def _vertical_sets(C: torch.Tensor, p1: int, p2: int,
                   img: torch.Tensor | None) -> torch.Tensor:
    """The y-scanning path costs of 8 paths in the launches of
    `vertical_orders`: the first writes S, the others add to it."""
    S = None
    for dy, dxs in vertical_orders(8, C.shape[-1]):
        S = vertical_sweep(C, S, dy, dxs, p1, p2, img)
    return S


def sgm_select(C: torch.Tensor, cfg: Config,
               img: torch.Tensor | None = None):
    """Aggregation + WTA + uniqueness + subpixel + right-view disparity.

    The sweeps of every direction but W make one int16 S7; the backward
    sweep completes S column by column and selects, so the full S is never
    stored. With 8 paths S7 takes three passes over C: the down set
    written and the up set added by `sgm_sweep_fused`, then E (past D =
    `FUSED_MAX_D` the six y directions one a launch, `vertical_orders`);
    with 4 paths E, S and N one direction a launch. C (B, H, W, D) uint8 ->
    (disp, valid, d_r) as in `sweep_bwd_wta`; img (B, H, W) uint8, the
    left image, is read under `cfg.adaptive_p2`, which needs it.
    `BIDIR_VERT` picks how S7 is made (the JAX `sgm_select_pallas`
    schedules); adaptive P2 always takes the default one, as there."""
    p1, p2 = cfg.p1, cfg.p2
    img = sweep_image(cfg, img)
    if BIDIR_VERT and img is None:
        dxs = VERTICAL_DXS if cfg.paths == 8 else (0,)
        Sd, Su = sgm_sweep_bidir(C, dxs, p1, p2)
        St = transpose_sum_hw(Sd, Su)
        del Sd, Su
        sgm_sweep(transpose_hw(C), St, 1, 0, p1, p2)   # E
        S7 = transpose_hw(St)
        del St
    elif cfg.paths == 8:
        # the down and up sets fused, then E: three passes over C
        S7 = _vertical_sets(C, p1, p2, img)
        sgm_sweep(C, S7, 0, 1, p1, p2, img)
    else:
        S7 = None   # the first sweep writes S7, the others add to it
        for dy, dx in DIRS_4:
            if (dy, dx) != (0, -1):
                S7 = sgm_sweep(C, S7, dy, dx, p1, p2, img)
    return sweep_bwd_wta(C, S7, cfg, img)


def aggregate_volume(C: torch.Tensor, cfg: Config,
                     img: torch.Tensor | None = None) -> torch.Tensor:
    """S = the sum of the 4 or 8 path costs: (B, H, W, D) uint8 -> int16,
    equal to `ops.aggregate`; img as in `sgm_select`.

    The JAX `aggregate_pallas` schedule: the vertical and diagonal sweeps
    into S (with 8 paths the down and up sets, each one `sgm_sweep_fused`
    pass), then S and C transposed so that E and W run as column sweeps of
    the pair (with the transposed image under adaptive P2, as the JAX
    `_p2_stack` transposes its maps), then S transposed back. Each
    intermediate is freed once the next step has what it needs, so besides
    C at most two int16 volumes, or one and the transposed C, are alive at
    a time."""
    p1, p2 = cfg.p1, cfg.p2
    img = sweep_image(cfg, img)
    if cfg.paths == 8:
        S = _vertical_sets(C, p1, p2, img)
    else:
        S = sgm_sweep(C, None, 1, 0, p1, p2, img)   # S writes, N adds
        sgm_sweep(C, S, -1, 0, p1, p2, img)
    St = transpose_hw(S)
    del S
    Ct = transpose_hw(C)
    imgt = None if img is None else img.transpose(-1, -2).contiguous()
    sgm_sweep(Ct, St, 1, 0, p1, p2, imgt)    # E
    sgm_sweep(Ct, St, -1, 0, p1, p2, imgt)   # W
    del Ct
    return transpose_hw(St)
