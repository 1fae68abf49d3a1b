"""Semi-global path aggregation in plain PyTorch.

Counterpart of the JAX package's `ops/sgm.py` (`p2_map`, `_sweep`,
`aggregate_path`, `aggregate`) with the same recurrence

    L(p) = C(p) + min(Lp, Lp(d-1) + P1, Lp(d+1) + P1, minLp + P2(p)) - minLp

over the predecessor p - r, and the same restart rule: a pixel whose
predecessor lies outside the image restarts with L = C. P2(p) is the
scalar P2, or under `adaptive_p2` the per-pixel
P2'(p) = max(P1 + 1, P2 // max(1, |I(p) - I(p - r)|)) of the left image
(`p2_map`). Each scan step is one vectorised (..., N, D) slab op, as in the
JAX `lax.scan`; a Python loop over the scan axis takes the scan's place.
This is the plain version of the sweep kernels (`kernels/sgm.py`). The
ring hand-off between strips (`dist.tiling`) seeds a sweep with the raw L
of the row before its first (`init_carry`) and takes the raw L of its last
row (`return_carry`), as the JAX `_sweep` does.
"""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config

_BIG = 1 << 24

DIRS_4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
DIRS_8 = DIRS_4 + ((1, 1), (1, -1), (-1, 1), (-1, -1))


def adaptive_p2_map(img: torch.Tensor, dy: int, dx: int, p1: int,
                    p2: int) -> torch.Tensor:
    """P2'(p) = max(P1 + 1, P2 // max(1, |I(p) - I(p - r)|)) for direction
    r = (dy, dx): img (..., H, W) uint8 -> int32 of its shape. The gradient
    is 0 where p - r leaves the image (the path restarts there, so the
    value is never read), and never reads across frames. Exact integer
    `//`, which the JAX package proves its float32 quotient equal to."""
    H, W = img.shape[-2:]
    ii = img.to(torch.int32)
    grad = torch.zeros_like(ii)
    ys = slice(max(dy, 0), H + min(dy, 0))
    xs = slice(max(dx, 0), W + min(dx, 0))
    ys_src = slice(max(-dy, 0), H + min(-dy, 0))
    xs_src = slice(max(-dx, 0), W + min(-dx, 0))
    grad[..., ys, xs] = (ii[..., ys, xs] - ii[..., ys_src, xs_src]).abs()
    return torch.clamp(p2 // torch.clamp(grad, min=1), min=p1 + 1)


def p2_map(img: torch.Tensor, dy: int, dx: int, cfg: Config) -> torch.Tensor:
    """Per-pixel P2 of direction (dy, dx): `adaptive_p2_map` under
    `cfg.adaptive_p2`, else cfg.p2 everywhere. img (..., H, W) uint8 ->
    int32 of its shape."""
    if not cfg.adaptive_p2:
        return torch.full(img.shape, cfg.p2, dtype=torch.int32,
                          device=img.device)
    return adaptive_p2_map(img, dy, dx, cfg.p1, cfg.p2)


def _sweep(C: torch.Tensor, p2m: torch.Tensor, p1: int, dx: int,
           init_carry: torch.Tensor | None = None,
           return_carry: bool = False):
    """Forward sweep over axis 0 of C (T, ..., N, D) int32 -> int16.

    p2m (T, ..., N) int32 is each pixel's P2; `dx` is the in-carry shift
    along N per step (0 axial, +-1 diagonal). `init_carry` (..., N, D), the
    raw L of the row before C's first, seeds the first step, so the scan
    covers all T rows; None restarts row 0 (L = C). With `return_carry`
    also returns the raw L (int32) of the last row."""
    T, N = C.shape[0], C.shape[-2]
    dev = C.device
    n = torch.arange(N, device=dev)[:, None]
    has_prev = None if dx == 0 else (n >= dx) if dx > 0 else (n < N + dx)
    if init_carry is None:
        prev = C[0]
        out = [prev.to(torch.int16)]
    else:
        prev = init_carry.to(torch.int32)
        out = []
    for t in range(len(out), T):
        c = C[t]
        if dx > 0:
            pad = torch.full_like(prev[..., :dx, :], _BIG)
            sh = torch.cat([pad, prev[..., :-dx, :]], -2)
        elif dx < 0:
            pad = torch.full_like(prev[..., :-dx, :], _BIG)
            sh = torch.cat([prev[..., -dx:, :], pad], -2)
        else:
            sh = prev
        minprev = sh.amin(-1, keepdim=True)
        col = torch.full_like(sh[..., :1], _BIG)
        up = torch.cat([sh[..., 1:], col], -1)
        dn = torch.cat([col, sh[..., :-1]], -1)
        cand = torch.minimum(sh, torch.minimum(up, dn) + p1)
        cand = torch.minimum(cand, minprev + p2m[t][..., None])
        L = c + cand - minprev
        if has_prev is not None:
            L = torch.where(has_prev, L, c)
        out.append(L.to(torch.int16))
        prev = L
    out = torch.stack(out)
    return (out, prev) if return_carry else out


def check_image(img: torch.Tensor, C: torch.Tensor) -> None:
    """Raise unless img is a uint8 image of C's pixels, on C's device."""
    if img.dtype != torch.uint8 or img.shape != C.shape[:-1]:
        raise ValueError(f"img must be uint8 of shape {tuple(C.shape[:-1])}, "
                         f"got {img.dtype} {tuple(img.shape)}")
    if img.device != C.device:
        raise ValueError("C and img must be on one device")


def sweep_image(cfg: Config, img: torch.Tensor | None):
    """The image the sweeps of `cfg` read: the left image under
    `cfg.adaptive_p2`, which needs it, else None (the scalar P2)."""
    if not cfg.adaptive_p2:
        return None
    if img is None:
        raise ValueError("adaptive_p2 needs the left image")
    return img


def aggregate_path(C: torch.Tensor, dy: int, dx: int, cfg: Config,
                   img: torch.Tensor | None = None,
                   init_carry: torch.Tensor | None = None,
                   return_carry: bool = False):
    """L_r for direction r = (dy, dx); C (..., H, W, D) any int -> int16.
    img (..., H, W) uint8, the left image, is read under
    `cfg.adaptive_p2`, which needs it. `init_carry` and `return_carry` as
    in `path_costs`."""
    return path_costs(C, dy, dx, cfg.p1, cfg.p2, sweep_image(cfg, img),
                      init_carry, return_carry)


def path_costs(C: torch.Tensor, dy: int, dx: int, p1: int, p2: int,
               img: torch.Tensor | None = None,
               init_carry: torch.Tensor | None = None,
               return_carry: bool = False,
               p2m: torch.Tensor | None = None):
    """`aggregate_path` with the penalties given directly: the scalar P2,
    or with img the adaptive P2' of that image (`adaptive_p2_map`), or
    p2m (..., H, W) int32, each pixel's P2, where given.

    Horizontal paths scan over x, the others over y with the diagonal's
    column shift in the carry; reverse directions flip the scan axis (the
    shift keeps its sign under the y-flip, as in the JAX version). The
    carry of `_sweep` is the raw L of one line across the scan: (..., H, D)
    for the horizontal paths, (..., W, D) for the others; `init_carry`
    seeds the first scanned line, and `return_carry` returns (L_r, the
    last scanned line's raw L)."""
    Ci = C.to(torch.int32)
    if p2m is None and img is None:
        p2m = torch.full(C.shape[:-1], p2, dtype=torch.int32,
                         device=C.device)
    elif p2m is None:
        check_image(img, C)
        p2m = adaptive_p2_map(img, dy, dx, p1, p2)
    if dy == 0:
        Cs, p2s = Ci.movedim(-2, 0), p2m.movedim(-1, 0)   # (W, ..., H, D)
        flip, axis, shift = dx < 0, -2, 0
    else:
        Cs, p2s = Ci.movedim(-3, 0), p2m.movedim(-2, 0)   # (H, ..., W, D)
        flip, axis, shift = dy < 0, -3, dx
    if flip:
        Cs, p2s = Cs.flip(0), p2s.flip(0)
    out = _sweep(Cs, p2s, p1, shift, init_carry, return_carry)
    out, carry = out if return_carry else (out, None)
    if flip:
        out = out.flip(0)
    out = out.movedim(0, axis).contiguous()
    return (out, carry) if return_carry else out


def aggregate(C: torch.Tensor, cfg: Config,
              img: torch.Tensor | None = None) -> torch.Tensor:
    """S = sum over the 4 or 8 directions of L_r; (..., H, W, D) int16.
    img as in `aggregate_path`."""
    S = torch.zeros(C.shape, dtype=torch.int16, device=C.device)
    for dy, dx in (DIRS_4 if cfg.paths == 4 else DIRS_8):
        S += aggregate_path(C, dy, dx, cfg, img)
    return S
