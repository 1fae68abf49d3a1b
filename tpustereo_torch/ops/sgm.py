"""Semi-global path aggregation in plain PyTorch (scalar P2).

Counterpart of the JAX package's `ops/sgm.py` (`_sweep`, `aggregate_path`,
`aggregate`) with the same recurrence

    L(p) = C(p) + min(Lp, Lp(d-1) + P1, Lp(d+1) + P1, minLp + P2) - minLp

over the predecessor p - r, and the same restart rule: a pixel whose
predecessor lies outside the image restarts with L = C. Each scan step is
one vectorised (..., N, D) slab op, as in the JAX `lax.scan`; a Python
loop over the scan axis takes the scan's place. This is the plain version
of the sweep kernels (`kernels/sgm.py`). Adaptive P2 is not ported yet.
"""

from __future__ import annotations

import torch

from tpustereo_torch.config import Config

_BIG = 1 << 24

DIRS_4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
DIRS_8 = DIRS_4 + ((1, 1), (1, -1), (-1, 1), (-1, -1))


def _sweep(C: torch.Tensor, p1: int, p2: int, dx: int) -> torch.Tensor:
    """Forward sweep over axis 0 of C (T, ..., N, D) int32 -> int16.

    `dx` is the in-carry shift along N per step (0 axial, +-1 diagonal)."""
    T, N, D = C.shape[0], C.shape[-2], C.shape[-1]
    dev = C.device
    n = torch.arange(N, device=dev)[:, None]
    has_prev = None if dx == 0 else (n >= dx) if dx > 0 else (n < N + dx)
    prev = C[0]
    out = [prev.to(torch.int16)]
    for t in range(1, T):
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
        cand = torch.minimum(cand, minprev + p2)
        L = c + cand - minprev
        if has_prev is not None:
            L = torch.where(has_prev, L, c)
        out.append(L.to(torch.int16))
        prev = L
    return torch.stack(out)


def aggregate_path(C: torch.Tensor, dy: int, dx: int,
                   cfg: Config) -> torch.Tensor:
    """L_r for direction r = (dy, dx); C (..., H, W, D) any int -> int16."""
    return path_costs(C, dy, dx, cfg.p1, cfg.p2)


def path_costs(C: torch.Tensor, dy: int, dx: int, p1: int,
               p2: int) -> torch.Tensor:
    """`aggregate_path` with the penalties given directly.

    Horizontal paths scan over x, the others over y with the diagonal's
    column shift in the carry; reverse directions flip the scan axis (the
    shift keeps its sign under the y-flip, as in the JAX version)."""
    Ci = C.to(torch.int32)
    if dy == 0:
        Ct = Ci.movedim(-2, 0)                     # (W, ..., H, D)
        if dx < 0:
            Ct = Ct.flip(0)
        out = _sweep(Ct, p1, p2, 0)
        if dx < 0:
            out = out.flip(0)
        return out.movedim(0, -2).contiguous()
    Cs = Ci.movedim(-3, 0)                         # (H, ..., W, D)
    if dy < 0:
        Cs = Cs.flip(0)
    out = _sweep(Cs, p1, p2, dx)
    if dy < 0:
        out = out.flip(0)
    return out.movedim(0, -3).contiguous()


def aggregate(C: torch.Tensor, cfg: Config) -> torch.Tensor:
    """S = sum over the 4 or 8 directions of L_r; (..., H, W, D) int16."""
    S = torch.zeros(C.shape, dtype=torch.int16, device=C.device)
    for dy, dx in (DIRS_4 if cfg.paths == 4 else DIRS_8):
        S += aggregate_path(C, dy, dx, cfg)
    return S
