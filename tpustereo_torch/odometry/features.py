"""Feature detection, description and matching for the odometry backend
(SURVEY.md §3 #19, §4.4): a copy of the JAX package's
`odometry/features.py` in torch, static shapes, on the device of the
inputs, with no host synchronisation.

Harris corner response (elementwise work and box sums), top-K selection,
patch descriptors matched with one (K×K) matrix product. Where the two
packages' semantics could part:

* the box sums add the 2r+1 shifted rows, then columns, in a fixed order,
  where the JAX `_box` takes differences of float32 cumsums: the same sums
  in another rounding, so responses agree with JAX within a tolerance,
  while the card and the CPU agree bit for bit (elementwise IEEE adds; a
  cumsum's order differs between them). For the same reason the image is
  divided by 255 as a tensor: a CUDA division by a host scalar multiplies
  by its reciprocal;
* `jax.lax.top_k` returns equal scores lowest index first, and every
  score past the last valid corner is -inf, so the tail of `pts` is that
  tie rule: a stable descending sort keeps it, where `torch.topk` promises
  no order of ties on CUDA;
* `describe` clamps each patch's start into the padded image, as
  `jax.lax.dynamic_slice` does;
* the NCC similarity is a float32 matrix product without TF32, whose
  10-bit mantissas would move the argmax of near-equal similarities.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(x, (dy, dx), (0, 1))


def _box(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)² box sum of the edge-padded image: the shifted rows summed
    in order, then the shifted columns."""
    H, W = x.shape
    k = 2 * r + 1
    p = F.pad(x[None, None], (r, r, r, r), mode="replicate")[0, 0]
    v = p[0:H]
    for i in range(1, k):
        v = v + p[i:i + H]
    out = v[:, 0:W]
    for j in range(1, k):
        out = out + v[:, j:j + W]
    return out


def harris_response(img: torch.Tensor, r: int = 2,
                    kappa: float = 0.04) -> torch.Tensor:
    """Harris corner response. img uint8 (H, W) -> float32 (H, W)."""
    f = img.to(torch.float32)
    f = f / torch.full((), 255.0, device=f.device)   # a fill, not a copy
    dx = (_shift(f, 0, -1) - _shift(f, 0, 1)) * 0.5
    dy = (_shift(f, -1, 0) - _shift(f, 1, 0)) * 0.5
    sxx, syy, sxy = _box(dx * dx, r), _box(dy * dy, r), _box(dx * dy, r)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - kappa * tr * tr


def detect_corners(img: torch.Tensor, max_corners: int = 256,
                   nms_radius: int = 3, border: int = 12,
                   min_response: float = 1e-6):
    """Top-K Harris corners with 3×3+ non-max suppression.

    Returns (pts (K, 2) float32 [y, x], subpixel; valid (K,) bool), K static.
    """
    H, W = img.shape
    resp = harris_response(img)
    # NMS: keep pixels equal to their neighbourhood max (-inf outside)
    k = 2 * nms_radius + 1
    local_max = F.max_pool2d(resp[None, None], k, stride=1,
                             padding=nms_radius)[0, 0]
    keep = (resp >= local_max) & (resp > min_response)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inb = ((yy >= border) & (yy < H - border) & (xx >= border)
           & (xx < W - border))
    score = torch.where(keep & inb, resp, -torch.inf).reshape(-1)
    top, idx = torch.sort(score, descending=True, stable=True)
    top, idx = top[:max_corners], idx[:max_corners]
    iy, ix = idx // W, idx % W
    valid = top > -torch.inf

    # subpixel refinement: 1-D parabola fits on the response along y and x
    # (integer corner positions quantise small optical flows — a 2 px
    # inter-frame flow carries ±0.5 px = 25% noise otherwise)
    def paraboloid(m, p, c):
        denom = m - 2.0 * c + p
        off = torch.where(denom < 0,
                          (m - p) / torch.where(denom == 0, 1.0, 2.0 * denom),
                          0.0)
        return torch.clamp(off, -0.5, 0.5)

    c0 = resp[iy, ix]
    offy = paraboloid(resp[torch.clamp(iy - 1, min=0), ix],
                      resp[torch.clamp(iy + 1, max=H - 1), ix], c0)
    offx = paraboloid(resp[iy, torch.clamp(ix - 1, min=0)],
                      resp[iy, torch.clamp(ix + 1, max=W - 1)], c0)
    pts = torch.stack([iy.to(torch.float32) + offy,
                       ix.to(torch.float32) + offx], -1)
    return pts, valid


def describe(img: torch.Tensor, pts: torch.Tensor,
             patch: int = 8) -> torch.Tensor:
    """Normalized intensity-patch descriptors at pts.

    (K, 2) -> (K, patch²) float32, zero-mean unit-norm, so matching
    similarity is NCC via a single matmul.
    """
    r = patch // 2
    f = img.to(torch.float32)
    fp = F.pad(f[None, None], (r, r, r, r), mode="replicate")[0, 0]
    ip = torch.round(pts).to(torch.int64)  # pts may be subpixel floats
    # the patch's start clamped into the padded image, as dynamic_slice
    y0 = torch.clamp(ip[:, 0], 0, fp.shape[0] - patch)
    x0 = torch.clamp(ip[:, 1], 0, fp.shape[1] - patch)
    off = torch.arange(patch, device=img.device)
    rows = (y0[:, None] + off)[:, :, None]
    cols = (x0[:, None] + off)[:, None, :]
    patches = fp[rows, cols].reshape(pts.shape[0], -1)
    patches = patches - patches.mean(-1, keepdim=True)
    norm = torch.linalg.norm(patches, dim=-1, keepdim=True)
    return patches / torch.clamp(norm, min=1e-6)


@contextlib.contextmanager
def _ieee_matmul():
    """float32 matrix products without TF32 for the block's duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def match_descriptors(da: torch.Tensor, db: torch.Tensor,
                      va: torch.Tensor, vb: torch.Tensor,
                      min_similarity: float = 0.6):
    """Mutual-nearest-neighbour NCC matching.

    da (..., K, P), db (K, P) -> (idx_b (..., K) int32, good (..., K) bool):
    for each valid descriptor in A its mutual best match in B. Similarity is
    one (K×K) matmul per leading index; the first maximum wins each argmax.
    """
    with _ieee_matmul():
        sim = da @ db.transpose(-1, -2)  # (..., K, K) NCC in [-1, 1]
    sim = torch.where(va[..., :, None] & vb[..., None, :], sim, -2.0)
    best_ab = torch.argmax(sim, dim=-1)
    best_ba = torch.argmax(sim, dim=-2)
    K = da.shape[-2]
    mutual = (torch.gather(best_ba, -1, best_ab)
              == torch.arange(K, device=da.device))
    strength = torch.gather(sim, -1, best_ab[..., None])[..., 0]
    good = mutual & (strength > min_similarity) & va
    return best_ab.to(torch.int32), good
