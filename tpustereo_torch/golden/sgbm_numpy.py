"""Scalar/NumPy golden SGBM — the executable specification (a copy of the
JAX package's `golden/sgbm_numpy.py`, over the port's `Config`).

Implements the recurrences of SURVEY.md §1.1 literally, in integer arithmetic,
so the JAX/Pallas pipeline and the port can be tested bit-exactly per stage. Vectorized
over the perpendicular axis and the disparity axis only; the path scan itself
is an explicit Python loop (auditable, slow, fine for test-sized images).

Shared conventions (the JAX pipeline mirrors these exactly):

* Images are grayscale uint8, shape (H, W).
* Census: window (ch, cw) centered at p, bits ordered row-major over the
  window excluding the center; bit = 1 iff I(q) < I(p). Borders use
  edge-replication padding.
* Cost: C(y,x,d) = popcount(censusL(y,x) ^ censusR(y,x-d)); hypotheses with
  x-d < 0 get the maximum census cost (ch*cw-1).
* SGM: L_r(p,d) = C(p,d) + min(L_r(p-r,d), L_r(p-r,d∓1)+P1, min_k L_r + P2)
  - min_k L_r(p-r,k); first pixel of each path takes L_r = C. Adaptive P2:
  P2' = max(P1+1, P2 // max(1, |I(p) - I(p-r)|)) on the LEFT image.
* WTA: argmin over d (ties -> smallest d). Uniqueness: invalidate when the
  best cost outside d*±1 satisfies S_2nd * 100 < S_best * (100 + ratio).
* Subpixel: parabola fit, offset clamped to ±0.5, skipped at d* in {0, D-1}
  or when the denominator is <= 0.
* LR check: d_R(y,x) = argmin_d S(y, x+d, d) (out of range -> skip); pixel
  invalid when |d_L(x) - d_R(x - round(d_L))| > disp12_max_diff or the
  re-projected column is out of image.
* Invalid disparity marker: -1.0 in the float output.
* Speckle: 4-connected components where neighbouring valid disparities
  differ by <= speckle_range; components smaller than speckle_window_size
  pixels are invalidated.
* Median: 3x3 median (edge-replicated) applied last, on the float map with
  invalid pixels participating as -1.
"""

from __future__ import annotations

import numpy as np

from tpustereo_torch.config import Config

INVALID = -1.0
_BIG = np.int32(1 << 24)


# ---------------------------------------------------------------------------
# Census + cost volume
# ---------------------------------------------------------------------------

def census_numpy(img: np.ndarray, window=(5, 5)) -> np.ndarray:
    """Census transform -> uint64 bitstrings, bit k = k-th window position
    (row-major, center excluded), set iff neighbour < center."""
    assert img.ndim == 2
    ch, cw = window
    ry, rx = ch // 2, cw // 2
    pad = np.pad(img, ((ry, ry), (rx, rx)), mode="edge")
    H, W = img.shape
    out = np.zeros((H, W), dtype=np.uint64)
    bit = 0
    center = img
    for dy in range(-ry, ry + 1):
        for dx in range(-rx, rx + 1):
            if dy == 0 and dx == 0:
                continue
            q = pad[ry + dy : ry + dy + H, rx + dx : rx + dx + W]
            out |= (q < center).astype(np.uint64) << np.uint64(bit)
            bit += 1
    return out


def _popcount64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    cnt = np.zeros(x.shape, dtype=np.uint8)
    for k in range(4):
        chunk = (x >> np.uint64(16 * k)) & np.uint64(0xFFFF)
        cnt += _POP16[chunk.astype(np.int64)]
    return cnt


_POP16 = np.array([bin(i).count("1") for i in range(1 << 16)], dtype=np.uint8)


def cost_volume_numpy(cen_l: np.ndarray, cen_r: np.ndarray, num_disp: int,
                      max_cost: int, min_disp: int = 0) -> np.ndarray:
    """C[y, x, j] = popcount(cenL[y,x] ^ cenR[y,x-d]), d = min_disp + j;
    x-d<0 -> max_cost. Plane j searches disparity hypothesis min_disp+j."""
    H, W = cen_l.shape
    C = np.full((H, W, num_disp), max_cost, dtype=np.uint8)
    for j in range(num_disp):
        d = min_disp + j
        if d >= W:
            break
        C[:, d:, j] = _popcount64(cen_l[:, d:] ^ cen_r[:, : W - d])
    return C


def sad_volume_numpy(left: np.ndarray, right: np.ndarray, num_disp: int,
                     block: int, min_disp: int = 0) -> np.ndarray:
    """Box-filtered SAD cost volume (SURVEY.md §1.1, config 1).

    A[y,x,j] = |L(y,x) - R(y,x-d)|, d = min_disp + j, with x-d<0 -> 255;
    box-summed over a block x block window with edge-replication padding.
    """
    H, W = left.shape
    li = left.astype(np.int32)
    ri = right.astype(np.int32)
    A = np.full((H, W, num_disp), 255, dtype=np.int32)
    for j in range(num_disp):
        d = min_disp + j
        if d >= W:
            break
        A[:, d:, j] = np.abs(li[:, d:] - ri[:, : W - d])
    r = block // 2
    Ap = np.pad(A, ((r, r), (r, r), (0, 0)), mode="edge")
    # integral image box sum
    cs = Ap.cumsum(axis=0).cumsum(axis=1)
    cs = np.pad(cs, ((1, 0), (1, 0), (0, 0)))
    out = (cs[block:, block:] - cs[:-block, block:]
           - cs[block:, :-block] + cs[:-block, :-block])
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# SGM aggregation
# ---------------------------------------------------------------------------

_DIRS_4 = [(0, 1), (0, -1), (1, 0), (-1, 0)]
_DIRS_8 = _DIRS_4 + [(1, 1), (1, -1), (-1, 1), (-1, -1)]


def _step(prev: np.ndarray, cost: np.ndarray, has_prev: np.ndarray,
          p1: int, p2: np.ndarray) -> np.ndarray:
    """One SGM scan step, vectorized over (N, D).

    prev: (N, D) int32 path costs of predecessors; cost: (N, D) current raw
    cost; has_prev: (N,) bool; p2: (N,) int32 (per-pixel, possibly adaptive).
    """
    minprev = prev.min(axis=-1)  # (N,)
    up = np.concatenate([prev[:, 1:], np.full_like(prev[:, :1], _BIG)], axis=-1)
    dn = np.concatenate([np.full_like(prev[:, :1], _BIG), prev[:, :-1]], axis=-1)
    cand = np.minimum(prev, np.minimum(up, dn) + p1)
    cand = np.minimum(cand, (minprev + p2)[:, None])
    L = cost + cand - minprev[:, None]
    return np.where(has_prev[:, None], L, cost)


def _p2_map(img: np.ndarray, dy: int, dx: int, cfg: Config) -> np.ndarray:
    """Per-pixel P2 for direction r=(dy,dx): depends on |I(p) - I(p-r)|."""
    H, W = img.shape
    if not cfg.adaptive_p2:
        return np.full((H, W), cfg.p2, dtype=np.int32)
    ii = img.astype(np.int32)
    shifted = np.full((H, W), 0, dtype=np.int32)
    ys = slice(max(dy, 0), H + min(dy, 0))
    xs = slice(max(dx, 0), W + min(dx, 0))
    ys_src = slice(max(-dy, 0), H + min(-dy, 0))
    xs_src = slice(max(-dx, 0), W + min(-dx, 0))
    grad = np.zeros((H, W), dtype=np.int32)
    grad[ys, xs] = np.abs(ii[ys, xs] - ii[ys_src, xs_src])
    return np.maximum(cfg.p1 + 1, cfg.p2 // np.maximum(1, grad)).astype(np.int32)


def aggregate_path_numpy(C: np.ndarray, dy: int, dx: int, cfg: Config,
                         img: np.ndarray) -> np.ndarray:
    """L_r for one direction r=(dy,dx) over the whole image. int32."""
    H, W, D = C.shape
    Ci = C.astype(np.int32)
    p2 = _p2_map(img, dy, dx, cfg)
    L = np.zeros_like(Ci)
    if dy == 0:
        # horizontal scan over x
        rng = range(W) if dx > 0 else range(W - 1, -1, -1)
        first = True
        for x in rng:
            if first:
                L[:, x] = Ci[:, x]
                first = False
            else:
                prev = L[:, x - dx]
                L[:, x] = _step(prev, Ci[:, x], np.ones(H, bool), cfg.p1, p2[:, x])
        return L
    # vertical / diagonal: scan over y; predecessor of (y, x) is (y-dy, x-dx)
    rng = range(H) if dy > 0 else range(H - 1, -1, -1)
    first = True
    for y in rng:
        if first:
            L[y] = Ci[y]
            first = False
            continue
        prev_row = L[y - dy]  # (W, D)
        if dx == 0:
            prev = prev_row
            has_prev = np.ones(W, bool)
        elif dx > 0:
            prev = np.concatenate([np.zeros((dx, D), np.int32), prev_row[:-dx]])
            has_prev = np.arange(W) >= dx
        else:
            prev = np.concatenate([prev_row[-dx:], np.zeros((-dx, D), np.int32)])
            has_prev = np.arange(W) < W + dx
        L[y] = _step(prev, Ci[y], has_prev, cfg.p1, p2[y])
    return L


def aggregate_numpy(C: np.ndarray, cfg: Config, img: np.ndarray) -> np.ndarray:
    """S = sum of L_r over 4 or 8 directions. int32 (fits uint16, §1.1)."""
    dirs = _DIRS_4 if cfg.paths == 4 else _DIRS_8
    S = np.zeros(C.shape, dtype=np.int32)
    for dy, dx in dirs:
        S += aggregate_path_numpy(C, dy, dx, cfg, img)
    return S


# ---------------------------------------------------------------------------
# WTA / refinement / post-processing
# ---------------------------------------------------------------------------

def wta_numpy(S: np.ndarray, cfg: Config):
    """(disp_float, disp_int, valid). Uniqueness + subpixel per module doc.

    Plane j of S is disparity hypothesis min_disparity + j; uniqueness and
    the subpixel interior condition live in index space, the returned
    disparities in true pixel units."""
    H, W, D = S.shape
    Si = S.astype(np.int64)
    j_int = Si.argmin(axis=-1).astype(np.int32)
    best = np.take_along_axis(Si, j_int[..., None], axis=-1)[..., 0]
    valid = np.ones((H, W), dtype=bool)

    if cfg.uniqueness_ratio > 0:
        dd = np.arange(D)[None, None, :]
        masked = np.where(np.abs(dd - j_int[..., None]) <= 1, _BIG.astype(np.int64), Si)
        second = masked.min(axis=-1)
        valid &= ~(second * 100 < best * (100 + cfg.uniqueness_ratio))

    d_int = j_int + np.int32(cfg.min_disparity)
    disp = d_int.astype(np.float32)
    if cfg.subpixel:
        dm = np.clip(j_int - 1, 0, D - 1)
        dp = np.clip(j_int + 1, 0, D - 1)
        sm = np.take_along_axis(Si, dm[..., None], -1)[..., 0].astype(np.float32)
        sp = np.take_along_axis(Si, dp[..., None], -1)[..., 0].astype(np.float32)
        s0 = best.astype(np.float32)
        denom = sm - 2.0 * s0 + sp
        offs = np.where(denom > 0, (sm - sp) / np.maximum(2.0 * denom, 1e-9), 0.0)
        offs = np.clip(offs, -0.5, 0.5)
        interior = (j_int > 0) & (j_int < D - 1)
        disp = disp + np.where(interior, offs, 0.0).astype(np.float32)
    return disp, d_int, valid


def right_disparity_numpy(S: np.ndarray, cfg: Config) -> np.ndarray:
    """Right-view WTA from the same aggregated volume via the diagonal
    re-index S_R(y,x,j) = S_L(y,x+d,j), d = min_disparity + j (§1.1).
    Returns true pixel units; out-of-range hypotheses are skipped."""
    H, W, D = S.shape
    SR = np.full((H, W, D), int(_BIG), dtype=np.int64)
    for j in range(D):
        d = cfg.min_disparity + j
        if d >= W:
            break
        SR[:, : W - d, j] = S[:, d:, j]
    return SR.argmin(axis=-1).astype(np.int32) + np.int32(cfg.min_disparity)


def lr_check_numpy(S: np.ndarray, d_int: np.ndarray, disp: np.ndarray,
                   cfg: Config) -> np.ndarray:
    """Validity mask from the LR consistency check (§1.1).

    Right disparity from the same volume: S_R(y,x,j) = S_L(y,x+d,j) with
    d = min_disparity + j.
    """
    H, W, D = S.shape
    if cfg.disp12_max_diff < 0:
        return np.ones((H, W), dtype=bool)
    d_r = right_disparity_numpy(S, cfg)
    xs = np.arange(W)[None, :]
    dl = np.round(disp).astype(np.int32)
    xr = xs - dl
    in_img = xr >= 0
    xr_c = np.clip(xr, 0, W - 1)
    dr_at = np.take_along_axis(d_r, xr_c, axis=1)
    ok = in_img & (np.abs(dl - dr_at) <= cfg.disp12_max_diff)
    return ok


def speckle_numpy(disp: np.ndarray, valid: np.ndarray, cfg: Config) -> np.ndarray:
    """Invalidate small 4-connected components (union-find on host)."""
    if cfg.speckle_window_size <= 0:
        return valid
    H, W = disp.shape
    parent = np.arange(H * W, dtype=np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    rng = float(cfg.speckle_range)
    idx = np.arange(H * W).reshape(H, W)
    # horizontal edges
    conn = valid[:, :-1] & valid[:, 1:] & (np.abs(disp[:, :-1] - disp[:, 1:]) <= rng)
    for a, b in zip(idx[:, :-1][conn], idx[:, 1:][conn]):
        union(a, b)
    conn = valid[:-1, :] & valid[1:, :] & (np.abs(disp[:-1, :] - disp[1:, :]) <= rng)
    for a, b in zip(idx[:-1, :][conn], idx[1:, :][conn]):
        union(a, b)
    roots = np.array([find(i) for i in range(H * W)])
    sizes = np.bincount(roots, minlength=H * W)
    big = sizes[roots].reshape(H, W) >= cfg.speckle_window_size
    return valid & big


def fill_background_numpy(disp: np.ndarray) -> np.ndarray:
    """Fill invalid (-1) pixels with the LOWER of the nearest valid left and
    right neighbours in the same row (Hirschmüller 2008 §V occlusion rule:
    occluded pixels belong to the background, i.e. the smaller disparity).
    Pixels with no valid neighbour on either side stay invalid."""
    H, W = disp.shape
    out = disp.copy()
    for y in range(H):
        left = np.float32(INVALID)
        lefts = np.empty(W, np.float32)
        for x in range(W):
            if disp[y, x] >= 0:
                left = disp[y, x]
            lefts[x] = left
        right = np.float32(INVALID)
        for x in range(W - 1, -1, -1):
            if disp[y, x] >= 0:
                right = disp[y, x]
                continue
            lv, rv = lefts[x], right
            if lv >= 0 and rv >= 0:
                out[y, x] = min(lv, rv)
            elif lv >= 0:
                out[y, x] = lv
            elif rv >= 0:
                out[y, x] = rv
    return out


def lr_hits_numpy(d_r: np.ndarray, cfg: Config) -> np.ndarray:
    """Epipolar-intersection map for occlusion/mismatch classification
    (Hirschmüller 2008 §V): hits[y,x] is True iff some right-image pixel
    claims correspondence with left pixel x — ∃ d in the search range with
    x-d >= 0 and |d_R(y, x-d) - d| <= disp12_max_diff. An invalid pixel
    whose line of sight is intersected this way is a MISMATCH (it is seen,
    but matched inconsistently); one with no intersection is an OCCLUSION."""
    H, W = d_r.shape
    diff = max(cfg.disp12_max_diff, 0)
    hits = np.zeros((H, W), dtype=bool)
    for y in range(H):
        for x in range(W):
            for j in range(cfg.num_disparities):
                d = cfg.min_disparity + j
                if x - d < 0:
                    break
                if abs(int(d_r[y, x - d]) - d) <= diff:
                    hits[y, x] = True
                    break
    return hits


_FILL_DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1),
              (-1, -1))


def fill_hirschmuller_numpy(disp: np.ndarray, mismatch: np.ndarray) -> np.ndarray:
    """Full Hirschmüller 2008 §V gap filling: for each invalid pixel collect
    the nearest valid disparity along each of the 8 directions, then fill
    occlusions with the SECOND-LOWEST value (the background rule must not
    bleed the occluder's foreground disparity; lowest if only one direction
    found a value) and mismatches with the LOWER MEDIAN (sorted[(k-1)//2] of
    the k values found). Pixels with no valid value in any direction stay
    invalid."""
    H, W = disp.shape
    out = disp.copy()
    for y in range(H):
        for x in range(W):
            if disp[y, x] >= 0:
                continue
            vals = []
            for dy, dx in _FILL_DIRS:
                yy, xx = y + dy, x + dx
                while 0 <= yy < H and 0 <= xx < W:
                    if disp[yy, xx] >= 0:
                        vals.append(disp[yy, xx])
                        break
                    yy += dy
                    xx += dx
            if not vals:
                continue
            vals.sort()
            if mismatch[y, x]:
                out[y, x] = vals[(len(vals) - 1) // 2]
            else:
                out[y, x] = vals[1] if len(vals) >= 2 else vals[0]
    return out


def median3_numpy(disp: np.ndarray) -> np.ndarray:
    """3x3 median with edge replication."""
    p = np.pad(disp, 1, mode="edge")
    taps = [p[dy : dy + disp.shape[0], dx : dx + disp.shape[1]]
            for dy in range(3) for dx in range(3)]
    return np.median(np.stack(taps, axis=0), axis=0).astype(disp.dtype)


# ---------------------------------------------------------------------------
# Full pipelines
# ---------------------------------------------------------------------------

def sgbm_numpy(left: np.ndarray, right: np.ndarray, cfg: Config,
               return_stages: bool = False):
    """End-to-end golden pipeline for all three modes. Returns float32
    disparity (invalid = -1.0); with return_stages=True also a dict of
    intermediates for per-stage parity tests."""
    assert left.dtype == np.uint8 and right.dtype == np.uint8
    stages = {}
    if cfg.mode == "sad":
        S = sad_volume_numpy(left, right, cfg.num_disparities, cfg.sad_block,
                             min_disp=cfg.min_disparity)
        stages["volume"] = S
    else:
        cl = census_numpy(left, cfg.census_window)
        cr = census_numpy(right, cfg.census_window)
        C = cost_volume_numpy(cl, cr, cfg.num_disparities, cfg.max_census_cost,
                              min_disp=cfg.min_disparity)
        stages["census_l"], stages["census_r"], stages["cost"] = cl, cr, C
        if cfg.mode == "census_wta":
            S = C.astype(np.int32)
        else:
            S = aggregate_numpy(C, cfg, left)
        stages["volume"] = S

    disp, d_int, valid = wta_numpy(S, cfg)
    stages["wta"] = (disp.copy(), d_int, valid.copy())
    valid = valid & lr_check_numpy(S, d_int, disp, cfg)
    stages["lr_valid"] = valid.copy()
    valid = speckle_numpy(disp, valid, cfg)
    stages["speckle_valid"] = valid.copy()
    disp = np.where(valid, disp, np.float32(INVALID)).astype(np.float32)
    if cfg.fill_mode == "background":
        disp = fill_background_numpy(disp)
    elif cfg.fill_mode == "hirschmuller":
        hits = lr_hits_numpy(right_disparity_numpy(S, cfg), cfg)
        stages["lr_hits"] = hits
        disp = fill_hirschmuller_numpy(disp, hits)
    if cfg.median_filter:
        disp = median3_numpy(disp)
    if return_stages:
        return disp, stages
    return disp
