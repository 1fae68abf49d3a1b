"""Plain PyTorch reference of the SGM matcher: census, the Hamming cost
volume, the path aggregation over 4 or 8 directions, WTA with uniqueness and
the subpixel parabola, the left-right check, speckle and the 3x3 median.

It follows the loop-literal NumPy golden of the repository's specification
(the recurrences of SURVEY.md section 1.1: edge-replicated census with
bit k of the window walked row-major without its centre; hypotheses past
the left border cost the maximum; L_r(p, d) = C(p, d) + min(L(d),
L(d - 1) + P1, L(d + 1) + P1, min_k L + P2) - min_k L with a path's first
pixel restarting at L = C; ties of WTA to the smallest d; uniqueness
second * 100 < best * (100 + ratio) over |d - d*| > 1; the parabola's
offset clamped to +-0.5 and skipped at the range's ends; the LR check
against the right view's WTA of the same volume; speckle over 4-connected
components of valid pixels whose disparities differ by at most the range;
invalid = -1.0; the median last, with invalid pixels taking part). Each scan
step is one vectorised slab operation over frames and the line across the
scan, and the sums go straight into S, so a frame's volumes are one uint8
C and one int32 S.

It imports torch alone, and nothing of the program. `subpixel_dtype` is the
precision of the one floating stage, the parabola and the disparity it
gives: float32 as the configurations state, and bfloat16 for the control
(the same reference in the nearest precision below).

Scalar P2 only: a configuration with adaptive P2 is refused.
"""

from __future__ import annotations

import torch

BIG = 1 << 24
INVALID = -1.0
_POP8 = torch.tensor([bin(i).count("1") for i in range(256)],
                     dtype=torch.uint8)


def census(img: torch.Tensor, window) -> torch.Tensor:
    """(F, H, W) uint8 -> (F, H, W) int64 census words."""
    ch, cw = window
    ry, rx = ch // 2, cw // 2
    F, H, W = img.shape
    pad = torch.nn.functional.pad(img[:, None].float(), (rx, rx, ry, ry),
                                  mode="replicate")[:, 0].to(torch.uint8)
    out = torch.zeros((F, H, W), dtype=torch.int64, device=img.device)
    bit = 0
    for dy in range(-ry, ry + 1):
        for dx in range(-rx, rx + 1):
            if dy == 0 and dx == 0:
                continue
            q = pad[:, ry + dy:ry + dy + H, rx + dx:rx + dx + W]
            out |= (q < img).to(torch.int64) << bit
            bit += 1
    return out


def popcount(v: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64, by a table of the 8 bytes."""
    lut = _POP8.to(v.device)
    by = v.contiguous().view(torch.uint8).long()
    return lut[by].view(*v.shape, 8).sum(-1, dtype=torch.int32)


def cost_volume(cl: torch.Tensor, cr: torch.Tensor, D: int, max_cost: int,
                d0: int) -> torch.Tensor:
    """C[f, y, x, j] = popcount(cl[x] ^ cr[x - d0 - j]), max_cost where
    x - d0 - j < 0: (F, H, W) int64 x2 -> (F, H, W, D) uint8."""
    F, H, W = cl.shape
    C = torch.full((F, H, W, D), max_cost, dtype=torch.uint8,
                   device=cl.device)
    for j in range(D):
        d = d0 + j
        if d >= W:
            break
        C[:, :, d:, j] = popcount(cl[:, :, d:] ^ cr[:, :, :W - d]).to(
            torch.uint8)
    return C


def _step(prev: torch.Tensor, c: torch.Tensor, p1: int, p2: int):
    """One scan step over (..., N, D) int32: the new L from the
    predecessors' L and the raw costs c."""
    minprev = prev.amin(-1, keepdim=True)
    big = torch.full_like(prev[..., :1], BIG)
    up = torch.cat([prev[..., 1:], big], -1)
    dn = torch.cat([big, prev[..., :-1]], -1)
    cand = torch.minimum(prev, torch.minimum(up, dn) + p1)
    cand = torch.minimum(cand, minprev + p2)
    return c + cand - minprev


def add_path(S: torch.Tensor, C: torch.Tensor, dy: int, dx: int, p1: int,
             p2: int) -> None:
    """S += L_r of direction r = (dy, dx) over (F, H, W, D)."""
    F, H, W, D = C.shape
    if dy == 0:
        xs = range(W) if dx > 0 else range(W - 1, -1, -1)
        prev = None
        for x in xs:
            c = C[:, :, x].to(torch.int32)
            L = c if prev is None else _step(prev, c, p1, p2)
            S[:, :, x] += L
            prev = L
        return
    ys = range(H) if dy > 0 else range(H - 1, -1, -1)
    cols = torch.arange(W, device=C.device)[:, None]
    has_prev = (cols >= dx) if dx > 0 else (cols < W + dx)
    prev = None
    for y in ys:
        c = C[:, y].to(torch.int32)
        if prev is None:
            L = c
        else:
            if dx > 0:
                sh = torch.cat([prev[:, :dx], prev[:, :-dx]], 1)
            elif dx < 0:
                sh = torch.cat([prev[:, -dx:], prev[:, dx:]], 1)
            else:
                sh = prev
            L = _step(sh, c, p1, p2)
            if dx != 0:
                L = torch.where(has_prev, L, c)
        S[:, y] += L
        prev = L


DIRS_4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
DIRS_8 = DIRS_4 + ((1, 1), (1, -1), (-1, 1), (-1, -1))


def aggregate(C: torch.Tensor, cfg: dict) -> torch.Tensor:
    """S = the sum of L_r over the configuration's paths: int32."""
    S = torch.zeros(C.shape, dtype=torch.int32, device=C.device)
    for dy, dx in (DIRS_4 if cfg["paths"] == 4 else DIRS_8):
        add_path(S, C, dy, dx, cfg["p1"], cfg["p2"])
    return S


def wta(S: torch.Tensor, cfg: dict, subpixel_dtype=torch.float32):
    """(disp float32, valid bool) of WTA, uniqueness and the parabola."""
    D = S.shape[-1]
    iota = torch.arange(D, device=S.device, dtype=torch.int32)
    shift = 1 << max(1, (D - 1).bit_length())
    packed = (S * shift + iota).amin(-1)
    best = packed // shift
    j = packed % shift
    valid = torch.ones(best.shape, dtype=torch.bool, device=S.device)
    ratio = cfg["uniqueness_ratio"]
    if ratio > 0:
        near = (iota - j[..., None]).abs() <= 1
        second = torch.where(near, BIG, S).amin(-1)
        valid &= ~(second * 100 < best * (100 + ratio))
    d_int = j + cfg["min_disparity"]
    disp = d_int.to(subpixel_dtype)
    if cfg["subpixel"]:
        sm = S.gather(-1, (j - 1).clamp(min=0)[..., None].long())[..., 0]
        sp = S.gather(-1, (j + 1).clamp(max=D - 1)[..., None].long())[..., 0]
        sm, sp = sm.to(subpixel_dtype), sp.to(subpixel_dtype)
        s0 = best.to(subpixel_dtype)
        denom = sm - 2.0 * s0 + sp
        offs = torch.where(denom > 0,
                           (sm - sp) / torch.clamp(2.0 * denom, min=1e-9),
                           torch.zeros_like(denom))
        offs = offs.clamp(-0.5, 0.5)
        interior = (j > 0) & (j < D - 1)
        disp = disp + torch.where(interior, offs, torch.zeros_like(offs))
    return disp.to(torch.float32), valid


def right_disparity(S: torch.Tensor, d0: int) -> torch.Tensor:
    """d_R(x) = d0 + argmin_j S(x + d0 + j, j), ties to the smallest j,
    hypotheses past the right border skipped: (F, H, W) int32."""
    F, H, W, D = S.shape
    best = torch.full((F, H, W), 1 << 30, dtype=torch.int32, device=S.device)
    arg = torch.zeros((F, H, W), dtype=torch.int32, device=S.device)
    for j in range(D):
        d = d0 + j
        if d >= W:
            break
        v = S[:, :, d:, j]
        take = v < best[:, :, :W - d]
        best[:, :, :W - d] = torch.where(take, v, best[:, :, :W - d])
        arg[:, :, :W - d] = torch.where(take, j, arg[:, :, :W - d])
    return arg + d0


def lr_valid(S: torch.Tensor, disp: torch.Tensor, cfg: dict) -> torch.Tensor:
    """|d_L(x) - d_R(x - round(d_L(x)))| <= disp12_max_diff, the
    re-projected column inside the image."""
    if cfg["disp12_max_diff"] < 0:
        return torch.ones(disp.shape, dtype=torch.bool, device=disp.device)
    d_r = right_disparity(S, cfg["min_disparity"])
    W = disp.shape[-1]
    dl = torch.round(disp).to(torch.int64)
    xr = torch.arange(W, device=disp.device) - dl
    at = d_r.gather(-1, xr.clamp(0, W - 1)).to(torch.int64)
    return (xr >= 0) & ((dl - at).abs() <= cfg["disp12_max_diff"])


def components(conn_h: torch.Tensor, conn_v: torch.Tensor) -> torch.Tensor:
    """Labels of the 4-connected components of (F, H, W) pixels joined by
    conn_h (F, H, W - 1) and conn_v (F, H - 1, W): each pixel's component's
    smallest index in the flattened stack. Hook-and-jump to convergence:
    every root that an edge joins to a smaller root hooks under the
    smallest one, then every pointer jumps to its root."""
    F, H, Wm1 = conn_h.shape
    W = Wm1 + 1
    n = F * H * W
    idx = torch.arange(n, device=conn_h.device).view(F, H, W)
    a = torch.cat([idx[:, :, :-1][conn_h], idx[:, :-1, :][conn_v]])
    b = torch.cat([idx[:, :, 1:][conn_h], idx[:, 1:, :][conn_v]])
    lab = torch.arange(n, device=conn_h.device)
    while True:
        ra, rb = lab[a], lab[b]
        cross = ra != rb
        if not bool(cross.any()):
            return lab.view(F, H, W)
        a, b, ra, rb = a[cross], b[cross], ra[cross], rb[cross]
        lab.scatter_reduce_(0, torch.maximum(ra, rb), torch.minimum(ra, rb),
                            reduce="amin")
        while True:
            nxt = lab[lab]
            if torch.equal(nxt, lab):
                break
            lab = nxt


def speckle(disp: torch.Tensor, valid: torch.Tensor, cfg: dict):
    """valid minus the pixels of components under speckle_window_size."""
    if cfg["speckle_window_size"] <= 0:
        return valid
    rng = float(cfg["speckle_range"])
    conn_h = (valid[..., :-1] & valid[..., 1:]
              & ((disp[..., :-1] - disp[..., 1:]).abs() <= rng))
    conn_v = (valid[..., :-1, :] & valid[..., 1:, :]
              & ((disp[..., :-1, :] - disp[..., 1:, :]).abs() <= rng))
    lab = components(conn_h, conn_v).reshape(-1)
    size = torch.bincount(lab, minlength=lab.numel())[lab]
    return valid & (size >= cfg["speckle_window_size"]).view(valid.shape)


def median3(disp: torch.Tensor) -> torch.Tensor:
    """3x3 median of (F, H, W) with edge replication."""
    F, H, W = disp.shape
    p = torch.nn.functional.pad(disp[:, None], (1, 1, 1, 1),
                                mode="replicate")[:, 0]
    taps = torch.stack([p[:, dy:dy + H, dx:dx + W] for dy in range(3)
                        for dx in range(3)])
    return taps.sort(0).values[4]


def sgbm(left: torch.Tensor, right: torch.Tensor, cfg: dict,
         subpixel_dtype=torch.float32) -> torch.Tensor:
    """(F, H, W) uint8 x2 -> (F, H, W) float32 disparity, invalid -1.0,
    for a configuration's pinned fields (`cfg`, a dict)."""
    if cfg["mode"] != "sgm" or cfg.get("adaptive_p2", False):
        raise NotImplementedError("the reference covers SGM with a scalar P2")
    if cfg["fill_mode"] != "off":
        raise NotImplementedError("the reference covers fill_mode 'off'")
    window = tuple(cfg["census_window"])
    max_cost = window[0] * window[1] - 1
    C = cost_volume(census(left, window), census(right, window),
                    cfg["num_disparities"], max_cost, cfg["min_disparity"])
    S = aggregate(C, cfg)
    del C
    disp, valid = wta(S, cfg, subpixel_dtype)
    valid &= lr_valid(S, disp, cfg)
    del S
    valid = speckle(disp, valid, cfg)
    out = torch.where(valid, disp, torch.full_like(disp, INVALID))
    return median3(out) if cfg["median_filter"] else out


def sgbm_frames(left: torch.Tensor, right: torch.Tensor, cfg: dict,
                max_cells: int = 1 << 30, subpixel_dtype=torch.float32):
    """`sgbm` over (F, H, W) in blocks of frames of at most max_cells
    volume cells (at least one frame), so that the volumes fit."""
    F, H, W = left.shape
    per = max(1, max_cells // (H * W * cfg["num_disparities"]))
    return torch.cat([sgbm(left[i:i + per], right[i:i + per], cfg,
                           subpixel_dtype) for i in range(0, F, per)])
