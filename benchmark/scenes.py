"""Seeded layered stereo scenes, made on the device.

The texture and warp arithmetic is that of the port's `data/synthetic.py`
(a row-wise random texture, box-smoothed three times, plus two sinusoids,
sampled by linear interpolation; the right image resampled so that left
pixel (y, x) matches right pixel (y, x - d)), extended from one slanted
plane to layered scenes: each pair is a background plane, for a driving
scene a ground plane whose disparity rises toward the bottom rows and a
low-texture sky band over the top rows, and 3 to 6 nearer fronto-parallel
boxes. Each view shows, at each pixel, the layer with the largest
disparity there (the nearest), so the boxes occlude strips of what lies
behind them in one view and not in the other, and the LR check, speckle
and the labelling meet the work that real pairs give them.

Everything comes from the seed: the layout of each pair from a numpy
generator, the textures from a `torch.Generator` on the device, so the same
seed on the same device gives the same pairs. Every pool holds each box
count of the configuration's range equally often (in an order drawn from
the seed), so that seeds change the content and not the amount of it.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

OVERSAMPLE = 4
# the affine map of texture values to 0..255: the smoothed uniform lies in
# [0, 1] and the sinusoids add at most 0.5 either way
LO, HI = -0.5, 1.5


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def texture(H: int, span: int, g: torch.Generator, phase: float,
            device) -> torch.Tensor:
    """A continuous texture over columns [0, span) of H rows, as a fine
    grid of OVERSAMPLE samples a column: uniform noise box-smoothed three
    times along the row (wrapping), plus two sinusoids (`phase` shifts the
    first, so that layers differ)."""
    fine = torch.rand((H, span * OVERSAMPLE + OVERSAMPLE), generator=g,
                      device=device, dtype=torch.float32)
    k = 2 * OVERSAMPLE + 1
    for _ in range(3):
        acc = fine.clone()
        for s in range(1, k // 2 + 1):
            acc += torch.roll(fine, s, 1) + torch.roll(fine, -s, 1)
        fine = acc / k
    u = torch.arange(fine.shape[1], device=device,
                     dtype=torch.float32) / OVERSAMPLE
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    fine += 0.3 * torch.sin(2 * math.pi * u[None, :] / 23.0 + yy / 17.0
                            + phase)
    fine += 0.2 * torch.sin(2 * math.pi * u[None, :] / 7.3)
    return fine


def sample(tex: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The texture's rows at continuous columns u (H, W), linearly
    interpolated."""
    pos = (u * OVERSAMPLE).clamp(0, tex.shape[1] - 1 - 1e-3)
    i0 = pos.floor().long()
    frac = pos - i0
    return (tex.gather(1, i0) * (1 - frac)
            + tex.gather(1, i0 + 1) * frac)


def _u(lo_hi, rng) -> float:
    lo, hi = lo_hi
    return float(rng.uniform(lo, hi))


def layout(scene: dict, shape, D: int, n_boxes: int,
           rng: np.random.Generator) -> List[dict]:
    """The layers of one pair: dicts with "kind" ("plane", "ground" or
    "box") and its parameters, in pixels."""
    H, W = shape
    a = _u(scene["background"], rng) * D
    bx_max = min(scene["background_slope"], 0.4 * a / W)
    bx = _u((-bx_max, bx_max), rng)
    by = _u((-1, 1), rng) * min(scene.get("background_slope_y", 0.0),
                                0.4 * a / H)
    layers = [{"kind": "plane", "a": a, "bx": bx, "by": by,
               "cx": W / 2, "cy": H / 2}]
    y_top = 0
    if "ground_from" in scene:
        yh = _u(scene["ground_from"], rng) * H
        bottom = _u(scene["ground_bottom"], rng) * D
        layers.append({"kind": "ground", "yh": yh, "dh": a,
                       "bottom": bottom, "H": H})
        y_top = yh
    for _ in range(n_boxes):
        d = _u(scene["box_disparity"], rng) * D
        w = _u(scene["box_width"], rng) * W
        h = _u(scene["box_height"], rng) * H
        if y_top:      # standing on the ground, below the horizon
            y1 = y_top + _u((0.1, 1.0), rng) * (H - y_top)
        else:
            y1 = h + _u((0.0, 1.0), rng) * (H - h)
        x0 = _u((0.0, 1.0), rng) * (W - w)
        layers.append({"kind": "box", "d": d, "x0": x0, "x1": x0 + w,
                       "y0": max(0.0, y1 - h), "y1": y1})
    return layers


def _disparity(layer: dict, yy: torch.Tensor, x: torch.Tensor):
    """(disparity, covered) of a layer at left coordinates (yy, x)."""
    k = layer["kind"]
    if k == "plane":
        d = (layer["a"] + layer["bx"] * (x - layer["cx"])
             + layer["by"] * (yy - layer["cy"]))
        return d, torch.ones_like(d, dtype=torch.bool)
    if k == "ground":
        t = (yy - layer["yh"]) / (layer["H"] - 1 - layer["yh"])
        d = layer["dh"] + t * (layer["bottom"] - layer["dh"])
        return d.expand_as(x), (yy >= layer["yh"]).expand_as(x)
    cov = ((yy >= layer["y0"]) & (yy < layer["y1"])
           & (x >= layer["x0"]) & (x < layer["x1"]))
    return torch.full_like(x, layer["d"]), cov


def _left_column(layer: dict, yy: torch.Tensor, xr: torch.Tensor):
    """The left column x whose point of this layer lands on right column
    xr: x - d(x) = xr."""
    k = layer["kind"]
    if k == "plane":
        return ((xr + layer["a"] - layer["bx"] * layer["cx"]
                 + layer["by"] * (yy - layer["cy"])) / (1.0 - layer["bx"]))
    if k == "ground":
        t = ((yy - layer["yh"]) / (layer["H"] - 1 - layer["yh"]))
        return xr + layer["dh"] + t * (layer["bottom"] - layer["dh"])
    return xr + layer["d"]


def render(layers: List[dict], shape, D: int, scene: dict,
           g: torch.Generator, device):
    """(left, right) uint8 (H, W), the left view's true disparity float32
    and its occlusion mask (the point hidden or outside the right view)."""
    H, W = shape
    span = W + D + 4
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    x = torch.arange(W, device=device,
                     dtype=torch.float32)[None, :].expand(H, W)
    sky = int(scene.get("sky_rows", 0.0) * H)
    views = []
    for side in ("left", "right"):
        best = torch.full((H, W), -1.0, device=device)
        val = torch.zeros((H, W), device=device)
        views.append([best, val])
    for i, layer in enumerate(layers):
        tex = texture(H, span, g, phase=1.7 * i, device=device)
        if layer["kind"] == "plane" and sky:
            c = scene["sky_contrast"]
            tex[:sky] = 0.5 + c * (tex[:sky] - 0.5)
        for side, (best, val) in zip(("left", "right"), views):
            u = x if side == "left" else _left_column(layer, yy, x)
            d, cov = _disparity(layer, yy, u)
            cov = cov & (u >= 0) & (u < span - 1)
            take = cov & (d > best)
            best.copy_(torch.where(take, d, best))
            val.copy_(torch.where(take, sample(tex, u.expand(H, W)), val))
        del tex
    imgs = [((v - LO) / (HI - LO)).clamp(0, 1).mul(255).to(torch.uint8)
            for _, v in views]
    disp, right_disp = views[0][0], views[1][0]
    xr = (x - disp).round().long()
    inside = xr >= 0
    seen = right_disp.gather(1, xr.clamp(0, W - 1))
    occluded = ~inside | (seen > disp + 1.0)
    return imgs[0], imgs[1], disp, occluded


def make_pool(scene: dict, n: int, shape, D: int, seed: int,
              device) -> Dict[str, torch.Tensor]:
    """n pairs of (H, W) = shape: {"left", "right"} (n, H, W) uint8 and
    {"disp", "occluded"}, the left views' truth, plus "boxes", each pair's
    box count."""
    lo, hi = scene["boxes"]
    counts = [lo + i % (hi - lo + 1) for i in range(n)]
    rng = np.random.default_rng(seed % (1 << 64))
    counts = [counts[i] for i in rng.permutation(n)]
    g = _generator(seed, device)
    out = {k: [] for k in ("left", "right", "disp", "occluded")}
    for i in range(n):
        layers = layout(scene, shape, D, counts[i], rng)
        for k, v in zip(out, render(layers, shape, D, scene, g, device)):
            out[k].append(v)
    pool = {k: torch.stack(v) for k, v in out.items()}
    pool["boxes"] = torch.tensor(counts)
    return pool
