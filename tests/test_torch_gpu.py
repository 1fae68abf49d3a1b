"""Card tests of the port: each CUDA kernel against its plain PyTorch
version on the card, and the pipeline on the card against the CPU. They
need a CUDA card and skip without one.

Run them on a machine with a card (no JAX needed there):

    python -m pytest -p no:cacheprovider --noconftest -o addopts="" \
        -m gpu tests/test_torch_gpu.py

Tolerance: integer outputs and the median bit-exact; float disparity
within 1e-6.

The mask helpers here import no JAX, so the CPU tests of the plain
versions (`test_torch_postproc.py`) use the same masks.
"""

import importlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from tpustereo_torch import Config, kernels
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.kernels.bitonic import (GLOBAL_M, TILE_LOG2,
                                             bitonic_sort_plain,
                                             kernel_launches, padded_log2)
from tpustereo_torch.kernels.cc import (TILE_COLS, TILE_ROWS,
                                        connected_component_labels_plain)
from tpustereo_torch.kernels.cost import census_cost_volume_plain
from tpustereo_torch.kernels.lr import (HITS_TILE, dr_consistency_hits_plain,
                                        dr_consistency_plain)
from tpustereo_torch.kernels.median import median3_plain
from tpustereo_torch.kernels.sad import sad_wta_plain
from tpustereo_torch.kernels.sgm import (bidir_fits_s16x2,
                                         sgm_sweep_bidir_plain,
                                         sgm_sweep_fused_plain,
                                         sgm_sweep_plain, sweep_bwd_wta_plain)
from tpustereo_torch.kernels.transpose import (transpose_hw_plain,
                                               transpose_sum_hw_plain)
from tpustereo_torch.kernels.wta import wta_lr_plain
from tpustereo_torch.ops import aggregate, component_big
from tpustereo_torch.ops.postproc import _right_disparity
from tpustereo_torch.ops.sgm import DIRS_8
from tpustereo_torch.pipeline import (select_and_refine, sgbm_batched,
                                      sgbm_volume)

pytestmark = pytest.mark.gpu


def _pinned_module():
    """`tests/test_torch_pinned_metrics.py`, loaded by its path (a package
    named `tests` may shadow this directory on the card machine): the
    stored points' suite and tolerances (`tpustereo.config` alone, no
    JAX) and `compute`, the port's metrics of a point."""
    spec = importlib.util.spec_from_file_location(
        "test_torch_pinned_metrics", os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "test_torch_pinned_metrics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PINNED = _pinned_module()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pairs(B, shape, seed=0):
    ps = [synthetic_pair(shape, disparity=5.0 + 2 * b, slope=0.03,
                         seed=seed + b)[:2] for b in range(B)]
    return (torch.from_numpy(np.stack([p[0] for p in ps])),
            torch.from_numpy(np.stack([p[1] for p in ps])))


def _hilbert_mask(order: int) -> np.ndarray:
    """One-pixel-wide path along the order-n Hilbert curve, drawn at 2x
    scale: (2*2^n, 2*2^n) bool, one component with O(4^n) bends (the curve
    of `tests/conftest.py:hilbert_path_mask`, which imports JAX)."""
    n = 1 << order
    cells = []
    for d in range(n * n):
        x = y = 0
        t, s = d, 1
        while s < n:
            rx = 1 & (t // 2)
            ry = 1 & (t ^ rx)
            if ry == 0:
                if rx == 1:
                    x, y = s - 1 - x, s - 1 - y
                x, y = y, x
            x += s * rx
            y += s * ry
            t //= 4
            s *= 2
        cells.append((y, x))
    mask = np.zeros((2 * n, 2 * n), bool)
    for (y0, x0), (y1, x1) in zip(cells, cells[1:]):
        mask[2 * y0, 2 * x0] = True
        mask[y0 + y1, x0 + x1] = True
    mask[2 * cells[-1][0], 2 * cells[-1][1]] = True
    return mask


def _serpentine_mask(H: int = 64, W: int = 32) -> np.ndarray:
    """One serpentine component: rungs every 8 rows joined at alternating
    sides (the mask of the banded serpentine test in `test_pallas.py`)."""
    v = np.zeros((H, W), bool)
    for k in range(H // 8):
        v[k * 8, :] = True
        col = W - 1 if k % 2 == 0 else 0
        v[k * 8:min(H, (k + 1) * 8) + 1, col] = True
    v[-1, :] = True
    return v


def _cc_masks(name: str) -> np.ndarray:
    """A named (H, W) or (F, H, W) valid mask for the labelling tests."""
    rng = np.random.default_rng(5)
    if name.startswith("p"):
        return rng.random((48, 64)) < float(name[1:])
    return {"hilbert": lambda: _hilbert_mask(4),
            "serpentine": _serpentine_mask,
            "h1": lambda: rng.random((1, 40)) < 0.7,
            "w1": lambda: rng.random((40, 1)) < 0.7,
            "frames3": lambda: rng.random((3, 37, 53)) < 0.6}[name]()


CC_MASKS = ["p0.3", "p0.55", "p0.7", "hilbert", "serpentine", "h1", "w1",
            "frames3"]


def _cc_tile_masks(name: str) -> np.ndarray:
    """Masks at the labelling kernel's tile borders (TILE_ROWS x
    TILE_COLS): widths a tile's width +- 1, heights a multiple of its rows
    +- 1, frames whose height no tile row divides, one component through
    every tile, a single pixel and a KITTI frame."""
    rng = np.random.default_rng(7)
    tr, tc = TILE_ROWS, TILE_COLS
    # the Hilbert mask's last row and column are empty, so cropping them
    # or padding keeps it one component
    hil = _hilbert_mask(max(3, (tc - 1).bit_length() - 1))
    if name == "hilbert_w-1":
        return hil[:-1, :-1]
    if name == "hilbert_w+1":
        return np.pad(hil, ((0, 2 * tr + 1 - hil.shape[0] % tr), (0, 1)))
    if name == "serp_w+1":
        return _serpentine_mask(4 * tr + 1, tc + 1)
    if name == "serp_w-1":
        return _serpentine_mask(4 * tr - 1, tc - 1)
    if name == "touch_all":
        v = rng.random((3 * tr + 5, 3 * tc + 7)) < 0.5
        v[:, 0] = True
        v[::5, :] = True
        return v
    if name == "frames3_tiles":
        v = rng.random((3, 2 * tr + 5, tc + 9)) < 0.6
        v[:, :, 3] = True
        return v
    if name == "px1":
        return np.ones((1, 1), bool)
    return rng.random((375, 1242)) < 0.62     # "kitti"


CC_TILE_MASKS = ["hilbert_w-1", "hilbert_w+1", "serp_w+1", "serp_w-1",
                 "touch_all", "frames3_tiles", "px1", "kitti"]


def _conn(v: np.ndarray):
    """Edge masks joining neighbouring set pixels of v (..., H, W)."""
    return (torch.from_numpy(v[..., :, :-1] & v[..., :, 1:]),
            torch.from_numpy(v[..., :-1, :] & v[..., 1:, :]))


def _volume(cuda, B, H, W, D, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 25, (B, H, W, D), dtype=np.uint8)).to(cuda)


# the census kernel's tiles are TY = 2 rows by TX = 256 columns; 9,000
# columns are past the 8,940 that its earlier, row-wide design took
@pytest.mark.parametrize("B,H,W", [(2, 23, 57), (1, 1, 1), (3, 5, 255),
                                   (1, 6, 256), (1, 3, 257), (1, 2, 9000)])
@pytest.mark.parametrize("D,d0,window", [
    (16, 0, (5, 5)), (30, 3, (5, 5)), (128, 0, (5, 5)), (200, 2, (5, 5)),
    (128, 0, (7, 9)), (16, 60, (7, 9)), (64, 5, (5, 13)), (30, 0, (1, 65))])
@pytest.mark.parametrize("max_cost", [None, 7])
def test_cost_kernel_matches_plain(cuda, B, H, W, D, d0, window, max_cost):
    """32-bit words (5x5) and 64-bit (7x9: 62 bits, 1x65: 64), D with and
    without 16 | D, d_start + D past W, widths around the tile's and past
    the old limit, B*H not a multiple of the tile's rows, and a max_cost
    below the window's bits."""
    L, R = _pairs(B, (H, W))
    L, R = L.to(cuda), R.to(cuda)
    bits = window[0] * window[1] - 1 if max_cost is None else max_cost
    got = kernels.census_cost_volume(L, R, D, bits, window, d0)
    ref = census_cost_volume_plain(L, R, D, bits, window, d0)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# (B, H, W): lines of every direction shorter than, equal to and one past
# the ring depth of 8 pixels, frames of 1 and 2 rows or columns, and the
# KITTI width
SWEEP_SHAPES = [(2, 19, 43), (1, 1, 1), (1, 1, 2), (1, 2, 1), (2, 2, 2),
                (2, 7, 9), (2, 8, 8), (3, 9, 7), (1, 3, 1242)]


@pytest.mark.parametrize("D", [16, 40, 128, 200, 512])
@pytest.mark.parametrize("direction", DIRS_8)
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
@pytest.mark.parametrize("form", ["add", "write"])
def test_sweep_kernel_matches_plain(cuda, D, direction, shape, form):
    """Both forms: S += L_r on a nonzero S, and S = L_r from S None. D = 40
    and 200 are not multiples of K, so they take the plain-load fill."""
    C = _volume(cuda, *shape, D)
    kernels.reset_launch_counts()
    if form == "add":
        got = torch.full(C.shape, 7, dtype=torch.int16, device=cuda)
        ref = got.clone()
        assert kernels.sgm_sweep(C, got, *direction, 10, 120) is got
        sgm_sweep_plain(C, ref, *direction, 10, 120)
    else:
        got = kernels.sgm_sweep(C, None, *direction, 10, 120)
        ref = sgm_sweep_plain(C, None, *direction, 10, 120)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert kernels.sgm_sweep.builds == dict(FORMS, **{form: 1})


FORMS = {"write": 0, "add": 0, "write_adaptive": 0, "add_adaptive": 0}


def _image(cuda, B, H, W, seed=0):
    """A left image of random bytes: gradients of every size, 0 included
    (a fifth of the pixels repeat their left neighbour)."""
    rng = np.random.default_rng(seed + 100)
    img = rng.integers(0, 256, (B, H, W), dtype=np.uint8)
    rep = rng.random((B, H, W)) < 0.2
    rep[..., 0] = False
    img[rep] = np.roll(img, 1, axis=-1)[rep]
    return torch.from_numpy(img).to(cuda)


@pytest.mark.parametrize("D", [16, 40, 128, 200, 512])
@pytest.mark.parametrize("direction", DIRS_8)
@pytest.mark.parametrize("shape", SWEEP_SHAPES + [(1, 70, 70)])
@pytest.mark.parametrize("form", ["add", "write"])
def test_sweep_kernel_adaptive_matches_plain(cuda, D, direction, shape,
                                             form):
    """Adaptive P2: the kernel's per-pixel P2' from the left image, in both
    forms, against the plain version; lines of 1 to 70 pixels (more than
    two groups of 32)."""
    C = _volume(cuda, *shape, D)
    img = _image(cuda, *shape)
    kernels.reset_launch_counts()
    S = (torch.full(C.shape, 7, dtype=torch.int16, device=cuda)
         if form == "add" else None)
    ref = sgm_sweep_plain(C, None if S is None else S.clone(), *direction,
                          10, 120, img)
    got = kernels.sgm_sweep(C, S, *direction, 10, 120, img)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert kernels.sgm_sweep.builds == dict(FORMS, **{form + "_adaptive": 1})


@pytest.mark.parametrize("direction", DIRS_8)
@pytest.mark.parametrize("p1,p2", [(40, 40), (0, 0), (3, 4000)])
def test_sweep_kernel_adaptive_p2_edges(cuda, direction, p1, p2):
    """P1 = P2 (every P2' is P1 + 1, above P2), P2 = 0, and a P2 whose
    quotients span 15 to 4000."""
    C = _volume(cuda, 2, 19, 43, 128, seed=4)
    img = _image(cuda, 2, 19, 43, seed=4)
    got = kernels.sgm_sweep(C, None, *direction, p1, p2, img)
    ref = sgm_sweep_plain(C, None, *direction, p1, p2, img)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose storage starts 8 bytes off 16."""
    pad = 8 // x.element_size()
    buf = torch.empty(x.numel() + pad, dtype=x.dtype, device=x.device)
    out = buf[pad:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 8
    return out


@pytest.mark.parametrize("form", ["add", "write"])
@pytest.mark.parametrize("direction", [(0, 1), (1, 0), (-1, 1)])
@pytest.mark.parametrize("D", [40, 128])
def test_sweep_kernel_takes_unaligned_volumes(cuda, form, direction, D):
    """C (and S) 8 bytes off 16: the plain-load fill and scalar stores."""
    C = _unaligned(_volume(cuda, 2, 19, 43, D, seed=3))
    S = (_unaligned(torch.full(C.shape, 5, dtype=torch.int16, device=cuda))
         if form == "add" else None)
    ref = sgm_sweep_plain(C, None if S is None else S.clone(), *direction,
                          10, 120)
    got = kernels.sgm_sweep(C, S, *direction, 10, 120)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    img = _image(cuda, 2, 19, 43, seed=3)
    S = None if S is None else torch.full_like(S, 5)
    ref = sgm_sweep_plain(C, None if S is None else S.clone(), *direction,
                          10, 120, img)
    got = kernels.sgm_sweep(C, S, *direction, 10, 120, img)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# (B, H, W): the fused kernel's tiles hold 24 columns (8 at D = 512) and
# exchange their edges every 8 rows: one row, one column, widths below, at
# and across a tile, heights below, at and across a band, several tiles and
# bands, the KITTI width
FUSED_SHAPES = [(1, 1, 1), (1, 1, 24), (2, 1, 40), (1, 8, 15), (2, 9, 16),
                (2, 17, 25), (1, 16, 8), (2, 19, 43), (3, 40, 33),
                (2, 25, 100), (1, 3, 1242)]
FUSED_DXS = [(0, 1, -1), (1, -1), (0,), (1,), (-1,), (-1, 0)]


@pytest.mark.parametrize("D", [16, 40, 128, 256, 512])
@pytest.mark.parametrize("dxs", FUSED_DXS)
@pytest.mark.parametrize("dy", [1, -1])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("form", ["add", "write"])
def test_fused_kernel_matches_plain(cuda, D, dxs, dy, shape, form):
    """Both forms of `sgm_sweep_fused` against its plain version, bit for
    bit; D = 40 is not a multiple of K (the plain-load fill)."""
    C = _volume(cuda, *shape, D, seed=21)
    kernels.reset_launch_counts()
    if form == "add":
        got = torch.full(C.shape, 7, dtype=torch.int16, device=cuda)
        ref = got.clone()
        assert kernels.sgm_sweep_fused(C, got, dy, dxs, 10, 120) is got
        sgm_sweep_fused_plain(C, ref, dy, dxs, 10, 120)
    else:
        got = kernels.sgm_sweep_fused(C, None, dy, dxs, 10, 120)
        ref = sgm_sweep_fused_plain(C, None, dy, dxs, 10, 120)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert kernels.sgm_sweep_fused.builds == dict(FORMS, **{form: 1})
    assert kernels.sgm_sweep_fused.launches == 1
    assert kernels.sgm_sweep.launches == 0


@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("dxs", [(0, 1, -1), (1, -1)])
@pytest.mark.parametrize("dy", [1, -1])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 9, 16), (2, 19, 43),
                                   (1, 70, 70), (1, 3, 1242)])
@pytest.mark.parametrize("form", ["add", "write"])
def test_fused_kernel_adaptive_matches_plain(cuda, D, dxs, dy, shape, form):
    """Adaptive P2: each direction's P2' from its own gradient."""
    C = _volume(cuda, *shape, D, seed=22)
    img = _image(cuda, *shape, seed=22)
    kernels.reset_launch_counts()
    S = (torch.full(C.shape, 7, dtype=torch.int16, device=cuda)
         if form == "add" else None)
    ref = sgm_sweep_fused_plain(C, None if S is None else S.clone(), dy, dxs,
                                10, 120, img)
    got = kernels.sgm_sweep_fused(C, S, dy, dxs, 10, 120, img)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert kernels.sgm_sweep_fused.builds == dict(
        FORMS, **{form + "_adaptive": 1})


@pytest.mark.parametrize("p1,p2", [(40, 40), (0, 0), (3, 4000), (10, 32000)])
@pytest.mark.parametrize("adaptive", [False, True])
def test_fused_kernel_penalty_edges(cuda, p1, p2, adaptive):
    """P1 = P2, P2 = 0, a P2 whose adaptive quotients span 15 to 4000, and
    255 + P2 just below 2^15 (the carry's int16 bound)."""
    C = _volume(cuda, 2, 19, 43, 128, seed=23)
    img = _image(cuda, 2, 19, 43, seed=23) if adaptive else None
    if adaptive and p2 == 32000:
        p1, p2 = 10, 32512 - 1
    for dy in (1, -1):
        got = kernels.sgm_sweep_fused(C, None, dy, (0, 1, -1), p1, p2, img)
        ref = sgm_sweep_fused_plain(C, None, dy, (0, 1, -1), p1, p2, img)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


def test_fused_kernel_refuses_a_carry_past_int16(cuda):
    C = _volume(cuda, 1, 4, 6, 16)
    with pytest.raises(ValueError, match="2\\^15"):
        kernels.sgm_sweep_fused(C, None, 1, (0,), 0, 32513)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.sgm_sweep_fused(C.transpose(1, 2), None, 1, (0,), 10, 120)


@pytest.mark.parametrize("form", ["add", "write"])
@pytest.mark.parametrize("D", [40, 128])
def test_fused_kernel_takes_unaligned_volumes(cuda, form, D):
    """C (and S) 8 bytes off 16: the plain-load fill and scalar stores."""
    C = _unaligned(_volume(cuda, 2, 19, 43, D, seed=24))
    img = _image(cuda, 2, 19, 43, seed=24)
    for im in (None, img):
        S = (_unaligned(torch.full(C.shape, 5, dtype=torch.int16,
                                   device=cuda)) if form == "add" else None)
        ref = sgm_sweep_fused_plain(C, None if S is None else S.clone(), -1,
                                    (0, 1, -1), 10, 120, im)
        got = kernels.sgm_sweep_fused(C, S, -1, (0, 1, -1), 10, 120, im)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


def test_fused_kernel_writes_into_out(cuda):
    C = _volume(cuda, 2, 19, 43, 128, seed=25)
    out = torch.full(C.shape, 3, dtype=torch.int16, device=cuda)
    got = kernels.sgm_sweep_fused(C, None, 1, (0, 1, -1), 10, 120, out=out)
    torch.cuda.synchronize()
    assert got is out
    assert torch.equal(out, sgm_sweep_fused_plain(C, None, 1, (0, 1, -1), 10,
                                                  120))


# frames with more tiles than the H100 holds blocks at once, so that each
# block walks several tiles band by band: D = 512 (8-column tiles) at the
# KITTI width and past 2,112 columns, D = 256 (24-column tiles) past 3,168
# and 6,336, D = 128 past 9,504; a last band shorter than 8 rows; frames
# walked one after another
@pytest.mark.parametrize("D,shape", [
    (512, (1, 375, 1242)), (512, (1, 27, 2500)), (256, (1, 375, 3200)),
    (256, (1, 19, 6400)), (128, (1, 17, 10000)), (512, (3, 20, 2500))])
@pytest.mark.parametrize("form", ["add", "write", "add_adaptive"])
def test_fused_kernel_wide_frames(cuda, D, shape, form):
    """Both orders; the int32 build at D = 512 and 256 and with dxs
    (1, -1), the s16x2 build at D = 128 with dxs (0, 1, -1)."""
    C = _volume(cuda, *shape, D, seed=27)
    img = _image(cuda, *shape, seed=27) if "adaptive" in form else None
    for dy, dxs in ((1, (0, 1, -1)), (-1, (1, -1))):
        S = (torch.full(C.shape, 7, dtype=torch.int16, device=cuda)
             if form.startswith("add") else None)
        ref = sgm_sweep_fused_plain(C, None if S is None else S.clone(), dy,
                                    dxs, 10, 120, img)
        got = kernels.sgm_sweep_fused(C, S, dy, dxs, 10, 120, img)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        del S, ref, got


@pytest.mark.parametrize("adaptive", [False, True])
def test_sgm_select_wide_frame_cuda_matches_plain(cuda, adaptive):
    """`sgm_select` and `aggregate_volume` with 8 paths at D = 512 on a
    KITTI-wide frame: past `FUSED_MAX_D` their y sweeps take the six
    one-direction launches (`vertical_orders`), decided from D."""
    C = _volume(cuda, 1, 375, 1242, 512, seed=28)
    img = _image(cuda, 1, 375, 1242, seed=28)
    cfg = Config(num_disparities=512, p1=10, p2=120, adaptive_p2=adaptive)
    im = img if adaptive else None
    kernels.reset_launch_counts()
    disp, valid, d_r = kernels.sgm_select(C, cfg, img)
    S = kernels.aggregate_volume(C, cfg, img)
    # sgm_select: six y launches and E; aggregate_volume: six, E and W
    assert kernels.sgm_sweep_fused.launches == 0
    assert kernels.sgm_sweep.launches == 7 + 8
    S7 = torch.zeros(C.shape, dtype=torch.int16, device=cuda)
    for dy, dx in DIRS_8:
        if (dy, dx) != (0, -1):
            sgm_sweep_plain(C, S7, dy, dx, cfg.p1, cfg.p2, im)
    disp_p, valid_p, d_r_p = sweep_bwd_wta_plain(C, S7, cfg, im)
    torch.cuda.synchronize()
    assert torch.equal(valid, valid_p) and torch.equal(d_r, d_r_p)
    assert (disp - disp_p).abs().max().item() <= 1e-6
    del S7, disp_p, valid_p, d_r_p
    assert torch.equal(S, aggregate(C, cfg, img))


@pytest.mark.parametrize("shape", [(4, 375, 1242), (1, 1988, 2964)])
def test_fused_kernel_full_size(cuda, shape):
    """KITTI at F = 4 and one Middlebury frame, both forms, both orders:
    the frames' tiles all resident, several frames in flight."""
    C = _volume(cuda, *shape, 128, seed=26)
    S = kernels.sgm_sweep_fused(C, None, 1, (0, 1, -1), 10, 120)
    kernels.sgm_sweep_fused(C, S, -1, (0, 1, -1), 10, 120)
    ref = sgm_sweep_fused_plain(C, None, 1, (0, 1, -1), 10, 120)
    sgm_sweep_fused_plain(C, ref, -1, (0, 1, -1), 10, 120)
    torch.cuda.synchronize()
    assert torch.equal(S, ref)


# the ring and chunk of bwd_wta: 32 columns a chunk, one warp a row, 4 rows
# a block at D <= 128 (B*H = 34 is not a multiple of 4)
@pytest.mark.parametrize("W", [1, 2, 31, 32, 33, 41, 1242])
@pytest.mark.parametrize("D,uniq,subpixel,d0,p2", [
    (16, 10, True, 0, 90), (16, 0, False, 0, 90), (40, 5, True, 3, 90),
    (128, 10, True, 0, 90), (200, 10, True, 2, 90), (3, 10, True, 0, 90),
    (256, 10, True, 1, 90), (512, 10, True, 0, 90), (128, 10, True, 0, 487),
    (41, 10, True, 0, 90)])
def test_bwd_wta_kernel_matches_plain(cuda, W, D, uniq, subpixel, d0, p2):
    """p2 = 487 is the fused route's bound at 8 paths and costs below 25:
    8 * (24 + 487) < 4096. D = 3 and 41 take the kernel's plain-load
    fill (D not a multiple of 4); D = 128, 256 and 512 its full-warp
    builds (D = 32 K)."""
    C = _volume(cuda, 2, 17, W, D, seed=1)
    cfg = Config(num_disparities=D, uniqueness_ratio=uniq,
                 subpixel=subpixel, min_disparity=d0, p1=7, p2=p2)
    S7 = torch.zeros(C.shape, dtype=torch.int16, device=cuda)
    for dy, dx in DIRS_8:
        if (dy, dx) != (0, -1):
            sgm_sweep_plain(C, S7, dy, dx, cfg.p1, cfg.p2)
    disp, valid, d_r = kernels.sweep_bwd_wta(C, S7, cfg)
    disp_p, valid_p, d_r_p = sweep_bwd_wta_plain(C, S7, cfg)
    torch.cuda.synchronize()
    assert torch.equal(valid, valid_p)
    assert torch.equal(d_r, d_r_p)
    assert (disp - disp_p).abs().max().item() <= 1e-6


@pytest.mark.parametrize("W", [1, 2, 31, 32, 33, 41, 64, 65, 1242])
@pytest.mark.parametrize("D,d0,p1,p2", [
    (16, 0, 7, 90), (40, 3, 7, 90), (128, 0, 10, 120), (128, 2, 40, 40),
    (200, 2, 7, 90), (3, 0, 7, 90), (256, 1, 10, 120), (512, 0, 10, 120),
    (128, 0, 7, 487), (41, 0, 7, 90)])
def test_bwd_wta_kernel_adaptive_matches_plain(cuda, W, D, d0, p1, p2):
    """Adaptive P2 in the W sweep: the chunks' image bytes across chunk
    edges (W past 32 and 64), every build, and P1 = P2; S7 from the other
    seven adaptive sweeps."""
    C = _volume(cuda, 2, 17, W, D, seed=5)
    img = _image(cuda, 2, 17, W, seed=5)
    cfg = Config(num_disparities=D, min_disparity=d0, p1=p1, p2=p2,
                 adaptive_p2=True)
    S7 = torch.zeros(C.shape, dtype=torch.int16, device=cuda)
    for dy, dx in DIRS_8:
        if (dy, dx) != (0, -1):
            sgm_sweep_plain(C, S7, dy, dx, p1, p2, img)
    kernels.reset_launch_counts()
    disp, valid, d_r = kernels.sweep_bwd_wta(C, S7, cfg, img)
    assert kernels.sweep_bwd_wta.builds == {"scalar": 0, "adaptive": 1}
    disp_p, valid_p, d_r_p = sweep_bwd_wta_plain(C, S7, cfg, img)
    torch.cuda.synchronize()
    assert torch.equal(valid, valid_p)
    assert torch.equal(d_r, d_r_p)
    assert (disp - disp_p).abs().max().item() <= 1e-6


def test_bwd_wta_refuses_adaptive_sums_past_int16(cuda):
    """Under adaptive P2 the refusal bounds P2 by max(P2, P1 + 1): P1 = P2
    = 3840 runs scalar (8 * (255 + 3840) < 2^15) and is refused adaptive."""
    C = _volume(cuda, 1, 4, 40, 16)
    img = _image(cuda, 1, 4, 40)
    S7 = torch.zeros(C.shape, dtype=torch.int16, device=cuda)
    cfg = Config(num_disparities=16, p1=3840, p2=3840)
    kernels.sweep_bwd_wta(C, S7, cfg)
    with pytest.raises(ValueError, match="2\\^15"):
        kernels.sweep_bwd_wta(C, S7, cfg.replace(adaptive_p2=True), img)


@pytest.mark.parametrize("H,W,D", [(40, 72, 32), (6, 20, 32)])
@pytest.mark.parametrize("d0", [0, 3])
@pytest.mark.parametrize("max_diff", [0, 1, 2])
def test_lr_kernel_matches_plain(cuda, H, W, D, d0, max_diff):
    rng = np.random.default_rng(2)
    d_r = torch.from_numpy(rng.integers(0, D, (H, W), dtype=np.int32))
    disp = torch.from_numpy(rng.uniform(d0 - 0.5, d0 + D - 0.5, (H, W))
                            .astype(np.float32))
    d_r, disp = d_r.to(cuda), disp.to(cuda)
    got = kernels.dr_consistency(d_r, disp, D, max_diff, d0)
    ref = dr_consistency_plain(d_r, disp, D, max_diff, d0)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("B,H,W,D", [(2, 40, 72, 32), (2, 6, 20, 32),
                                     (1, 1, 1, 8), (4, 375, 1242, 128),
                                     (1, 2, 60000, 16), (3, 5, 1, 8),
                                     (2, 3, HITS_TILE - 1, 32),
                                     (2, 3, HITS_TILE, 32),
                                     (2, 3, HITS_TILE + 1, 128),
                                     (1, 2, 5000, HITS_TILE + 300),
                                     (1, 4, 240000, 128)])
@pytest.mark.parametrize("d0", [0, 5])
@pytest.mark.parametrize("max_diff", [0, 1, 2, 600])
def test_lr_hits_kernel_matches_plain(cuda, B, H, W, D, d0, max_diff):
    """The hits kernel, d_r values out of range included: rows of 1 and of
    the kernel's tile of HITS_TILE pixels and one either side (tiles that
    span rows), D past the tile (a halo staged in turns), max_diff past D,
    and 240,000 columns, past the 232,448 bytes of shared memory that its
    earlier design kept a row in."""
    rng = np.random.default_rng(15)
    d_r = torch.from_numpy(rng.integers(-3, D + 3, (B, H, W),
                                        dtype=np.int32)).to(cuda)
    disp = torch.from_numpy(rng.uniform(d0 - 0.5, d0 + D - 0.5, (B, H, W))
                            .astype(np.float32)).to(cuda)
    kernels.reset_launch_counts()
    ok, hits = kernels.dr_consistency_hits(d_r, disp, D, max_diff, d0)
    assert kernels.launch_counts()["dr_consistency_hits"] == 1
    ok_p, hits_p = dr_consistency_hits_plain(d_r, disp, D, max_diff, d0)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_p)
    assert torch.equal(hits, hits_p)
    assert torch.equal(ok, kernels.dr_consistency(d_r, disp, D, max_diff,
                                                  d0))


_TILE = 1 << TILE_LOG2


@pytest.mark.parametrize("rows,n", [
    (1, 1), (1, 100), (1, 256), (3, 5000), (1, 4096), (2, 4097),
    (4, 465750), (1, 1 << 19),
    # the shared-memory tile's edges, and stages past it whose count of
    # global substages is and is not a multiple of GLOBAL_M
    (2, _TILE // 2), (3, _TILE), (2, _TILE + 1), (1, 1 << 15),
    (2, 1 << 17), (1, (1 << 20) + 1)])
@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("order", ["dup", "equal", "descending"])
def test_bitonic_kernel_matches_plain(cuda, rows, n, payload, order):
    """Keys with heavy duplication (the speckle labels' regime), all equal
    (every compare a tie) and descending, and the payload order, at the
    KITTI frame's 465,750, at powers of two and around the tile."""
    rng = np.random.default_rng(16)
    if order == "dup":
        k = rng.integers(0, max(2, n // 50), (rows, n), dtype=np.int32)
    elif order == "equal":
        k = np.full((rows, n), 7, np.int32)
    else:
        k = np.sort(rng.integers(-n, n, (rows, n), dtype=np.int32))[:, ::-1]
    k = torch.from_numpy(k.copy()).to(cuda)
    p = (torch.arange(n, dtype=torch.int32, device=cuda).expand(rows, n)
         if payload else None)
    kernels.reset_launch_counts()
    got = kernels.bitonic_sort(k, p)
    assert kernels.launch_counts()["bitonic_sort"] == 1
    L = padded_log2(n)
    t = min(L, TILE_LOG2)
    assert kernel_launches(n) == 1 + sum(
        -(-(kk - t) // GLOBAL_M) + 1 for kk in range(t + 1, L + 1))
    ref = bitonic_sort_plain(k, p)
    torch.cuda.synchronize()
    if payload:
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert torch.equal(k.gather(1, got[1].long()), got[0])
    else:
        assert torch.equal(got, ref)
        assert torch.equal(got, k.sort(dim=1).values)


# (H, W, D) of the selection kernel: a tile is up to 128 pixels of a row
# (49 at int32 D = 512); W = 30,000 is past the 25,827 columns of the
# earlier design's shared-memory row map
WTA_SHAPES = [(17, 41, 16), (1, 45, 32), (9, 20, 40), (5, 37, 512),
              (6, 200, 128), (1, 30000, 16), (3, 127, 128), (2, 128, 200),
              (2, 129, 3), (3, 49, 512), (2, 50, 40)]


@pytest.mark.parametrize("H,W,D", WTA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
@pytest.mark.parametrize("d0,d12", [(0, 1), (3, -1), (3, 0)])
def test_wta_lr_right_map_matches_plain(cuda, H, W, D, dtype, d0, d12):
    rng = np.random.default_rng(17)
    top = {torch.uint8: 25, torch.int16: 1000, torch.int32: 1 << 20}[dtype]
    S = torch.from_numpy(rng.integers(0, top, (2, H, W, D))).to(dtype)
    S = S.to(cuda)
    cfg = Config(num_disparities=D, min_disparity=d0, disp12_max_diff=d12)
    disp, valid, d_R = kernels.wta_lr(S, cfg, with_dr=True)
    disp_p, valid_p = wta_lr_plain(S, cfg)
    torch.cuda.synchronize()
    assert torch.equal(d_R, _right_disparity(S, d0))
    assert torch.equal(valid, valid_p)
    assert (disp - disp_p).abs().max().item() <= 1e-6


@pytest.mark.parametrize("name", CC_MASKS + CC_TILE_MASKS)
def test_cc_kernel_matches_plain(cuda, name):
    v = (_cc_masks if name in CC_MASKS else _cc_tile_masks)(name)
    conn_h, conn_v = _conn(v)
    got = kernels.connected_component_labels(conn_h.to(cuda),
                                             conn_v.to(cuda))
    torch.cuda.synchronize()
    ref = connected_component_labels_plain(conn_h, conn_v)
    assert torch.equal(got.cpu(), ref)
    if name in ("hilbert", "serpentine", "hilbert_w-1", "hilbert_w+1",
                "serp_w+1"):
        assert got.cpu()[torch.from_numpy(v)].unique().numel() == 1
    if name == "touch_all":
        # pixel (0, 0)'s component reaches into every tile
        one = (got.cpu() == 0).numpy()
        H, W = v.shape
        assert all(one[y:y + TILE_ROWS, x:x + TILE_COLS].any()
                   for y in range(0, H, TILE_ROWS)
                   for x in range(0, W, TILE_COLS))


def test_cc_kernel_full_middlebury_frame(cuda):
    # 1988 x 2964, the size at which the TPU kernel had to go banded
    rng = np.random.default_rng(6)
    v = rng.random((1988, 2964)) < 0.62
    v[:, 7] = True                  # one component spanning every row
    conn_h, conn_v = (c.to(cuda) for c in _conn(v))
    got = kernels.connected_component_labels(conn_h, conn_v)
    ref = connected_component_labels_plain(conn_h, conn_v)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _big_plain(conn_h, conn_v, valid, threshs):
    """[valid & `component_big` of the plain labels offset by f*H*W, for
    each threshold]."""
    lab = connected_component_labels_plain(conn_h, conn_v)
    H, W = lab.shape[-2:]
    F = lab.numel() // (H * W)
    base = torch.arange(0, F * H * W, H * W, dtype=torch.int32,
                        device=lab.device)
    lab = lab.reshape(F, H * W) + base[:, None]
    return [valid & component_big(lab, t).reshape(valid.shape)
            for t in threshs]


# (F, H, W, mask kind): one component filling each frame (every edge set:
# the contention case), a checkerboard of singletons (no edge), random
# masks; frames of 1, 3 and 4, sizes off the 16 x 128 tile and on it, the
# KITTI and the Middlebury frame
BIG_CASES = {
    "one_f1": (1, 33, 130, "one"), "one_f4_kitti": (4, 375, 1242, "one"),
    "checker_f3": (3, 47, 383, "checker"), "random_f3": (3, 33, 130, 0.6),
    "random_f4": (4, 17, 257, 0.55), "tile_f1": (1, 16, 128, 0.6),
    "px1": (1, 1, 1, "one"), "row_f3": (3, 1, 300, 0.7),
    "col_f3": (3, 300, 1, 0.7), "kitti_f4": (4, 375, 1242, 0.62),
    "middlebury_f1": (1, 1988, 2964, 0.62)}


@pytest.mark.parametrize("name", BIG_CASES)
def test_cc_big_matches_component_big(cuda, name):
    F, H, W, kind = BIG_CASES[name]
    rng = np.random.default_rng(12)
    if kind == "one":
        v = np.ones((F, H, W), bool)
    elif kind == "checker":
        v = (np.indices((F, H, W)).sum(0) % 2).astype(bool)
    else:
        v = rng.random((F, H, W)) < kind
    conn_h, conn_v = (c.to(cuda) for c in _conn(v))
    valid = torch.from_numpy(rng.random((F, H, W)) < 0.95).to(cuda)
    threshs = (1, 2, 100, H * W + 1)
    for thresh, ref in zip(threshs, _big_plain(conn_h, conn_v, valid,
                                               threshs)):
        kernels.reset_launch_counts()
        got = kernels.connected_component_big(conn_h, conn_v, valid, thresh)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), thresh
        assert kernels.launch_counts()["connected_component_big"] == 1
    if F == 1:      # (H, W) inputs alike
        got = kernels.connected_component_big(conn_h[0], conn_v[0],
                                              valid[0], 100)
        assert torch.equal(got, _big_plain(conn_h[0], conn_v[0], valid[0],
                                           (100,))[0])


def _scene_speckle(cuda, preset, **scene_kw):
    """(disp, valid) of the preset's selection and LR check on 4 pairs of
    its benchmark scene (`benchmark/scenes.py`, the cell's configuration
    file), the speckle filter's inputs on the card's route."""
    from benchmark import scenes
    from tpustereo_torch import PRESETS
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           f"{preset}.json")) as f:
        spec = json.load(f)
    cfg = PRESETS[preset]
    pool = scenes.make_pool(dict(spec["scene"], **scene_kw), 4,
                            tuple(spec["shape"]), cfg.num_disparities, 2026,
                            cuda)
    L, R = pool["left"], pool["right"]
    D, d0 = cfg.num_disparities, cfg.min_disparity
    C = kernels.census_cost_volume(L, R, D, cfg.max_census_cost,
                                   cfg.census_window, d0)
    disp, valid, d_r = kernels.sgm_select(C, cfg, L)
    valid &= kernels.dr_consistency(d_r, disp, D, cfg.disp12_max_diff, d0)
    return cfg, disp, valid


def test_cc_big_low_texture_scene(cuda):
    """A KITTI scene whose low-texture band covers the top 60 % of rows:
    the many small components that a weak texture leaves."""
    from tpustereo_torch.ops.postproc import speckle_conn
    cfg, disp, valid = _scene_speckle(cuda, "kitti_sgm8", sky_rows=0.6)
    conn_h, conn_v = speckle_conn(disp, valid, cfg)
    labels = kernels.connected_component_labels(conn_h, conn_v)
    assert labels[valid].unique().numel() > 300
    threshs = (1, 2, cfg.speckle_window_size, 375 * 1242 + 1)
    for thresh, ref in zip(threshs, _big_plain(conn_h, conn_v, valid,
                                               threshs)):
        got = kernels.connected_component_big(conn_h, conn_v, valid, thresh)
        assert torch.equal(got, ref), thresh


@pytest.mark.parametrize("preset", ["kitti_sgm8", "middlebury_sgm4"])
@pytest.mark.parametrize("bitonic", [False, True])
def test_speckle_frames_of_scenes_unchanged(cuda, monkeypatch, preset,
                                            bitonic):
    """`speckle_frames` as the pipeline calls it, with BITONIC_SPECKLE off
    (the size count) and on (labels and the bitonic sort), equal to the
    labels and `component_big`, on 4 frames of the preset's scene."""
    from tpustereo_torch.ops import postproc
    cfg, disp, valid = _scene_speckle(cuda, preset)
    ref = postproc.speckle_frames(disp, valid, cfg,
                                  cc=kernels.connected_component_labels)
    monkeypatch.setattr(postproc, "BITONIC_SPECKLE", bitonic)
    kernels.reset_launch_counts()
    got = postproc.speckle_frames(disp, valid, cfg,
                                  cc=kernels.connected_component_labels,
                                  sort=kernels.bitonic_sort,
                                  big=kernels.connected_component_big)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert (got != valid).any()         # the filter removed something
    assert counts["connected_component_big"] == (0 if bitonic else 1)
    assert counts["connected_component_labels"] == (1 if bitonic else 0)


def _median_map(kind: str, shape, rng) -> np.ndarray:
    if kind == "random":  # disparities, 30 % invalid
        d = rng.uniform(0, 60, shape).astype(np.float32)
        d[rng.random(shape) < 0.3] = -1.0
    elif kind == "signed_zeros":  # +-0.0 meet in most windows, and repeats
        d = rng.choice(np.array([0.0, -0.0, 0.0, -0.0, 1.0, -1.0, 2.0],
                                dtype=np.float32), shape)
    elif kind == "constant":
        d = np.full(shape, 17.25, np.float32)
    else:  # every pixel invalid
        d = np.full(shape, -1.0, np.float32)
    return d


# the kernel's tiles are 8 rows x 128 columns, each lane 4 adjacent
# pixels from where its row's output is 16-byte aligned: widths 1-33 and
# 1242 put the rows at every alignment and the tiles' edges anywhere
MEDIAN_SHAPES = ([(40, 72), (1, 17), (2, 9), (13, 1), (11, 2), (3, 21, 37),
                  (2, 1, 1), (4, 375, 1242)]
                 + [(2, 5, w) for w in range(1, 34)] + [(3, 9, 1242)])


@pytest.mark.parametrize("shape", MEDIAN_SHAPES)
@pytest.mark.parametrize("kind", ["random", "signed_zeros", "constant",
                                  "invalid"])
def test_median_kernel_matches_plain(cuda, shape, kind):
    d = _median_map(kind, shape, np.random.default_rng(7))
    x = torch.from_numpy(d).to(cuda)
    got = kernels.median3(x)
    ref = median3_plain(x)
    torch.cuda.synchronize()
    assert got.shape == x.shape
    # bit for bit: -0.0 and +0.0 differ
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_median_kernel_takes_unaligned_maps(cuda):
    d = _median_map("signed_zeros", (3, 7, 13), np.random.default_rng(8))
    x = torch.from_numpy(d).to(cuda)[1:]  # 91 floats in: not 16-byte aligned
    got = kernels.median3(x)
    ref = median3_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


# (d0, uniqueness, subpixel, disp12_max_diff): min_disparity 0/3,
# uniqueness 0/10, subpixel on/off, LR off/on at max_diff 0, 1, 2
SELECT_KNOBS = [(0, 10, True, 1), (3, 0, False, -1), (3, 10, True, 0),
                (0, 0, True, 2), (3, 10, False, 1)]


@pytest.mark.parametrize("H,W,D", WTA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
@pytest.mark.parametrize("knobs", SELECT_KNOBS)
def test_wta_lr_kernel_matches_plain(cuda, H, W, D, dtype, knobs):
    d0, uniq, subpixel, d12 = knobs
    rng = np.random.default_rng(3)
    # census-like ties / S / SAD costs up to the int32 limit of 2^20
    top = {torch.uint8: 25, torch.int16: 1000, torch.int32: 1 << 20}[dtype]
    S = torch.from_numpy(rng.integers(0, top, (2, H, W, D))).to(dtype)
    S = S.to(cuda)
    cfg = Config(num_disparities=D, min_disparity=d0, uniqueness_ratio=uniq,
                 subpixel=subpixel, disp12_max_diff=d12)
    disp, valid = kernels.wta_lr(S, cfg)
    disp_p, valid_p = wta_lr_plain(S, cfg)
    torch.cuda.synchronize()
    assert torch.equal(valid, valid_p)
    assert (disp - disp_p).abs().max().item() <= 1e-6


# (frames, (H, W), D) of the tiled kernel (tiles of 16 rows x 64 columns,
# planes in chunks of 32): widths 1 and the tile's 63, 64, 65; row counts
# no multiple of 16; d0 + D > W; D = 1024 (tiles of 8 x 32: 16 x 64
# overflows shared memory); W = 4096, the widest that `sad_wta_fits`
# admits at block 9; 8 frames in one launch
SAD_SHAPES = [(2, (23, 57), 16), (2, (1, 45), 32), (2, (9, 20), 40),
              (2, (12, 70), 512), (2, (30, 100), 64), (2, (13, 1), 16),
              (2, (11, 63), 32), (2, (9, 64), 40), (2, (10, 65), 64),
              (1, (3, 4096), 64), (8, (19, 45), 64), (1, (20, 100), 1024)]


@pytest.mark.parametrize("B,shape,D", SAD_SHAPES)
@pytest.mark.parametrize("block", [5, 9, 13, 8])
@pytest.mark.parametrize("knobs", SELECT_KNOBS)
def test_sad_wta_kernel_matches_plain(cuda, B, shape, D, block, knobs):
    d0, uniq, subpixel, d12 = knobs
    L, R = _pairs(B, shape, seed=4)
    L, R = L.to(cuda), R.to(cuda)
    cfg = Config(mode="sad", num_disparities=D, sad_block=block,
                 min_disparity=d0, uniqueness_ratio=uniq, subpixel=subpixel,
                 disp12_max_diff=d12)
    disp, valid, d_r = kernels.sad_wta(L, R, cfg)
    disp_p, valid_p, d_r_p = sad_wta_plain(L, R, cfg)
    torch.cuda.synchronize()
    assert torch.equal(valid, valid_p)
    assert (disp - disp_p).abs().max().item() <= 1e-6
    if d12 < 0:
        assert d_r is None and d_r_p is None
    else:
        assert torch.equal(d_r, d_r_p)


# (D, dtype): uint8 and int16, runs of 16-byte multiples and odd runs
TRANSPOSE_CASES = [(128, torch.uint8), (37, torch.uint8), (3, torch.uint8),
                   (128, torch.int16), (64, torch.int16), (37, torch.int16),
                   (4, torch.int16)]


@pytest.mark.parametrize("D,dtype", TRANSPOSE_CASES)
@pytest.mark.parametrize("B,H,W", [(2, 19, 43), (3, 1, 7), (1, 300, 2)])
def test_transpose_kernel_matches_plain(cuda, B, H, W, D, dtype):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(-3000, 3000, (B, H, W, D))).to(dtype)
    x = x.to(cuda)
    got = kernels.transpose_hw(x)
    torch.cuda.synchronize()
    assert got.is_contiguous()
    assert torch.equal(got, transpose_hw_plain(x))


@pytest.mark.parametrize("D", [128, 64, 37, 4, 1])
@pytest.mark.parametrize("B,H,W", [(2, 19, 43), (1, 300, 2)])
def test_transpose_sum_kernel_matches_plain(cuda, B, H, W, D):
    rng = np.random.default_rng(9)
    a, b = (torch.from_numpy(rng.integers(-32768, 32767, (B, H, W, D),
                                          dtype=np.int16)).to(cuda)
            for _ in range(2))          # some sums wrap
    got = kernels.transpose_sum_hw(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, transpose_sum_hw_plain(a, b))


# (D, P2, the build that must run), at P1 = 10: the s16x2 build where every
# lane is full (D = 32 K) at the preset's P2, the int32 build elsewhere
# (D = 37: plain loads into the ring, scalar stores) and past the packed
# halves' range (P2 = 32,700: 255 + 10 + 32,700 >= 2^15; the sums wrap)
BIDIR_CASES = [(16, 120, "int32"), (40, 120, "int32"), (128, 120, "s16x2"),
               (200, 120, "int32"), (64, 120, "s16x2"), (32, 120, "s16x2"),
               (256, 120, "s16x2"), (512, 120, "s16x2"), (37, 120, "int32"),
               (128, 32700, "int32")]


@pytest.mark.parametrize("D,p2,build", BIDIR_CASES)
@pytest.mark.parametrize("dxs", [(0, 1, -1), (0,), (1,), (-1, 0)])
@pytest.mark.parametrize("H,W", [(19, 43), (37, 6), (1, 9)])
def test_bidir_kernel_matches_plain(cuda, D, p2, build, dxs, H, W):
    C = _volume(cuda, 2, H, W, D, seed=11)
    kernels.reset_launch_counts()
    Sd, Su = kernels.sgm_sweep_bidir(C, dxs, 10, p2)
    builds = dict(kernels.sgm_sweep_bidir.builds)
    Sd_p, Su_p = sgm_sweep_bidir_plain(C, dxs, 10, p2)
    torch.cuda.synchronize()
    assert torch.equal(Sd, Sd_p)
    assert torch.equal(Su, Su_p)
    assert (build == "s16x2") == bidir_fits_s16x2(D, 255, 10, p2)
    assert builds == {"s16x2": 0, "int32": 0, build: len(dxs)}


def test_bidir_kernel_takes_unaligned_volumes(cuda):
    # the second frame of 19 x 43 x 40 bytes starts 8 bytes off 16
    C = _volume(cuda, 3, 19, 43, 40, seed=14)[1:]
    assert C.data_ptr() % 16 == 8
    Sd, Su = kernels.sgm_sweep_bidir(C, (0, 1, -1), 10, 120)
    Sd_p, Su_p = sgm_sweep_bidir_plain(C, (0, 1, -1), 10, 120)
    torch.cuda.synchronize()
    assert torch.equal(Sd, Sd_p) and torch.equal(Su, Su_p)


@pytest.mark.parametrize("paths", [4, 8])
def test_aggregate_volume_cuda_matches_plain(cuda, paths):
    C = _volume(cuda, 2, 23, 57, 48, seed=12)
    cfg = Config(num_disparities=48, paths=paths, p1=7, p2=90)
    got = kernels.aggregate_volume(C, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, aggregate(C, cfg))


def test_bidir_vert_route_cuda_matches_default(cuda, monkeypatch):
    L, R = _pairs(4, (33, 49), seed=13)
    L, R = L.to(cuda), R.to(cuda)
    cfg = Config(num_disparities=32, speckle_window_size=100,
                 speckle_range=2, frames_per_step=2)
    ref = sgbm_batched(L, R, cfg)
    monkeypatch.setattr(importlib.import_module(
        "tpustereo_torch.kernels.sgm"), "BIDIR_VERT", True)
    kernels.reset_launch_counts()
    got = sgbm_batched(L, R, cfg)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert counts["sgm_sweep_bidir"] == 2 * 3
    assert counts["transpose_sum_hw"] == 2
    assert counts["transpose_hw"] == 2 * 2
    assert counts["sgm_sweep"] == 2 and counts["sweep_bwd_wta"] == 2


def _run_on_both(cfg):
    """sgbm_batched on the card and on the CPU, held equal: the card's
    launch counts."""
    L, R = _pairs(4, (33, 49), seed=10)
    kernels.reset_launch_counts()
    got = sgbm_batched(L.to("cuda"), R.to("cuda"), cfg).cpu()
    counts = kernels.launch_counts()
    ref = sgbm_batched(L, R, cfg)
    assert torch.equal(got == -1.0, ref == -1.0)
    assert (got - ref).abs().max().item() <= 1e-6
    return counts


@pytest.mark.parametrize("paths,d0,p2", [(4, 0, 1000), (8, 3, 600)])
def test_pipeline_past_fused_bound_cuda_matches_cpu(cuda, paths, d0, p2):
    cfg = Config(num_disparities=32, paths=paths, min_disparity=d0, p2=p2,
                 speckle_window_size=100, speckle_range=2,
                 frames_per_step=2)
    counts = _run_on_both(cfg)
    expected = dict.fromkeys(counts, 0)
    # 8 paths: the down and up sets fused (a write and an add a set),
    # then E and W one direction a launch; 4 paths: all one a launch
    fused = 2 if paths == 8 else 0
    expected.update(census_cost_volume=2, sgm_sweep=2 * (paths - 3 * fused),
                    sgm_sweep_fused=2 * fused, transpose_hw=2 * 3, wta_lr=2,
                    connected_component_big=2, median3=2)
    assert counts == expected
    # each set of frames' first sweep writes S: no zero fill
    if paths == 8:
        assert kernels.sgm_sweep.builds == dict(FORMS, add=2 * 2)
        assert kernels.sgm_sweep_fused.builds == dict(FORMS, write=2, add=2)
    else:
        assert kernels.sgm_sweep.builds == dict(FORMS, write=2,
                                                add=2 * (paths - 1))


@pytest.mark.parametrize("mode,paths,d0", [
    ("sgm", 8, 0), ("sgm", 4, 0), ("sgm", 8, 4), ("census_wta", 8, 0),
    ("census_wta", 8, 3), ("sad", 8, 0), ("sad", 8, 3)])
def test_pipeline_cuda_matches_cpu(cuda, mode, paths, d0):
    cfg = Config(mode=mode, num_disparities=32, paths=paths,
                 min_disparity=d0, speckle_window_size=100, speckle_range=2,
                 median_filter=True, frames_per_step=2)
    counts = _run_on_both(cfg)
    expected = dict.fromkeys(counts, 0)
    expected.update(connected_component_big=2, median3=2)
    if mode == "sgm" and paths == 8:
        # a set: the down set fused (write), the up set fused (add), E
        expected.update(census_cost_volume=2, sgm_sweep=2,
                        sgm_sweep_fused=2 * 2, sweep_bwd_wta=2,
                        dr_consistency=2)
        assert kernels.sgm_sweep.builds == dict(FORMS, add=2)
        assert kernels.sgm_sweep_fused.builds == dict(FORMS, write=2, add=2)
    elif mode == "sgm":
        expected.update(census_cost_volume=2, sgm_sweep=2 * (paths - 1),
                        sweep_bwd_wta=2, dr_consistency=2)
        # each set of frames' first sweep writes S7: no zero fill
        assert kernels.sgm_sweep.builds == dict(FORMS, write=2,
                                                add=2 * (paths - 2))
    elif mode == "census_wta":
        expected.update(census_cost_volume=2, wta_lr=2)
    else:
        expected.update(sad_wta=2, dr_consistency=2)
    assert counts == expected


@pytest.mark.parametrize("mode,block", [("sgm", 9), ("census_wta", 9),
                                        ("sad", 9), ("sad", 13)])
def test_volume_route_cuda_matches_cpu(cuda, mode, block):
    """Every mode's volume through `wta_lr` on the card; SAD block 13 makes
    an int32 volume."""
    L, R = _pairs(2, (33, 49), seed=14)
    cfg = Config(mode=mode, num_disparities=32, paths=4, sad_block=block,
                 disp12_max_diff=1, speckle_window_size=100, speckle_range=2)
    S = sgbm_volume(L.to(cuda), R.to(cuda), cfg)
    S_cpu = sgbm_volume(L, R, cfg)
    assert torch.equal(S.cpu(), S_cpu)
    kernels.reset_launch_counts()
    got = select_and_refine(S, cfg).cpu()
    assert kernels.launch_counts()["wta_lr"] == 1
    ref = select_and_refine(S_cpu, cfg)
    assert torch.equal(got == -1.0, ref == -1.0)
    assert (got - ref).abs().max().item() <= 1e-6


def test_wrappers_refuse_bad_cuda_inputs(cuda):
    C = _volume(cuda, 1, 8, 16, 16)
    S = torch.zeros(C.shape, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernels.sgm_sweep(C, S, 1, 0, 10, 120)
    S16 = torch.zeros(C.shape, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        kernels.sgm_sweep(C.transpose(1, 2), S16.transpose(1, 2), 1, 0, 10,
                          120)
    with pytest.raises(ValueError):
        kernels.wta_lr(C.transpose(1, 2), Config(num_disparities=16))
    with pytest.raises(ValueError, match="2\\^15"):
        kernels.sweep_bwd_wta(C, S16, Config(num_disparities=16, p2=4000))
    # any width runs (W = 30,000 is a case of the tests above); D past the
    # kernel's 512 is refused
    with pytest.raises(ValueError, match="unsupported"):
        kernels.wta_lr(torch.zeros((1, 1, 8, 513), dtype=torch.uint8,
                                   device=cuda), Config(num_disparities=513))
    img = torch.zeros((1, 8, 16), dtype=torch.uint8, device=cuda)
    cfg = Config(mode="sad", num_disparities=16)
    with pytest.raises(ValueError):
        kernels.sad_wta(img.transpose(1, 2), img.transpose(1, 2), cfg)
    wide = torch.zeros((1, 2, 5000), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="4096"):
        kernels.sad_wta(wide, wide, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.transpose_hw(C.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.transpose_sum_hw(S16.transpose(1, 2), S16.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.sgm_sweep_bidir(C.transpose(1, 2), (0,), 10, 120)


@pytest.mark.parametrize("mode,fill,d0,p2", [
    ("sgm", "hirschmuller", 0, 120), ("sgm", "hirschmuller", 3, 120),
    ("sgm", "background", 0, 120), ("sgm", "hirschmuller", 0, 1000),
    ("sad", "hirschmuller", 0, 120), ("sad", "background", 3, 120),
    ("census_wta", "hirschmuller", 2, 120),
    ("census_wta", "background", 0, 120)])
def test_pipeline_fills_cuda_matches_cpu(cuda, mode, fill, d0, p2):
    cfg = Config(mode=mode, num_disparities=32, min_disparity=d0, p2=p2,
                 paths=4 if p2 > 120 else 8, disp12_max_diff=1,
                 fill_mode=fill, speckle_window_size=100, speckle_range=2,
                 frames_per_step=2)
    counts = _run_on_both(cfg)
    volume = p2 > 120 or (mode != "sgm" and fill == "hirschmuller")
    assert counts["dr_consistency_hits"] == (2 if fill == "hirschmuller"
                                             else 0)
    assert counts["wta_lr"] == (2 if volume or mode == "census_wta" else 0)
    assert counts["sad_wta"] == (2 if mode == "sad" and not volume else 0)
    assert counts["sweep_bwd_wta"] == (2 if mode == "sgm" and not volume
                                       else 0)


@pytest.mark.parametrize("p2,route", [(120, "fused"), (1000, "volume")])
def test_hirschmuller_past_232448_columns_cuda_matches_cpu(cuda, p2, route):
    """The Hirschmueller fill on frames of 240,000 columns, past the widest
    row the hits kernel's earlier design took, on the fused route and (past
    the fused bound) the volume route: equal to the CPU's plain pipeline."""
    L, R = _pairs(1, (2, 240000), seed=21)
    cfg = Config(num_disparities=16, p2=p2, disp12_max_diff=1,
                 fill_mode="hirschmuller", speckle_window_size=0)
    kernels.reset_launch_counts()
    got = sgbm_batched(L.to(cuda), R.to(cuda), cfg).cpu()
    counts = kernels.launch_counts()
    ref = sgbm_batched(L, R, cfg)
    assert torch.equal(got == -1.0, ref == -1.0)
    assert (got - ref).abs().max().item() <= 1e-6
    assert counts["dr_consistency_hits"] == 1
    assert counts["wta_lr" if route == "volume" else "sweep_bwd_wta"] == 1


def test_bitonic_speckle_cuda_matches_default(cuda, monkeypatch):
    L, R = _pairs(4, (33, 49), seed=18)
    L, R = L.to(cuda), R.to(cuda)
    cfg = Config(num_disparities=32, speckle_window_size=100,
                 speckle_range=2, frames_per_step=2)
    ref = sgbm_batched(L, R, cfg)
    monkeypatch.setattr(importlib.import_module(
        "tpustereo_torch.ops.postproc"), "BITONIC_SPECKLE", True)
    kernels.reset_launch_counts()
    got = sgbm_batched(L, R, cfg)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert counts["bitonic_sort"] == 2 * 2     # a pair and a keys sort
    # the labels alone, a call of their own; no size count
    assert counts["connected_component_labels"] == 2
    assert counts["connected_component_big"] == 0


# ---------------------------------------------------------------------------
# the SAD route past sad_wta's limits, and the width micro-benchmarks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [1, 100, 2964, 4095, 4096, 4097, 5000, 9000])
def test_sad_wta_fits_matches_the_c_export(cuda, W):
    from tpustereo_torch.kernels import _build
    from tpustereo_torch.kernels.sad import _SIGS, sad_wta_fits
    lib = _build.load("sad_wta", _SIGS)
    for block in range(1, 65):
        assert sad_wta_fits(W, block) == bool(lib.sad_wta_fits(W, block)), \
            (W, block)


@pytest.mark.parametrize("H,W,D,block,d12", [(8, 5000, 16, 9, 1),
                                             (8, 2964, 32, 63, -1),
                                             (8, 2964, 32, 63, 1)])
def test_sad_past_sad_wta_limits_cuda_matches_cpu(cuda, H, W, D, block, d12):
    cfg = Config(mode="sad", num_disparities=D, sad_block=block,
                 disp12_max_diff=d12, speckle_window_size=100,
                 speckle_range=2, frames_per_step=2)
    L, R = _pairs(2, (H, W), seed=19)
    kernels.reset_launch_counts()
    got = sgbm_batched(L.to(cuda), R.to(cuda), cfg).cpu()
    counts = kernels.launch_counts()
    ref = sgbm_batched(L, R, cfg)
    assert counts["wta_lr"] == 1 and counts["sad_wta"] == 0
    assert torch.equal(got == -1.0, ref == -1.0)
    assert (got - ref).abs().max().item() <= 1e-6


def _wm():
    return importlib.import_module("tpustereo_torch.kernels.width_micro")


# (T, N): rows that fill whole warps, an odd N (N/2 odd for the paired
# modes), and N = 2048; lines against the kernel's ring of 8 (v32, swar)
# or 16 (the i8 modes) steps a warp, of 1 and 2 steps and one less, as
# many and one more steps than either depth, on 1, 2 and 6 rows (3 lines
# for the paired modes); one wave of one-warp blocks past every SM (132 x
# 32 = 4,224 lines); `chip_smoke.py`'s (376, 1280); the E sweep's 1,500
# lines at 64 steps
SWEEP_SHAPES = ([(9, 16), (7, 9), (7, 18), (5, 2048)]
                + [(T, N) for T in (1, 2, 7, 8, 9, 15, 16, 17)
                   for N in (1, 2, 6)]
                + [(3, 4224), (376, 1280), (64, 1500)])


@pytest.mark.parametrize("T,N,mode", [
    (T, N, mode) for T, N in SWEEP_SHAPES
    for mode in ("v32", "swar", "v32_i8", "swar_i8", "bf16_i8")
    if N % 2 == 0 or mode in ("v32", "swar", "v32_i8")])
@pytest.mark.parametrize("p1,p2", [(10, 120), (3, 1000), (0, 0x3FFE)])
def test_sweep_micro_kernel_matches_plain(cuda, T, N, mode, p1, p2):
    wm = _wm()
    rng = np.random.default_rng(20)
    if mode in wm.I8_MODES:
        C = torch.from_numpy(rng.integers(0, 128, (T, N, 128), dtype=np.int8))
    elif mode == "swar":
        C = torch.from_numpy(rng.integers(0, 1 << 30, (T, N, 128),
                                          dtype=np.int32) & 0x3FFF3FFF)
    else:
        C = torch.from_numpy(rng.integers(0, 1 << 14, (T, N, 128),
                                          dtype=np.int32))
    C = C.to(cuda)
    ref = wm.sweep_micro_plain(C, mode, p1, p2)
    kernels.reset_launch_counts()
    got = wm.sweep_micro(C, mode, p1, p2)
    assert kernels.launch_counts()["sweep_micro"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_sweep_micro_kernel_modes_agree(cuda):
    wm = _wm()
    rng = np.random.default_rng(21)
    C = torch.from_numpy(rng.integers(0, 64, (11, 32, 128),
                                      dtype=np.int8)).to(cuda)
    a = wm.sweep_micro(C, "v32_i8")
    assert torch.equal(a, wm.sweep_micro(C, "swar_i8"))
    assert torch.equal(a, wm.sweep_micro(C, "bf16_i8"))
    assert torch.equal(a.int(), wm.sweep_micro(C.int(), "v32"))
    assert torch.equal(wm.unpack_rows(wm.sweep_micro(wm.pack_rows(C), "swar")),
                       a.int())


# small and odd slabs; `chip_smoke.py` step 17's timing shapes; and the
# plan's boundaries: 33,792 values are one block of 128 threads on each of
# the 132 SMs at 2 int32 words a thread (1 word of 16-bit pairs), with one
# value less and more, and 67,585 one more than two such blocks an SM
CHAIN_SHAPES = [(8, 128), (13, 37), (2048, 128), (1, 1), (1, 2),
                (1248, 128), (16896, 128), (132, 256), (3, 11263),
                (1, 33793), (1, 67585)]


@pytest.mark.parametrize("shape", CHAIN_SHAPES)
@pytest.mark.parametrize("kind,dtype", [
    ("elem", torch.int32), ("elem", torch.int16), ("elem", torch.bfloat16),
    ("reg", torch.int32), ("reg", torch.float32), ("reg", torch.bfloat16),
    ("reg", torch.int16)])
@pytest.mark.parametrize("chain", [0, 1, 7, 100, 512])
def test_chain_kernels_match_plain(cuda, shape, kind, dtype, chain):
    """int16 and int32 values up to the edges, so the chains wrap; bf16
    values past 256, so they round."""
    wm = _wm()
    rng = np.random.default_rng(22)
    lo, hi = (-32768, 32768) if dtype == torch.int16 else (-500, 500)
    x = torch.from_numpy(rng.integers(lo, hi, shape)).to(dtype)
    if dtype == torch.int16 and x.numel() > 3:
        x.view(-1)[:4] = torch.tensor([32767, 32766, -1, -32768])
    if dtype == torch.int32 and x.numel() > 3:
        x.view(-1)[:4] = torch.tensor([2**31 - 1, 2**31 - 2, -1, -2**31])
    x = x.to(cuda)
    fn, plain = ((wm.elem_chain_micro, wm.elem_chain_micro_plain)
                 if kind == "elem" else
                 (wm.reg_chain_micro, wm.reg_chain_micro_plain))
    got = fn(x, chain)
    ref = plain(x, chain)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.parametrize("kind,dtype,shape,chain", [
    ("elem", torch.int16, (13, 37), 2500),
    ("elem", torch.bfloat16, (13, 37), 2500),
    ("elem", torch.int16, (1, 3), 32768),
    ("elem", torch.bfloat16, (1, 3), 70000),
    ("elem", torch.int32, (1, 3), 70000),
    ("reg", torch.int16, (1, 3), 70000)])
def test_chain_kernels_match_plain_on_long_chains(cuda, kind, dtype, shape,
                                                  chain):
    """Chains past the 1,024 steps of one chunk of the 16-bit step
    constants' table, bf16 ones far past 256 and reg int16 past 65,535
    steps. The int16 elem chain's i stops at 32,767, where the plain
    version (as the JAX function) can still make it an int16."""
    wm = _wm()
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.integers(-500, 500, shape)).to(dtype).to(cuda)
    fn, plain = ((wm.elem_chain_micro, wm.elem_chain_micro_plain)
                 if kind == "elem" else
                 (wm.reg_chain_micro, wm.reg_chain_micro_plain))
    got = fn(x, chain)
    ref = plain(x, chain)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# lines that fill one warp's threads exactly (128, 2048), one warp's with
# E - 1 values in some threads (37, 2047, 31, 100, 1000, 3), a ring of two
# (2, 1), and lines over a block of warps: exact (4096, 16896), with a
# partial last warp (16896 = 264 x 64), and not exact (2049, 4100, 5000)
ROLL_SHAPES = [(8, 128), (37, 9), (2048, 3), (2047, 5), (1248, 128),
               (5, 2048), (3, 2), (2, 1), (100, 3), (1000, 2), (2049, 3),
               (4096, 2), (4100, 3), (5000, 1), (16896, 2)]


@pytest.mark.parametrize("shape", ROLL_SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("chain", [4, 7, 33, 129])
def test_roll_kernel_matches_plain(cuda, shape, axis, chain):
    """Chains 7 and 129 are odd and not a multiple of any plan's period
    of steps, so they start inside a period and end on its odd step."""
    wm = _wm()
    x = torch.from_numpy(np.random.default_rng(23).integers(
        -1000, 1000, shape, dtype=np.int32)).to(cuda)
    kernels.reset_launch_counts()
    got = wm.roll_chain_micro(x, chain, axis=axis)
    assert kernels.launch_counts()["roll_chain_micro"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, wm.roll_chain_micro_plain(x, chain, axis))
    if chain == 4:
        assert torch.equal(got, torch.roll(x, 6, dims=axis))


@pytest.mark.parametrize("shape", [(8, 128), (16, 40), (2, 2048), (4, 31),
                                   (1248, 128), (2, 2049), (2, 4100),
                                   (4, 16896), (2, 1), (6, 37)])
@pytest.mark.parametrize("chain", [4, 7, 31, 129])
def test_bf16_roll_kernel_matches_plain(cuda, shape, chain):
    wm = _wm()
    x = (torch.from_numpy(np.random.default_rng(24).uniform(
        -300, 300, shape).astype(np.float32)).bfloat16()).to(cuda)
    kernels.reset_launch_counts()
    got = wm.bf16_roll_chain_micro(x, chain)
    assert kernels.launch_counts()["bf16_roll_chain_micro"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, wm.bf16_roll_chain_micro_plain(x, chain))
    if chain == 4:
        assert torch.equal(got, torch.roll(x, 6, dims=1))


@pytest.mark.parametrize("slots,threads", [(4, 32), (48, 26), (24, 52),
                                           (12, 104), (64, 20)])
def test_roll_kernel_takes_other_plans(cuda, slots, threads):
    """Other exact and inexact plans of a line of 1248 (one warp, blocks of
    2 and 4 warps) through the C interface: the same rolls. (4, 32) holds
    128 values, not 1248, so the kernel refuses it; (64, 20) gives each of
    its threads 62.4, which no plan of at most one short value a thread
    takes."""
    wm = _wm()
    from tpustereo_torch.kernels import _build
    x = torch.from_numpy(np.random.default_rng(25).integers(
        -1000, 1000, (1248, 3), dtype=np.int32)).to(cuda)
    out = torch.empty_like(x)
    lib = _build.load("width_micro", wm._SIGS)
    rc = lib.roll_micro_launch(_build.ptr(x), _build.ptr(out), 3, 1248, 1, 3,
                               0, slots, threads, 33, _build.stream_ptr(x))
    torch.cuda.synchronize()
    if slots * threads < 1248 or (slots - 1) * threads >= 1248:
        assert rc != 0
    else:
        assert rc == 0
        assert torch.equal(out, wm.roll_chain_micro_plain(x, 33, 0))


def test_width_micro_refuses_bad_cuda_inputs(cuda):
    wm = _wm()
    C = torch.zeros((4, 8, 128), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        wm.sweep_micro(C.transpose(0, 1), "v32_i8")
    with pytest.raises(ValueError, match="128"):
        wm.sweep_micro(C.view(4, 8, 128)[:, :, :64], "v32_i8")
    with pytest.raises(ValueError, match="2\\^14"):
        wm.sweep_micro(torch.full((2, 8, 128), -1, dtype=torch.int32,
                                  device=cuda), "v32")
    x = torch.zeros((9, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        wm.elem_chain_micro(x.view(-1)[1:1025].view(8, 128))
    top = wm.MAX_LINE
    with pytest.raises(ValueError, match=str(top)):
        wm.roll_chain_micro(torch.zeros((top + 1, 1), dtype=torch.int32,
                                        device=cuda), axis=0)
    with pytest.raises(ValueError, match=str(top)):
        wm.bf16_roll_chain_micro(torch.zeros((2, top + 1),
                                             dtype=torch.bfloat16,
                                             device=cuda))
    got = wm.roll_chain_micro(torch.arange(top, dtype=torch.int32,
                                           device=cuda).view(top, 1), 3,
                              axis=0)
    assert torch.equal(got.view(-1)[:5].cpu(), torch.tensor(
        [top - 4, top - 3, top - 2, top - 1, 0], dtype=torch.int32))


# ---------------------------------------------------------------------------
# adaptive P2 through the compositions and the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paths", [4, 8])
def test_aggregate_volume_adaptive_cuda_matches_plain(cuda, paths):
    """The volume route's sweeps with the image, E and W on the transposed
    image."""
    C = _volume(cuda, 2, 23, 57, 48, seed=12)
    img = _image(cuda, 2, 23, 57, seed=12)
    cfg = Config(num_disparities=48, paths=paths, p1=7, p2=90,
                 adaptive_p2=True)
    kernels.reset_launch_counts()
    got = kernels.aggregate_volume(C, cfg, img)
    if paths == 8:   # the down and up sets fused, then E and W
        assert kernels.sgm_sweep.builds == dict(FORMS, add_adaptive=2)
        assert kernels.sgm_sweep_fused.builds == dict(
            FORMS, write_adaptive=1, add_adaptive=1)
    else:
        assert kernels.sgm_sweep.builds == dict(
            FORMS, write_adaptive=1, add_adaptive=paths - 1)
    torch.cuda.synchronize()
    assert torch.equal(got, aggregate(C, cfg, img))


@pytest.mark.parametrize("paths,d0,p1,p2,fill", [
    (8, 0, 10, 120, "off"), (4, 0, 10, 120, "off"),
    (8, 3, 10, 120, "hirschmuller"), (8, 0, 40, 40, "background"),
    (4, 2, 10, 1000, "off"), (8, 0, 10, 600, "hirschmuller")])
def test_pipeline_adaptive_cuda_matches_cpu(cuda, paths, d0, p1, p2, fill):
    """Adaptive P2 through `sgbm_batched` on both routes (P2 past the fused
    bound takes the volume route), against the CPU's plain pipeline."""
    cfg = Config(num_disparities=32, paths=paths, min_disparity=d0, p1=p1,
                 p2=p2, adaptive_p2=True, fill_mode=fill,
                 speckle_window_size=100, speckle_range=2,
                 frames_per_step=2)
    counts = _run_on_both(cfg)
    volume = paths * (cfg.max_census_cost + p2) >= 4096
    n_sweeps = paths if volume else paths - 1
    if paths == 8:
        # the down and up sets fused (a write and an add a set); the one-
        # direction kernel runs the rest (E, and W on the volume route)
        assert counts["sgm_sweep"] == 2 * (n_sweeps - 6)
        assert counts["sgm_sweep_fused"] == 2 * 2
        assert kernels.sgm_sweep.builds == dict(
            FORMS, add_adaptive=2 * (n_sweeps - 6))
        assert kernels.sgm_sweep_fused.builds == dict(
            FORMS, write_adaptive=2, add_adaptive=2)
    else:
        assert counts["sgm_sweep"] == 2 * n_sweeps
        assert counts["sgm_sweep_fused"] == 0
        assert kernels.sgm_sweep.builds == dict(
            FORMS, write_adaptive=2, add_adaptive=2 * (n_sweeps - 1))
    assert counts["sweep_bwd_wta"] == (0 if volume else 2)
    assert kernels.sweep_bwd_wta.builds == {"scalar": 0,
                                            "adaptive": 0 if volume else 2}
    assert counts["transpose_hw"] == (6 if volume else 0)


def test_bidir_vert_adaptive_cuda_takes_the_default_schedule(cuda,
                                                             monkeypatch):
    L, R = _pairs(4, (33, 49), seed=13)
    L, R = L.to(cuda), R.to(cuda)
    cfg = Config(num_disparities=32, speckle_window_size=100,
                 speckle_range=2, frames_per_step=2, adaptive_p2=True)
    ref = sgbm_batched(L, R, cfg)
    monkeypatch.setattr(importlib.import_module(
        "tpustereo_torch.kernels.sgm"), "BIDIR_VERT", True)
    kernels.reset_launch_counts()
    got = sgbm_batched(L, R, cfg)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert counts["sgm_sweep_bidir"] == 0 and counts["transpose_hw"] == 0
    assert kernels.sgm_sweep.builds == dict(FORMS, add_adaptive=2)
    assert kernels.sgm_sweep_fused.builds == dict(FORMS, write_adaptive=2,
                                                  add_adaptive=2)


def test_volume_route_adaptive_cuda_matches_fused(cuda):
    L, R = _pairs(2, (41, 67), seed=15)
    L, R = L.to(cuda), R.to(cuda)
    cfg = Config(num_disparities=32, paths=4, adaptive_p2=True,
                 speckle_window_size=100, speckle_range=2)
    fused = sgbm_batched(L, R, cfg)
    volume = select_and_refine(sgbm_volume(L, R, cfg), cfg)
    torch.cuda.synchronize()
    assert torch.equal(volume, fused)


# --- odometry: the card against the CPU on the same inputs -----------------
# Tolerances: the Harris response and the corner selection are the same
# elementwise float32 operations and a stable sort on both devices, so
# corners agree to 1e-6 px; descriptors (a mean and a norm, reduced in
# another order) 1e-5; T 1e-4 (m and rad); match counts equal.

def _odometry_frames(n, shape=(96, 128), seed=3):
    from tpustereo_torch.data import synthetic_sequence
    return synthetic_sequence(n_frames=n, shape=shape, depth=8.0, fx=200.0,
                              baseline=0.5, step_x=0.08, slant=0.35,
                              seed=seed)


def _odometry_inputs(dev, calib, K):
    intr = torch.tensor([calib.fx, calib.fy, calib.cx, calib.cy],
                        dtype=torch.float32, device=dev)
    zeros = (torch.zeros((K, 64), device=dev),
             torch.zeros((K,), dtype=torch.bool, device=dev),
             torch.zeros((K, 3), device=dev))
    return intr, torch.tensor(calib.baseline, dtype=torch.float32,
                              device=dev), zeros


def _same_track(got, ref):
    got = type(got)(*(x.cpu() for x in got))
    assert torch.equal(got.valid, ref.valid)
    assert (got.pts - ref.pts).abs().max().item() <= 1e-6
    assert (got.desc - ref.desc).abs().max().item() <= 1e-5
    assert (got.X - ref.X).abs().max().item() <= 1e-4
    assert (got.T - ref.T).abs().max().item() <= 1e-4
    assert int(got.n_matches) == int(ref.n_matches)


def test_track_from_disp_cuda_matches_cpu(cuda):
    from tpustereo_torch.odometry import OdometryConfig
    from tpustereo_torch.odometry.fused import (fused_track_from_disp,
                                                fused_track_step)
    from tpustereo_torch.pipeline import sgbm
    cfg = Config(num_disparities=32, speckle_window_size=50)
    ocfg = OdometryConfig()
    calib, frames, _ = _odometry_frames(3)
    intr, b, zeros = _odometry_inputs(cuda, calib, ocfg.max_corners)
    L0, R0 = (torch.from_numpy(a).to(cuda) for a in frames[0])
    kf0 = fused_track_step(L0, R0, *zeros, intr, b, cfg, ocfg)
    kf = (kf0.desc, kf0.valid, kf0.X)
    matched = 0
    for L, R in frames[1:]:
        Lc = torch.from_numpy(L).to(cuda)
        disp = sgbm(Lc, torch.from_numpy(R).to(cuda), cfg)
        got = fused_track_from_disp(Lc, disp, *kf, intr, b, cfg, ocfg)
        ref = fused_track_from_disp(torch.from_numpy(L), disp.cpu(),
                                    *(k.cpu() for k in kf), intr.cpu(),
                                    b.cpu(), cfg, ocfg)
        _same_track(got, ref)
        matched += int(ref.n_matches)
    assert matched > 40


def test_optimize_poses_cuda_matches_cpu(cuda):
    from tpustereo_torch.odometry import optimize_poses
    from tpustereo_torch.odometry.se3 import exp_se3
    rng = np.random.default_rng(4)
    N = 12
    xi = np.concatenate([rng.normal(0, 0.03, (N, 3)) + [0.5, 0, 0],
                         rng.normal(0, 0.01, (N, 3))], 1).astype(np.float32)
    steps = exp_se3(torch.from_numpy(xi))
    poses = [torch.eye(4)]
    for s in steps[1:]:
        poses.append(poses[-1] @ s)
    poses = torch.stack(poses)
    ij = torch.tensor([[i, i + 1] for i in range(N - 1)] + [[0, N - 1],
                                                           [2, 9]])
    Ts = torch.cat([steps[1:], exp_se3(torch.tensor(
        [[5.5, 0, 0, 0, 0, 0], [3.5, 0.1, 0, 0, 0, 0.01]]))])
    w = torch.tensor([1.0] * (N - 1) + [10.0, 2.0])
    ref = optimize_poses(poses, ij, Ts, w, iters=10)
    got = optimize_poses(poses.to(cuda), ij.to(cuda), Ts.to(cuda),
                         w.to(cuda), iters=10)
    assert (got.cpu() - ref).abs().max().item() <= 1e-5
    assert not torch.equal(ref, poses)


def test_track_frames_cuda_matches_single_steps(cuda):
    from tpustereo_torch.odometry import OdometryConfig
    from tpustereo_torch.odometry.fused import (fused_track_frames,
                                                fused_track_step)
    cfg = Config(num_disparities=32, speckle_window_size=50)
    ocfg = OdometryConfig()
    calib, frames, _ = _odometry_frames(5)
    intr, b, zeros = _odometry_inputs(cuda, calib, ocfg.max_corners)
    Ls = torch.from_numpy(np.stack([f[0] for f in frames])).to(cuda)
    Rs = torch.from_numpy(np.stack([f[1] for f in frames])).to(cuda)
    kf0 = fused_track_step(Ls[0], Rs[0], *zeros, intr, b, cfg, ocfg)
    kf = (kf0.desc, kf0.valid, kf0.X)
    kernels.reset_launch_counts()
    chunk = fused_track_frames(Ls[1:], Rs[1:], *kf, intr, b, cfg, ocfg)
    assert kernels.launch_counts()["sweep_bwd_wta"] == 1   # one set of 4
    for f in range(4):
        single = fused_track_step(Ls[1 + f], Rs[1 + f], *kf, intr, b, cfg,
                                  ocfg)
        assert torch.equal(chunk.disp[f], single.disp)
        _same_track(type(single)(*(x[f] for x in chunk)),
                    type(single)(*(x.cpu() for x in single)))


def test_kitti_odometry_width_cuda_matches_cpu(cuda):
    """The KITTI odometry frame's odd width, 1241 columns, through the six
    kernels of the preset (strips=1): the card against the CPU."""
    from tpustereo_torch import PRESETS
    from tpustereo_torch.pipeline import sgbm
    cfg = PRESETS["kitti_odometry"].replace(strips=1)
    _, frames, _ = _odometry_frames(1, shape=(24, 1241), seed=7)
    L, R = (torch.from_numpy(a) for a in frames[0])
    kernels.reset_launch_counts()
    got = sgbm(L.to(cuda), R.to(cuda), cfg).cpu()
    counts = kernels.launch_counts()
    ref = sgbm(L, R, cfg)
    assert torch.equal(got == -1.0, ref == -1.0)
    assert (got - ref).abs().max().item() <= 1e-6
    assert (ref > 0).float().mean() > 0.5
    expected = dict.fromkeys(counts, 0)
    expected.update(census_cost_volume=1, sgm_sweep=1, sgm_sweep_fused=2,
                    sweep_bwd_wta=1, dr_consistency=1,
                    connected_component_big=1, median3=1)
    assert counts == expected


def test_run_sequence_cuda_matches_cpu(cuda):
    from tpustereo_torch import api
    from tpustereo_torch.odometry import OdometryConfig
    calib, frames, gt = _odometry_frames(8)
    cfg = Config(num_disparities=32, speckle_window_size=50)
    ocfg = OdometryConfig(keyframe_translation=0.1)
    got = api.run_sequence(frames, calib, cfg, ocfg)
    ref = api.run_sequence(frames, calib, cfg, ocfg, device="cpu")
    assert np.abs(got - ref).max() <= 1e-4
    assert np.linalg.norm(got[-1, :3, 3] - gt[-1, :3, 3]) < \
        0.2 * np.linalg.norm(gt[-1, :3, 3])


# --- the ring carry of sgm_sweep and the strip-tiled pipelines -------------

YDIRS = [r for r in DIRS_8 if r[0] != 0]
# (B, H, W): lines shorter than the ring, a tall one, the KITTI odometry
# width
CARRY_SHAPES = [(2, 5, 9), (1, 19, 43), (1, 4, 1241)]


def _q_carry(cuda, B, W, D, seed):
    """A random q-form carry (B, W, D): each column's minimum over d is 0."""
    rng = np.random.default_rng(seed + 200)
    q = rng.integers(0, 130, (B, W, D)).astype(np.int32)
    return torch.from_numpy(q - q.min(-1, keepdims=True)).to(cuda)


@pytest.mark.parametrize("D", [16, 100, 128, 512])
@pytest.mark.parametrize("direction", YDIRS)
@pytest.mark.parametrize("form", ["add", "write"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_sweep_kernel_carry_matches_plain(cuda, D, direction, form,
                                          adaptive):
    """The carry forms: a random q carry in, the last row's q out, against
    the plain version; counted in `carry_forms`."""
    for seed, shape in enumerate(CARRY_SHAPES):
        B, H, W = shape
        C = _volume(cuda, *shape, D, seed=seed)
        img = _image(cuda, *shape, seed=seed) if adaptive else None
        prev = (_image(cuda, B, 1, W, seed=seed + 50)[:, 0].contiguous()
                if adaptive else None)
        q = _q_carry(cuda, B, W, D, seed)
        S = (torch.full(C.shape, 7, dtype=torch.int16, device=cuda)
             if form == "add" else None)
        kernels.reset_launch_counts()
        ref, ref_q = sgm_sweep_plain(C, None if S is None else S.clone(),
                                     *direction, 10, 120, img, q, True, prev)
        got, got_q = kernels.sgm_sweep(C, S, *direction, 10, 120, img,
                                       carry=q, return_carry=True,
                                       img_prev=prev)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), shape
        assert torch.equal(got_q, ref_q), shape
        key = form + ("_adaptive" if adaptive else "")
        assert kernels.sgm_sweep.carry_forms == dict(FORMS, **{key: 1})


# (B, H, W): one row and one column, heights below, at and across a band
# (8 rows), widths below, at and across a tile (24 columns, 8 at D = 512),
# the KITTI odometry width, and frames whose blocks walk several tiles
FUSED_CARRY_SHAPES = [(1, 1, 1), (2, 5, 9), (1, 8, 24), (2, 19, 43),
                      (1, 4, 1241), (2, 25, 100)]


def _q_carries(cuda, K, B, W, D, seed):
    return torch.stack([_q_carry(cuda, B, W, D, seed + 7 * k)
                        for k in range(K)])


@pytest.mark.parametrize("D", [16, 40, 128, 256, 512])
@pytest.mark.parametrize("dxs", [(0, 1, -1), (1, -1), (-1, 0, 1)])
@pytest.mark.parametrize("dy", [1, -1])
@pytest.mark.parametrize("form", ["add", "write"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_fused_kernel_carry_matches_plain(cuda, D, dxs, dy, form, adaptive):
    """The fused carry forms: a random (K, B, W, D) q carry in (one slab a
    direction, in dxs order: (-1, 0, 1) takes the s16x2 build's slab
    reorder), the last row's q out, against the plain version; counted in
    `carry_forms`."""
    for seed, shape in enumerate(FUSED_CARRY_SHAPES):
        B, H, W = shape
        C = _volume(cuda, *shape, D, seed=seed)
        img = _image(cuda, *shape, seed=seed) if adaptive else None
        prev = (_image(cuda, B, 1, W, seed=seed + 50)[:, 0].contiguous()
                if adaptive else None)
        q = _q_carries(cuda, len(dxs), B, W, D, seed)
        S = (torch.full(C.shape, 7, dtype=torch.int16, device=cuda)
             if form == "add" else None)
        kernels.reset_launch_counts()
        ref, ref_q = sgm_sweep_fused_plain(
            C, None if S is None else S.clone(), dy, dxs, 10, 120, img,
            carry=q, return_carry=True, img_prev=prev)
        got, got_q = kernels.sgm_sweep_fused(C, S, dy, dxs, 10, 120, img,
                                             carry=q, return_carry=True,
                                             img_prev=prev)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), shape
        assert torch.equal(got_q, ref_q), shape
        key = form + ("_adaptive" if adaptive else "")
        assert kernels.sgm_sweep_fused.carry_forms == dict(FORMS,
                                                           **{key: 1})
        assert kernels.sgm_sweep_fused.launches == 1
        assert kernels.sgm_sweep.launches == 0


@pytest.mark.parametrize("D,shape", [(512, (1, 375, 1242)),
                                     (128, (1, 17, 10000)),
                                     (128, (4, 192, 1241))])
@pytest.mark.parametrize("adaptive", [False, True])
def test_fused_kernel_carry_wide_frames(cuda, D, shape, adaptive):
    """The carry in and out where each block walks several tiles band by
    band (D = 512 at the KITTI width, 10,000 columns), and on 4 frames of
    the exact ring's 192-row strip of a KITTI odometry frame."""
    B, H, W = shape
    C = _volume(cuda, *shape, D, seed=31)
    img = _image(cuda, *shape, seed=31) if adaptive else None
    prev = (_image(cuda, B, 1, W, seed=81)[:, 0].contiguous() if adaptive
            else None)
    q = _q_carries(cuda, 3, B, W, D, 31)
    for dy in (1, -1):
        ref = sgm_sweep_fused_plain(C, None, dy, (0, 1, -1), 10, 120, img,
                                    carry=q, return_carry=True,
                                    img_prev=prev)
        got = kernels.sgm_sweep_fused(C, None, dy, (0, 1, -1), 10, 120, img,
                                      carry=q, return_carry=True,
                                      img_prev=prev)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        del ref, got


@pytest.mark.parametrize("form", ["add", "write"])
@pytest.mark.parametrize("D", [40, 128])
def test_fused_kernel_carry_takes_unaligned_volumes(cuda, form, D):
    C = _unaligned(_volume(cuda, 2, 19, 43, D, seed=32))
    q = _q_carries(cuda, 3, 2, 43, D, 32)
    S = (_unaligned(torch.full(C.shape, 5, dtype=torch.int16, device=cuda))
         if form == "add" else None)
    ref = sgm_sweep_fused_plain(C, None if S is None else S.clone(), 1,
                                (0, 1, -1), 10, 120, None, carry=q,
                                return_carry=True)
    got = kernels.sgm_sweep_fused(C, S, 1, (0, 1, -1), 10, 120, carry=q,
                                  return_carry=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("strips", [2, 4])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("D", [16, 128])
def test_fused_kernel_carry_chain_equals_one_launch(cuda, strips, adaptive,
                                                    D):
    """Strips of a 2 x 37 x 70 volume chained through the fused carry
    equal one launch, output and final carry, both scan orders."""
    B, H, W = 2, 37, 70
    C = _volume(cuda, B, H, W, D, seed=33)
    img = _image(cuda, B, H, W, seed=33) if adaptive else None
    cuts = np.array_split(np.arange(H), strips)
    for dy in (1, -1):
        ref, ref_q = kernels.sgm_sweep_fused(C, None, dy, (0, 1, -1), 10,
                                             120, img, return_carry=True)
        parts, q = {}, None
        for rows in cuts if dy > 0 else cuts[::-1]:
            r0, r1 = int(rows[0]), int(rows[-1]) + 1
            pv = (img[:, r0 - 1 if dy > 0 else r1].contiguous()
                  if img is not None and q is not None else None)
            parts[r0], q = kernels.sgm_sweep_fused(
                C[:, r0:r1].contiguous(), None, dy, (0, 1, -1), 10, 120,
                None if img is None else img[:, r0:r1].contiguous(),
                carry=q, return_carry=True, img_prev=pv)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat([parts[k] for k in sorted(parts)], 1),
                           ref)
        assert torch.equal(q, ref_q)


@pytest.mark.parametrize("D", [40, 128])
@pytest.mark.parametrize("direction", [(1, 0), (-1, 1)])
def test_sweep_kernel_carry_takes_unaligned_volumes(cuda, D, direction):
    C = _unaligned(_volume(cuda, 2, 19, 43, D, seed=6))
    S = _unaligned(torch.full(C.shape, 5, dtype=torch.int16, device=cuda))
    q = _q_carry(cuda, 2, 43, D, 6)
    ref = sgm_sweep_plain(C, S.clone(), *direction, 10, 120, None, q, True)
    got = kernels.sgm_sweep(C, S, *direction, 10, 120, carry=q,
                            return_carry=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("strips", [2, 4])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("D", [16, 128])
def test_sweep_kernel_carry_chain_equals_one_launch(cuda, strips, adaptive,
                                                    D):
    """The kernel chained over strips of 45 rows, each seeded with the
    previous strip's carry in path order, equals one untiled launch bit for
    bit, and so does the last carry."""
    B, H, W = 2, 45, 1241
    C = _volume(cuda, B, H, W, D, seed=9)
    img = _image(cuda, B, H, W, seed=9) if adaptive else None
    cuts = np.array_split(np.arange(H), strips)
    for dy, dx in YDIRS:
        ref, ref_q = kernels.sgm_sweep(C, None, dy, dx, 10, 120, img,
                                       return_carry=True)
        parts, q = {}, None
        for rows in (cuts if dy > 0 else cuts[::-1]):
            r0, r1 = int(rows[0]), int(rows[-1]) + 1
            prev = (img[:, r0 - 1 if dy > 0 else r1].contiguous()
                    if img is not None and q is not None else None)
            parts[r0], q = kernels.sgm_sweep(
                C[:, r0:r1].contiguous(), None, dy, dx, 10, 120,
                None if img is None else img[:, r0:r1].contiguous(),
                carry=q, return_carry=True, img_prev=prev)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat([parts[k] for k in sorted(parts)], 1),
                           ref), (dy, dx)
        assert torch.equal(q, ref_q), (dy, dx)


TILED_CASES = {
    "halo": dict(halo=12),
    "exact": dict(exact_tiling=True),
    "exact_adaptive": dict(exact_tiling=True, paths=4, adaptive_p2=True),
    "exact8_adaptive": dict(exact_tiling=True, paths=8, adaptive_p2=True),
    "halo_hirschmuller": dict(halo=12, fill_mode="hirschmuller"),
    "exact_volume": dict(exact_tiling=True, paths=4, p2=1000),
}


@pytest.mark.parametrize("name", TILED_CASES)
@pytest.mark.parametrize("strips", [2, 4])
def test_sgbm_tiled_cuda_matches_cpu(cuda, name, strips):
    from tpustereo_torch import dist
    from tpustereo_torch.pipeline import sgbm
    cfg = Config(num_disparities=32, speckle_window_size=50,
                 **TILED_CASES[name])
    L, R = _pairs(2, (45, 331), seed=3)
    ref = dist.sgbm_tiled_batched(L, R, cfg,
                                  dist.make_mesh(1, strips, device="cpu"))
    kernels.reset_launch_counts()
    got = dist.sgbm_tiled_batched(L.to(cuda), R.to(cuda), cfg,
                                  dist.make_mesh(1, strips)).cpu()
    assert kernels.launch_counts()["census_cost_volume"] == 1
    if cfg.exact_tiling:
        # the ring: one carry launch a scan order a strip, the down one
        # writing each strip's S and the up one adding; fused with 8 paths
        ring, other = kernels.sgm_sweep_fused, kernels.sgm_sweep
        if cfg.paths == 4:
            ring, other = other, ring
        tag = "_adaptive" if cfg.adaptive_p2 else ""
        assert ring.carry_forms == dict(FORMS, **{"write" + tag: strips,
                                                  "add" + tag: strips})
        assert sum(other.carry_forms.values()) == 0
        untiled = sgbm(L[0].to(cuda), R[0].to(cuda), cfg).cpu()
        assert torch.equal(got[0], untiled)
    assert torch.equal(got == -1.0, ref == -1.0)
    assert (got - ref).abs().max().item() <= 1e-6


def test_run_sequence_tiled_cuda_matches_cpu(cuda):
    """kitti_odometry as shipped (halo mode, 2 strips, halo 32) but for D:
    the card against the CPU."""
    from tpustereo_torch import PRESETS, api
    from tpustereo_torch.odometry import OdometryConfig
    calib, frames, gt = _odometry_frames(8)
    cfg = PRESETS["kitti_odometry"].replace(num_disparities=32)
    ocfg = OdometryConfig(keyframe_translation=0.1)
    kernels.reset_launch_counts()
    got = api.run_sequence(frames, calib, cfg, ocfg)
    assert kernels.launch_counts()["census_cost_volume"] == len(frames)
    ref = api.run_sequence(frames, calib, cfg, ocfg, device="cpu")
    assert np.abs(got - ref).max() <= 1e-4
    assert np.linalg.norm(got[-1, :3, 3] - gt[-1, :3, 3]) < \
        0.2 * np.linalg.norm(gt[-1, :3, 3])


def test_sweep_kernel_writes_into_out(cuda):
    C = _volume(cuda, 2, 19, 43, 128, seed=8)
    out = torch.full(C.shape, 77, dtype=torch.int16, device=cuda)
    got = kernels.sgm_sweep(C, None, -1, 1, 10, 120, out=out)
    torch.cuda.synchronize()
    assert got is out
    assert torch.equal(out, sgm_sweep_plain(C, None, -1, 1, 10, 120))


# --- the entry points: the CLI, the harness and the eval runner on the card

def test_cli_match_cuda_equals_match_pair(cuda, tmp_path):
    """`match` from PNG files on the card: the .pfm is `api.match_pair` on
    the decoded arrays, bit for bit, and the .png its KITTI encoding."""
    from tpustereo_torch import PRESETS, api
    from tpustereo_torch.cli.main import main
    from tpustereo_torch.data import io
    L, R = (x[0].numpy() for x in _pairs(1, (64, 200), seed=5))
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    io.write_image(lp, L)
    io.write_image(rp, R)
    assert np.array_equal(io.read_image_gray(lp), L)
    args = ["match", "--preset", "kitti_sgm8", "--left", lp, "--right", rp]
    main(args + ["--out", str(tmp_path / "d.pfm")])
    main(args + ["--out", str(tmp_path / "d.png")])
    want = api.match_pair(L, R, PRESETS["kitti_sgm8"])
    got = io.read_pfm(str(tmp_path / "d.pfm"))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(io.read_png(str(tmp_path / "d.png")),
                          io.kitti_disparity_raw(want))


@pytest.mark.parametrize("name", ["kitti_sgm8", "tsukuba_sad",
                                  "middlebury_census_wta"])
def test_run_benchmark_cuda(cuda, tmp_path, name):
    from tpustereo_torch import PRESETS
    from tpustereo_torch.eval import roofline
    from tpustereo_torch.eval.bench import run_benchmark
    rec = run_benchmark(PRESETS[name], shape=(96, 320), batch=4, iters=3,
                        stages=name == "kitti_sgm8",
                        profile_dir=str(tmp_path))
    assert rec["backend"] == "cuda"
    assert rec["device_kind"] == torch.cuda.get_device_name(0)
    assert rec["value"] > 0 and rec["ms_per_frame"] > 0
    rl = rec["roofline"]
    assert rl["device_name"] == rec["device_kind"]
    if roofline.chip_spec(rec["device_kind"]):
        assert all(0 < s <= 1 for s in roofline.shares(rl).values())
    assert 0 < rec["device_busy_fraction"]["busy_fraction"] <= 1


def test_run_benchmark_tiled_stages_cuda(cuda):
    """The tiled record and `stage_times` through the kernel wrappers."""
    from tpustereo_torch import PRESETS, dist
    from tpustereo_torch.eval.bench import run_benchmark
    rec = run_benchmark(PRESETS["kitti_odometry"], shape=(96, 320),
                        batch=2, iters=2, stages=True, tiled=True,
                        mesh=dist.make_mesh(1, 2))
    assert rec["tiled"] and rec["chips"] == 1 and rec["backend"] == "cuda"
    assert list(rec["stage_ms"]) == [
        "census+cost_volume(fused)", "sgm_select(4 sweeps+wta fused)",
        "dr_consistency", "speckle", "median3"]
    assert all(v > 0 for v in rec["stage_ms"].values())


def test_run_odometry_benchmark_cuda(cuda):
    from tpustereo_torch import PRESETS, dist
    from tpustereo_torch.eval.bench import run_odometry_benchmark
    cfg = PRESETS["kitti_odometry"].replace(num_disparities=64)
    for kw in ({}, {"tiled": True, "mesh": dist.make_mesh(1, 2)},
               {"stacked": True}):
        rec = run_odometry_benchmark(cfg, shape=(128, 320), frames=2,
                                     iters=2, **kw)
        assert rec["backend"] == "cuda" and rec["ms_per_frame"] > 0


def test_evaluate_cuda_equals_cpu(cuda):
    """The card's report (its 192 x 320 cases) against the CPU's plain
    pipeline on the same cases."""
    from tpustereo_torch import PRESETS
    from tpustereo_torch.eval.runner import _eval_one, evaluate, \
        synthetic_cases
    cfg = PRESETS["kitti_sgm8"].replace(num_disparities=64)
    rep = evaluate(cfg, synthetic=True)
    cpu = [_eval_one(L, R, gt, cfg, name, False, False, "cpu")
           for name, L, R, gt in synthetic_cases(cfg, (192, 320))]
    assert rep["pairs"] == cpu


@pytest.mark.parametrize("name", [n for n, _, _ in PINNED.SUITE])
def test_pinned_metrics_cuda(cuda, name):
    """The JAX package's stored metric points on the card: within
    `tests/test_pinned_metrics.py`'s tolerances of
    `tests/data/pinned_metrics.json`, and the CPU's invalid pattern with
    the disparity within 1e-6."""
    with open(PINNED.PIN_PATH) as f:
        want = json.load(f)[name]
    got, disp = PINNED.compute(name, device="cuda")
    _, cpu = PINNED.compute(name, device="cpu")
    for k in ("bad2", "d1_all", "valid_frac"):
        assert abs(got[k] - want[k]) <= PINNED.RATE_TOL, (name, k, got, want)
    assert abs(got["epe"] - want["epe"]) <= PINNED.EPE_TOL, (name, got, want)
    np.testing.assert_array_equal(disp < 0, cpu < 0)
    np.testing.assert_allclose(disp, cpu, rtol=0, atol=1e-6)
