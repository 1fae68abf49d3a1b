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

import numpy as np
import pytest
import torch

from tpustereo_torch import Config, kernels
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.kernels.cc import connected_component_labels_plain
from tpustereo_torch.kernels.cost import census_cost_volume_plain
from tpustereo_torch.kernels.lr import dr_consistency_plain
from tpustereo_torch.kernels.median import median3_plain
from tpustereo_torch.kernels.sad import sad_wta_plain
from tpustereo_torch.kernels.sgm import sgm_sweep_plain, sweep_bwd_wta_plain
from tpustereo_torch.kernels.wta import wta_lr_plain
from tpustereo_torch.ops.sgm import DIRS_8
from tpustereo_torch.pipeline import sgbm_batched

pytestmark = pytest.mark.gpu


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


def _conn(v: np.ndarray):
    """Edge masks joining neighbouring set pixels of v (..., H, W)."""
    return (torch.from_numpy(v[..., :, :-1] & v[..., :, 1:]),
            torch.from_numpy(v[..., :-1, :] & v[..., 1:, :]))


def _volume(cuda, B, H, W, D, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 25, (B, H, W, D), dtype=np.uint8)).to(cuda)


@pytest.mark.parametrize("D,d0,window", [(16, 0, (5, 5)), (30, 3, (5, 5)),
                                         (128, 0, (7, 9)), (64, 5, (5, 13))])
def test_cost_kernel_matches_plain(cuda, D, d0, window):
    L, R = _pairs(2, (23, 57))
    L, R = L.to(cuda), R.to(cuda)
    bits = window[0] * window[1] - 1
    got = kernels.census_cost_volume(L, R, D, bits, window, d0)
    ref = census_cost_volume_plain(L, R, D, bits, window, d0)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("D", [16, 40, 128, 200])
@pytest.mark.parametrize("direction", DIRS_8)
def test_sweep_kernel_matches_plain(cuda, D, direction):
    C = _volume(cuda, 2, 19, 43, D)
    got = torch.full(C.shape, 7, dtype=torch.int16, device=cuda)
    ref = got.clone()
    kernels.sgm_sweep(C, got, *direction, 10, 120)
    sgm_sweep_plain(C, ref, *direction, 10, 120)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("D,uniq,subpixel,d0", [
    (16, 10, True, 0), (16, 0, False, 0), (40, 5, True, 3),
    (128, 10, True, 0), (200, 10, True, 2), (3, 10, True, 0)])
def test_bwd_wta_kernel_matches_plain(cuda, D, uniq, subpixel, d0):
    C = _volume(cuda, 2, 17, 41, D, seed=1)
    cfg = Config(num_disparities=D, uniqueness_ratio=uniq,
                 subpixel=subpixel, min_disparity=d0, p1=7, p2=90)
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


@pytest.mark.parametrize("name", CC_MASKS)
def test_cc_kernel_matches_plain(cuda, name):
    conn_h, conn_v = _conn(_cc_masks(name))
    got = kernels.connected_component_labels(conn_h.to(cuda),
                                             conn_v.to(cuda))
    torch.cuda.synchronize()
    ref = connected_component_labels_plain(conn_h, conn_v)
    assert torch.equal(got.cpu(), ref)
    if name in ("hilbert", "serpentine"):
        v = torch.from_numpy(_cc_masks(name))
        assert got.cpu()[v].unique().numel() == 1


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


@pytest.mark.parametrize("shape", [(40, 72), (1, 17), (2, 9), (13, 1),
                                   (11, 2), (3, 21, 37), (2, 1, 1),
                                   (4, 375, 1242)])
def test_median_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(7)
    d = rng.uniform(0, 60, shape).astype(np.float32)
    d[rng.random(shape) < 0.3] = -1.0
    x = torch.from_numpy(d).to(cuda)
    got = kernels.median3(x)
    ref = median3_plain(x)
    torch.cuda.synchronize()
    assert got.shape == x.shape
    assert torch.equal(got, ref)


# (d0, uniqueness, subpixel, disp12_max_diff): min_disparity 0/3,
# uniqueness 0/10, subpixel on/off, LR off/on at max_diff 0, 1, 2
SELECT_KNOBS = [(0, 10, True, 1), (3, 0, False, -1), (3, 10, True, 0),
                (0, 0, True, 2), (3, 10, False, 1)]


@pytest.mark.parametrize("H,W,D", [(17, 41, 16), (1, 45, 32), (9, 20, 40),
                                   (5, 37, 512), (6, 200, 128)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16])
@pytest.mark.parametrize("knobs", SELECT_KNOBS)
def test_wta_lr_kernel_matches_plain(cuda, H, W, D, dtype, knobs):
    d0, uniq, subpixel, d12 = knobs
    rng = np.random.default_rng(3)
    top = 25 if dtype == torch.uint8 else 1000     # census-like ties / S
    S = torch.from_numpy(rng.integers(0, top, (2, H, W, D))).to(dtype)
    S = S.to(cuda)
    cfg = Config(num_disparities=D, min_disparity=d0, uniqueness_ratio=uniq,
                 subpixel=subpixel, disp12_max_diff=d12)
    disp, valid = kernels.wta_lr(S, cfg)
    disp_p, valid_p = wta_lr_plain(S, cfg)
    torch.cuda.synchronize()
    assert torch.equal(valid, valid_p)
    assert (disp - disp_p).abs().max().item() <= 1e-6


@pytest.mark.parametrize("shape,D", [((23, 57), 16), ((1, 45), 32),
                                     ((9, 20), 40), ((12, 70), 512),
                                     ((30, 100), 64)])
@pytest.mark.parametrize("block", [5, 9, 13, 8])
@pytest.mark.parametrize("knobs", SELECT_KNOBS)
def test_sad_wta_kernel_matches_plain(cuda, shape, D, block, knobs):
    d0, uniq, subpixel, d12 = knobs
    L, R = _pairs(2, shape, seed=4)
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


@pytest.mark.parametrize("mode,paths,d0", [
    ("sgm", 8, 0), ("sgm", 4, 0), ("sgm", 8, 4), ("census_wta", 8, 0),
    ("census_wta", 8, 3), ("sad", 8, 0), ("sad", 8, 3)])
def test_pipeline_cuda_matches_cpu(cuda, mode, paths, d0):
    L, R = _pairs(4, (33, 49), seed=10)
    cfg = Config(mode=mode, num_disparities=32, paths=paths,
                 min_disparity=d0, speckle_window_size=100, speckle_range=2,
                 median_filter=True, frames_per_step=2)
    kernels.reset_launch_counts()
    got = sgbm_batched(L.to(cuda), R.to(cuda), cfg).cpu()
    counts = kernels.launch_counts()
    ref = sgbm_batched(L, R, cfg)
    assert torch.equal(got == -1.0, ref == -1.0)
    assert (got - ref).abs().max().item() <= 1e-6
    expected = dict.fromkeys(counts, 0)
    expected.update(connected_component_labels=2, median3=2)
    if mode == "sgm":
        expected.update(census_cost_volume=2, sgm_sweep=2 * (paths - 1),
                        sweep_bwd_wta=2, dr_consistency=2)
    elif mode == "census_wta":
        expected.update(census_cost_volume=2, wta_lr=2)
    else:
        expected.update(sad_wta=2, dr_consistency=2)
    assert counts == expected


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
    with pytest.raises(ValueError, match="shared memory"):
        kernels.wta_lr(torch.zeros((1, 1, 30000, 4), dtype=torch.uint8,
                                   device=cuda), Config(num_disparities=4))
    img = torch.zeros((1, 8, 16), dtype=torch.uint8, device=cuda)
    cfg = Config(mode="sad", num_disparities=16)
    with pytest.raises(ValueError):
        kernels.sad_wta(img.transpose(1, 2), img.transpose(1, 2), cfg)
    wide = torch.zeros((1, 2, 5000), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="4096"):
        kernels.sad_wta(wide, wide, cfg)
