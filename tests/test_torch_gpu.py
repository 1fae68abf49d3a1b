"""Card tests of the port: each CUDA kernel against its plain PyTorch
version on the card. They need a CUDA card and skip without one.

Run them on a machine with a card (no JAX needed there):

    python -m pytest -p no:cacheprovider --noconftest -o addopts="" \
        -m gpu tests/test_torch_gpu.py

Tolerance: integer outputs bit-exact; float disparity within 1e-6.
"""

import numpy as np
import pytest
import torch

from tpustereo_torch import Config, kernels
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.kernels.cost import census_cost_volume_plain
from tpustereo_torch.kernels.lr import dr_consistency_plain
from tpustereo_torch.kernels.sgm import sgm_sweep_plain, sweep_bwd_wta_plain
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


@pytest.mark.parametrize("paths,d0", [(8, 0), (4, 0), (8, 4)])
def test_pipeline_cuda_matches_cpu(cuda, paths, d0):
    L, R = _pairs(4, (33, 49), seed=10)
    cfg = Config(num_disparities=32, paths=paths, min_disparity=d0,
                 speckle_window_size=0, median_filter=False,
                 frames_per_step=2)
    kernels.reset_launch_counts()
    got = sgbm_batched(L.to(cuda), R.to(cuda), cfg).cpu()
    counts = kernels.launch_counts()
    ref = sgbm_batched(L, R, cfg)
    assert torch.equal(got == -1.0, ref == -1.0)
    assert (got - ref).abs().max().item() <= 1e-6
    assert counts == {"census_cost_volume": 2,
                      "sgm_sweep": 2 * (paths - 1),
                      "sweep_bwd_wta": 2, "dr_consistency": 2}


def test_wrappers_refuse_bad_cuda_inputs(cuda):
    C = _volume(cuda, 1, 8, 16, 16)
    S = torch.zeros(C.shape, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernels.sgm_sweep(C, S, 1, 0, 10, 120)
    S16 = torch.zeros(C.shape, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        kernels.sgm_sweep(C.transpose(1, 2), S16.transpose(1, 2), 1, 0, 10,
                          120)
