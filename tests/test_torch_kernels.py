"""The port's kernel modules on the CPU: each wrapper's plain path against
the JAX Pallas kernel in interpret mode, the wrappers' dispatch and checks,
and the package's config, import and entry-point contracts.

Tolerance: integer outputs bit-exact; float disparity within atol 1e-6.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpustereo_torch
from tpustereo import ops as jops
from tpustereo.config import PRESETS as JPRESETS
from tpustereo.config import Config as JConfig
from tpustereo.kernels import census_cost_volume_pallas, dr_consistency_pallas
from tpustereo.pipeline import sgbm as j_sgbm
from tpustereo_torch import PRESETS, Config, api, kernels
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.kernels.sgm import bidir_fits_s16x2
from tpustereo_torch.pipeline import sgbm, sgbm_batched

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = Config(num_disparities=32, speckle_window_size=0, median_filter=False)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("D,d_start", [(32, 0), (32, 3), (64, 0)])
def test_cost_plain_matches_pallas_interpret(small_pair, D, d_start):
    L, R, _, _ = small_pair
    ref = census_cost_volume_pallas(jnp.asarray(L), jnp.asarray(R), D, 24,
                                    interpret=True, d_start=d_start)
    got = kernels.census_cost_volume(_t(L)[None], _t(R)[None], D, 24,
                                     (5, 5), d_start)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))


def test_cost_takes_any_width():
    """A 2 x 9,000 pair, past the 8,940 columns the kernel's old design
    took: the wrapper does not refuse it, and equals the JAX jnp ops."""
    rng = np.random.default_rng(9)
    L, R = (rng.integers(0, 256, (2, 9000), dtype=np.uint8) for _ in "LR")
    ref = jops.cost_volume(jops.census(jnp.asarray(L)),
                           jops.census(jnp.asarray(R)), 8, 24)
    got = kernels.census_cost_volume(_t(L)[None], _t(R)[None], 8, 24)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))


def test_wta_lr_takes_any_width():
    """A (1, 1, 30,000, 8) int16 volume with the LR check on, past the
    25,827 columns the kernel's old design took: the wrapper does not
    refuse it, and equals the JAX jnp `wta` + `lr_check`."""
    rng = np.random.default_rng(11)
    S = rng.integers(0, 1000, (1, 30000, 8), dtype=np.int16)
    jcfg = JConfig(num_disparities=8, min_disparity=2, disp12_max_diff=1)
    disp_r, _, valid_r = jops.wta(jnp.asarray(S), jcfg)
    valid_r = valid_r & jops.lr_check(jnp.asarray(S), disp_r, jcfg)
    disp, valid = kernels.wta_lr(_t(S)[None],
                                 config_from_jax(dataclasses.asdict(jcfg)))
    np.testing.assert_allclose(disp[0].numpy(), np.asarray(disp_r),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(valid_r))


@pytest.mark.parametrize("shape", [(40, 72, 32), (6, 20, 32)],
                         ids=["W>D", "W<D"])
@pytest.mark.parametrize("d_start", [0, 3])
def test_lr_plain_matches_pallas_interpret(rng, shape, d_start):
    H, W, D = shape
    d_r = rng.integers(0, D, (H, W), dtype=np.int32)
    disp = rng.uniform(d_start - 0.5, d_start + D - 0.5,
                       (H, W)).astype(np.float32)
    for max_diff in (0, 1, 2):
        ref = dr_consistency_pallas(jnp.asarray(d_r), jnp.asarray(disp), D,
                                    max_diff, interpret=True, d_start=d_start)
        got = kernels.dr_consistency(_t(d_r), _t(disp), D, max_diff, d_start)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=f"max_diff={max_diff}")


def test_cpu_tensors_take_the_plain_path(small_pair):
    kernels.reset_launch_counts()
    L, R, _, _ = small_pair
    out = sgbm(_t(L), _t(R), SLICE)
    assert out.shape == L.shape and out.dtype == torch.float32
    assert set(kernels.launch_counts().values()) == {0}


def test_wrappers_refuse_bad_inputs():
    img = torch.zeros((1, 8, 16), dtype=torch.uint8)
    with pytest.raises(TypeError):
        kernels.census_cost_volume(img.float(), img, 16, 24)
    with pytest.raises(ValueError):
        kernels.census_cost_volume(img[0], img[0], 16, 24)
    C = torch.zeros((1, 8, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        kernels.sgm_sweep(C, torch.zeros(C.shape, dtype=torch.int32), 1, 0,
                          10, 120)
    with pytest.raises(ValueError):
        kernels.sgm_sweep(C, torch.zeros(C.shape, dtype=torch.int16), 2, 0,
                          10, 120)
    with pytest.raises(TypeError):
        kernels.dr_consistency(torch.zeros((4, 8), dtype=torch.int64),
                               torch.zeros((4, 8)), 16, 1)


# (D, c_max, P1, P2, fits). The s16x2 build of `sgm_sweep_bidir` needs
# every lane of the warp full, D = 32 K (K = 1, 2, 4, 8 or 16 disparities a
# lane), and c_max + P1 + P2 < 2^15, the exactness condition of
# `sgm_step_s16x2` (`csrc/common.cuh`).
@pytest.mark.parametrize("D,c_max,p1,p2,fits", [
    (128, 24, 10, 120, True),  # kitti_sgm8: 154
    (32, 24, 10, 120, True), (64, 24, 10, 120, True),
    (256, 24, 10, 120, True), (512, 24, 10, 120, True),
    (96, 24, 10, 120, False),  # 3 a lane: K rounds up to 4, lanes not full
    (16, 24, 10, 120, False), (40, 24, 10, 120, False),
    (127, 24, 10, 120, False), (129, 24, 10, 120, False),
    (200, 24, 10, 120, False), (1024, 24, 10, 120, False),
    (128, 255, 10, 32502, True),   # 2^15 - 1
    (128, 255, 10, 32503, False),  # 2^15
    (64, 24, 0, 32743, True), (64, 24, 0, 32744, False),
    (32, 0, 16383, 16384, True), (32, 0, 16384, 16384, False),
])
def test_bidir_fits_s16x2_at_its_edges(D, c_max, p1, p2, fits):
    assert bidir_fits_s16x2(D, c_max, p1, p2) is fits


def test_reset_launch_counts_clears_the_build_counts():
    kernels.sgm_sweep_bidir.builds["s16x2"] += 3
    kernels.reset_launch_counts()
    assert kernels.sgm_sweep_bidir.builds == {"s16x2": 0, "int32": 0}


@pytest.mark.parametrize("name", sorted(JPRESETS))
def test_config_from_jax_round_trips_presets(name):
    jcfg = JPRESETS[name]
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg == PRESETS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(Config)]
            == [f.name for f in dataclasses.fields(JConfig)])
    toml = os.path.join(ROOT, "configs", "kitti_sgm8.toml")
    if os.path.exists(toml):
        assert Config.from_toml(toml) == config_from_jax(
            dataclasses.asdict(JConfig.from_toml(toml)))


def test_import_loads_neither_jax_nor_tpustereo():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpustereo_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    tpustereo_torch.__path__, 'tpustereo_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'tpustereo')]\n"
        "print(' '.join(names))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())   # the walk reached every module
    assert {"tpustereo_torch.api", "tpustereo_torch.kernels.sgm",
            "tpustereo_torch.kernels.sad", "tpustereo_torch.kernels.wta",
            "tpustereo_torch.kernels.transpose",
            "tpustereo_torch.kernels.bitonic",
            "tpustereo_torch.kernels.width_micro",
            "tpustereo_torch.ops.census", "tpustereo_torch.ops.sad",
            "tpustereo_torch.pipeline.sgbm",
            "tpustereo_torch.odometry.backend",
            "tpustereo_torch.odometry.fused",
            "tpustereo_torch.odometry.pose_graph",
            "tpustereo_torch.eval.metrics",
            "tpustereo_torch.data.datasets",
            "tpustereo_torch.dist.mesh", "tpustereo_torch.dist.tiling",
            "tpustereo_torch.dist.batching",
            "tpustereo_torch.dist.disp_shard",
            "tpustereo_torch.data.io", "tpustereo_torch.data.prefetch",
            "tpustereo_torch.eval.bench", "tpustereo_torch.eval.roofline",
            "tpustereo_torch.eval.runner", "tpustereo_torch.golden",
            "tpustereo_torch.golden.opencv_ref", "tpustereo_torch.cli.main",
            "tpustereo_torch.cli.__main__",
            "tpustereo_torch.bench.__main__"} <= names


def test_entry_points_need_cuda_unless_told_cpu(small_pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    L, R, _, _ = small_pair
    with pytest.raises(RuntimeError, match="CUDA"):
        api.match_pair(L, R, SLICE)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.match_batch(L[None], R[None], SLICE)
    out = api.match_pair(L, R, SLICE, device="cpu")
    assert out.shape == L.shape and out.dtype == np.float32


@pytest.mark.parametrize("change", [
    dict(mode="census_wta", num_disparities=640),
    dict(num_disparities=640),
    dict(p2=5000)], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_out_of_slice_configs_raise(change):
    img = torch.zeros((1, 8, 16), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sgbm_batched(img, img, SLICE.replace(**change))


@pytest.mark.parametrize("change", [
    dict(mode="sad", fill_mode="background"),
    dict(fill_mode="background"), dict(fill_mode="hirschmuller"),
    dict(adaptive_p2=True)],
    ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_out_of_slice_configs_raise_no_more(small_pair, change):
    """Configurations that earlier slices refused now run, equal to the JAX
    jnp pipeline."""
    L, R, _, _ = small_pair
    jcfg = JConfig(**{**dataclasses.asdict(SLICE), **change,
                      "backend": "jnp"})
    ref = np.asarray(j_sgbm(jnp.asarray(L), jnp.asarray(R), jcfg))
    got = sgbm(_t(L), _t(R), config_from_jax(dataclasses.asdict(jcfg)))
    np.testing.assert_array_equal(got.numpy() == -1.0, ref == -1.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_package_reexports_config():
    assert tpustereo_torch.Config is Config
    assert set(tpustereo_torch.PRESETS) == set(JPRESETS)
