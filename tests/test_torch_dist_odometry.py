"""The port's strip-tiled odometry (BASELINE config 5), batch data
parallelism and the disparity-axis split on the CPU, against the JAX
package on the forced host devices (`tests/conftest.py`), `backend="jnp"`.

* `StereoOdometry` / `api.run_sequence` with `PRESETS["kitti_odometry"]`
  (2 strips; halo mode as shipped, and exact mode) at D = 16 over a
  64 x 96 sequence, against the JAX `StereoOdometry` with `make_mesh(1, 2)`;
  the calls a tracked frame makes (the tiled matcher, then
  `fused_track_from_disp`).
* `dist.sgbm_data_parallel` and `dist.wta_disparity_sharded` against the
  JAX functions.

Inputs are made from seeds with numpy and handed to both packages.

Tolerance: trajectories within `test_pinned_odometry.ATE_TOL` (2e-3 m);
disparity within 1e-5 with the invalid pattern exact; the sharded WTA's
integer disparity exact.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pinned_odometry import ATE_TOL
from tpustereo.config import PRESETS as JPRESETS
from tpustereo.config import Config as JConfig
from tpustereo.data.synthetic import synthetic_sequence as j_sequence
from tpustereo.dist import make_mesh as j_make_mesh
from tpustereo.dist import sgbm_data_parallel as j_data_parallel
from tpustereo.dist import wta_disparity_sharded as j_wta_sharded
from tpustereo.odometry import StereoOdometry as JStereoOdometry
from tpustereo_torch import api, dist
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.data import synthetic_pair, synthetic_sequence
from tpustereo_torch.odometry import StereoOdometry, fused


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


def _seq(n=4):
    kw = dict(n_frames=n, shape=(64, 96), depth=8.0, fx=200.0, baseline=0.5,
              step_x=0.08, slant=0.35, seed=3)
    return j_sequence(**kw), synthetic_sequence(**kw)


MODES = {
    "halo": {},
    "exact": {"exact_tiling": True},
}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX tiled odometry's trajectory in each mode."""
    (jcalib, frames, _), _ = _seq()
    out = {}
    for mode, kw in MODES.items():
        jcfg = JPRESETS["kitti_odometry"].replace(
            num_disparities=16, speckle_window_size=20, backend="jnp", **kw)
        odo = JStereoOdometry(jcalib, jcfg, mesh=j_make_mesh(1, 2))
        for L, R in frames:
            odo.step(L, R)
        out[mode] = odo.trajectory()
    return out


@pytest.mark.parametrize("mode", MODES)
def test_tiled_odometry_matches_jax(jax_runs, mode):
    """kitti_odometry with strips = 2 (H = 64: 32-row strips, halo 32 as
    shipped) through `api.run_sequence`, the trajectory against JAX's."""
    (_, jframes, _), (calib, frames, gt) = _seq()
    for (jl, jr), (pl, pr) in zip(jframes, frames):
        np.testing.assert_array_equal(jl, pl)
        np.testing.assert_array_equal(jr, pr)
    cfg = _cfg(JPRESETS["kitti_odometry"]).replace(
        num_disparities=16, speckle_window_size=20, **MODES[mode])
    assert cfg.strips == 2 and cfg.halo == 32
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # no halo clamp at this height
        traj = api.run_sequence(frames, calib, cfg, device="cpu")
    np.testing.assert_allclose(traj, jax_runs[mode], rtol=0, atol=ATE_TOL)
    err = np.linalg.norm(traj[:, :3, 3] - gt[:, :3, 3], axis=-1)
    assert err[-1] < 0.5 * np.linalg.norm(gt[-1, :3, 3]) + 0.05


def test_tiled_step_runs_the_tiled_matcher(monkeypatch):
    """Every frame with strips > 1: one tiled matcher call, then tracking
    from its disparity; no fused_track_step. With a mesh given, its strips
    are used."""
    counts = {"tiled": 0, "from_disp": 0, "step": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(dist, "sgbm_tiled", spy("tiled", dist.sgbm_tiled))
    monkeypatch.setattr(fused, "fused_track_from_disp",
                        spy("from_disp", fused.fused_track_from_disp))
    monkeypatch.setattr(fused, "fused_track_step",
                        spy("step", fused.fused_track_step))
    _, (calib, frames, _) = _seq(3)
    cfg = _cfg(JConfig(num_disparities=16, speckle_window_size=20))
    odo = StereoOdometry(calib, cfg.replace(strips=2, exact_tiling=True),
                         device="cpu",
                         mesh=dist.make_mesh(1, 4, device="cpu"))
    for L, R in frames:
        odo.step(L, R)
    assert counts == {"tiled": 3, "from_disp": 3, "step": 0}
    assert odo._mesh.shape["strip"] == 4
    counts.update(tiled=0, from_disp=0)
    api.run_sequence(frames, calib, cfg, device="cpu")
    assert counts == {"tiled": 0, "from_disp": 0, "step": 3}


def test_data_parallel_matches_jax():
    L, R, _, _ = synthetic_pair((48, 64), disparity=6.0, slope=0.05, seed=7)
    lefts = np.stack([L, L[::-1], L, L[:, ::-1]])
    rights = np.stack([R, R[::-1], R, R[:, ::-1]])
    jcfg = JConfig(num_disparities=16, speckle_window_size=20, paths=4,
                   backend="jnp")
    ref = np.asarray(j_data_parallel(jnp.asarray(lefts), jnp.asarray(rights),
                                     jcfg, j_make_mesh(4, 1)))
    got = dist.sgbm_data_parallel(_t(lefts), _t(rights), _cfg(jcfg),
                                  dist.make_mesh(4, 1, device="cpu")).numpy()
    np.testing.assert_array_equal(got == -1.0, ref == -1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="data axis"):
        dist.sgbm_data_parallel(_t(lefts[:3]), _t(rights[:3]), _cfg(jcfg),
                                dist.make_mesh(2, 1, device="cpu"))


@pytest.mark.parametrize("mode", ["census_wta", "sad"])
@pytest.mark.parametrize("strips", [2, 4])
def test_wta_disparity_sharded_matches_jax(mode, strips):
    L, R, _, _ = synthetic_pair((48, 64), disparity=6.0, slope=0.05, seed=7)
    jcfg = JConfig(mode=mode, num_disparities=16, min_disparity=2,
                   backend="jnp")
    ref = np.asarray(j_wta_sharded(jnp.asarray(L), jnp.asarray(R), jcfg,
                                   j_make_mesh(1, strips)))
    got = dist.wta_disparity_sharded(_t(L), _t(R), _cfg(jcfg),
                                     dist.make_mesh(1, strips, device="cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wta_disparity_sharded_refusals():
    L = torch.zeros((8, 8), dtype=torch.uint8)
    mesh = dist.make_mesh(1, 3, device="cpu")
    with pytest.raises(ValueError, match="SGM"):
        dist.wta_disparity_sharded(L, L, _cfg(JConfig()), mesh)
    with pytest.raises(ValueError, match="divide"):
        dist.wta_disparity_sharded(
            L, L, _cfg(JConfig(mode="sad", num_disparities=16)), mesh)
