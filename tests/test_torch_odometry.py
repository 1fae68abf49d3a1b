"""The port's odometry (`tpustereo_torch.odometry`, `api.run_sequence`,
`eval.metrics`, `data.datasets`, `synthetic_sequence`) against the JAX
package's, on the CPU, at small sizes; the JAX side runs its jnp pipeline
(`backend="jnp"`).

Tolerances, each stated where it is used:
* SE(3) maps: 1e-6. GN pose: T and the residual 1e-5.
* Harris response: atol 1e-6 + rtol 1e-4. The JAX box sums are
  differences of float32 cumsums, the port's the shifted rows added in
  order: the same sums in another rounding (about 1e-7 here).
* Corners: the same valid corners, each at a subpixel position within
  1e-3 px: a parabola's offset divides the response's rounding by its
  curvature (3e-4 px at most over 24 seeded images), so positions within
  1e-3 px are the same integer corner (integers differ by 1) with an
  offset that JAX's own rounding does not fix more closely.
* Descriptors 1e-6; matches equal.
* Pose graph 1e-5; backprojection 1e-5 (m).
* A tracked step: disparity as the pipeline tests (invalid pattern exact,
  1e-6), T 1e-5.
* Trajectories: `test_pinned_odometry.py`'s ATE_TOL (2e-3 m) against JAX,
  and its ATE/RPE tolerances against `tests/data/pinned_odometry.json`.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pinned_odometry import (ATE_TOL, PIN_PATH, RPE_R_TOL,
                                        RPE_T_TOL, SEQ)
from tpustereo.config import PRESETS as JPRESETS
from tpustereo.config import Config as JConfig
from tpustereo.data import datasets as jdatasets
from tpustereo.data.synthetic import synthetic_sequence as j_sequence
from tpustereo.eval import metrics as jmetrics
from tpustereo.odometry import OdometryConfig as JOdometryConfig
from tpustereo.odometry import PoseGraph as JPoseGraph
from tpustereo.odometry import StereoOdometry as JStereoOdometry
from tpustereo.odometry import features as jfeatures
from tpustereo.odometry import fused as jfused
from tpustereo.odometry import pnp as jpnp
from tpustereo.odometry import pose_graph as jpose_graph
from tpustereo.odometry import se3 as jse3
from tpustereo_torch import api
from tpustereo_torch.convert import config_from_jax, odometry_config_from_jax
from tpustereo_torch.data import (KittiCalib, parse_kitti_odometry_calib,
                                  synthetic_sequence)
from tpustereo_torch.dist import make_mesh
from tpustereo_torch.eval import metrics
from tpustereo_torch.odometry import (OdometryConfig, PoseGraph,
                                      StereoOdometry, features, fused, pnp,
                                      pose_graph, se3)

# the pinned sequence's matcher and odometry configurations
PIN_CFG = JConfig(num_disparities=32, paths=8, speckle_window_size=50,
                  backend="jnp")
PIN_OCFG = JOdometryConfig(loop_closure=False)
SPLIT = 5      # checkpoint after this many frames (one keyframe past the first)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


def _port_o(jocfg):
    return odometry_config_from_jax(dataclasses.asdict(jocfg))


def _twists():
    """Seeded twists [rho, w], the zero twist, and rotations near pi."""
    rng = np.random.default_rng(0)
    xs = [np.concatenate([rng.normal(0, 0.5, 3), rng.normal(0, 0.2, 3)])
          for _ in range(6)]
    xs.append(np.zeros(6))
    for th in (3.0, np.pi - 1e-2, np.pi - 1e-3):
        ax = rng.normal(size=3)
        xs.append(np.concatenate([rng.normal(0, 0.5, 3),
                                  th * ax / np.linalg.norm(ax)]))
    return np.stack(xs).astype(np.float32)


# --- se3 ------------------------------------------------------------------

def test_se3_matches_jax():
    xi = _twists()
    T = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    pairs = [
        (np.asarray(jse3.hat(jnp.asarray(xi[:, 3:]))), se3.hat(_t(xi[:, 3:]))),
        (np.asarray(jse3.exp_so3(jnp.asarray(xi[:, 3:]))),
         se3.exp_so3(_t(xi[:, 3:]))),
        (T, se3.exp_se3(_t(xi))),
        (np.asarray(jse3.log_so3(jnp.asarray(T[:, :3, :3]))),
         se3.log_so3(_t(T[:, :3, :3]))),
        (np.asarray(jse3.log_se3(jnp.asarray(T))), se3.log_se3(_t(T))),
        (np.asarray(jse3.inv_se3(jnp.asarray(T))), se3.inv_se3(_t(T))),
    ]
    for ref, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_se3_round_trips():
    xi = _t(_twists())
    T = se3.exp_se3(xi)
    R = T[:, :3, :3]
    np.testing.assert_allclose((R @ R.transpose(1, 2)).numpy(),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-6)
    np.testing.assert_allclose((se3.inv_se3(T) @ T).numpy(),
                               np.broadcast_to(np.eye(4), T.shape), atol=1e-6)
    # log inverts exp to pi - 0.14; nearer pi the float32 log (JAX's too)
    # loses the axis, so there the maps are held only to JAX's values
    small = xi[:7]
    np.testing.assert_allclose(se3.log_se3(se3.exp_se3(small)).numpy(),
                               small.numpy(), atol=1e-6)
    np.testing.assert_allclose(se3.exp_se3(se3.log_se3(T[:8])).numpy(),
                               T[:8].numpy(), atol=1e-5)


def test_se3_jacobian_at_identity_is_finite():
    """Why `_safe_theta` exists: forward-mode derivatives of exp/log at the
    zero twist, where the pose-graph GN linearises."""
    J = torch.func.jacfwd(lambda x: se3.log_se3(se3.exp_se3(x)))(
        torch.zeros(6))
    assert J.dtype == torch.float32
    np.testing.assert_allclose(J.numpy(), np.eye(6), atol=1e-6)


# --- pnp ------------------------------------------------------------------

@pytest.mark.parametrize("iters", [10, 15])
def test_gauss_newton_pose_matches_jax(iters):
    rng = np.random.default_rng(2)
    intr = np.array([400.0, 400.0, 64.0, 48.0], np.float32)
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 12], (150, 3)).astype(np.float32)
    T_true = np.asarray(jse3.exp_se3(jnp.asarray(
        np.array([0.1, -0.05, 0.15, 0.02, -0.03, 0.01], np.float32))))
    P = X @ T_true[:3, :3].T + T_true[:3, 3]
    u = np.array(jpnp.project(jnp.asarray(P), *intr))
    w = np.ones(150, np.float32)
    w[:10] = 0.0                                    # invalid matches
    u[:10] += 500.0
    u[10:30] += rng.normal(0, 40.0, (20, 2))        # gross outliers, weight 1
    T_j, r_j = jpnp.gauss_newton_pose(jnp.asarray(X), jnp.asarray(u),
                                      jnp.asarray(w), jnp.asarray(intr),
                                      iters=iters)
    T_p, r_p = pnp.gauss_newton_pose(_t(X), _t(u), _t(w), _t(intr),
                                     iters=iters)
    np.testing.assert_allclose(T_p.numpy(), np.asarray(T_j), atol=1e-5)
    assert abs(float(r_p) - float(r_j)) <= 1e-5 * max(1.0, float(r_j))
    np.testing.assert_allclose(T_p.numpy(), T_true, atol=0.05)


# --- features -------------------------------------------------------------

def _frames(seed=3, n=2, shape=(96, 128)):
    return synthetic_sequence(n_frames=n, shape=shape, depth=8.0, fx=200.0,
                              baseline=0.5, step_x=0.08, slant=0.35,
                              seed=seed)


@pytest.mark.parametrize("seed", [3, 4])
def test_harris_response_matches_jax(seed):
    img = _frames(seed)[1][0][0]
    ref = np.asarray(jfeatures.harris_response(jnp.asarray(img)))
    got = features.harris_response(_t(img))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("K", [32, 512])
def test_detect_corners_matches_jax(K):
    img = _frames()[1][0][0]
    resp = features.harris_response(_t(img)).numpy()
    p_j, v_j = jfeatures.detect_corners(jnp.asarray(img), max_corners=K)
    p_j, v_j = np.asarray(p_j), np.asarray(v_j)
    p_p, v_p = features.detect_corners(_t(img), max_corners=K)
    n_valid = int(features.detect_corners(_t(img), max_corners=4096)[1].sum())
    if K < n_valid:
        # the K-th and (K+1)-th selected scores are further apart than the
        # response tolerance, so both packages select the same K
        score = np.sort(np.asarray(
            jfeatures.harris_response(jnp.asarray(img))).reshape(-1))
        top = features.detect_corners(_t(img), max_corners=K + 1)[0].numpy()
        iy, ix = np.round(top[-2:]).astype(int).T
        assert abs(resp[iy[0], ix[0]] - resp[iy[1], ix[1]]) > \
            1e-6 + 1e-4 * np.abs(score).max()
    else:
        # fewer valid corners than K: the tail of pts is the -inf tie rule
        # (lowest flat index first), which a stable sort keeps
        assert n_valid < K and not v_p[n_valid:].any()
        tail = p_p[n_valid:n_valid + 3].round().numpy()
        np.testing.assert_array_equal(tail, [[0, 0], [0, 1], [0, 2]])
    np.testing.assert_array_equal(v_p.numpy(), v_j)
    np.testing.assert_allclose(p_p.numpy(), p_j, rtol=0, atol=1e-3)


def test_describe_and_match_match_jax():
    _, frames, _ = _frames(n=2)
    a, b = frames[0][0], frames[1][0]
    pa, va = (np.asarray(x) for x in jfeatures.detect_corners(
        jnp.asarray(a), max_corners=128))
    pb, vb = (np.array(x) for x in jfeatures.detect_corners(
        jnp.asarray(b), max_corners=128))
    # a clamped patch start at each image border
    pb[:4] = [[0.0, 0.0], [95.0, 127.0], [-0.4, 127.4], [95.4, 0.0]]
    da = np.asarray(jfeatures.describe(jnp.asarray(a), jnp.asarray(pa)))
    db = np.asarray(jfeatures.describe(jnp.asarray(b), jnp.asarray(pb)))
    np.testing.assert_allclose(features.describe(_t(a), _t(pa)).numpy(), da,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(features.describe(_t(b), _t(pb)).numpy(), db,
                               rtol=0, atol=1e-6)
    for sim in (0.6, 0.9):
        i_j, g_j = jfeatures.match_descriptors(
            jnp.asarray(da), jnp.asarray(db), jnp.asarray(va),
            jnp.asarray(vb), min_similarity=sim)
        i_p, g_p = features.match_descriptors(_t(da), _t(db), _t(va), _t(vb),
                                              min_similarity=sim)
        assert i_p.dtype == torch.int32
        np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(g_p.numpy(), np.asarray(g_j))
        assert g_p.sum() > 10                  # real matches are compared


def test_batched_candidate_match_matches_jax():
    rng = np.random.default_rng(6)
    d = rng.normal(size=(4, 64, 64)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    new = d[2] + rng.normal(0, 0.05, (64, 64)).astype(np.float32)
    new /= np.linalg.norm(new, axis=-1, keepdims=True)
    valids = rng.random((4, 64)) < 0.8
    valids[3] = False                          # a padded candidate
    new_valid = rng.random(64) < 0.9
    ref = jfused.batched_candidate_match(jnp.asarray(d), jnp.asarray(valids),
                                         jnp.asarray(new),
                                         jnp.asarray(new_valid), 0.6)
    got = fused.batched_candidate_match(_t(d), _t(valids), _t(new),
                                        _t(new_valid), 0.6)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(np.argmax(got[2].numpy())) == 2


# --- pose graph -----------------------------------------------------------

def _noisy_graph(seed=4, N=8):
    """The JAX unit test's graph: a noisy odometry chain with an exact
    loop-closure edge 0 -> N-1 of weight 10."""
    rng = np.random.default_rng(seed)
    step = np.asarray(jse3.exp_se3(jnp.asarray(
        np.array([0.5, 0, 0, 0, 0, 0], np.float32))))
    poses, edges = [np.eye(4, dtype=np.float32)], []
    truth = [np.eye(4, dtype=np.float32)]
    for i in range(1, N):
        noise = np.asarray(jse3.exp_se3(jnp.asarray(np.concatenate(
            [rng.normal(0, 0.03, 3), rng.normal(0, 0.01, 3)]
        ).astype(np.float32))))
        s = (step @ noise).astype(np.float32)
        poses.append((poses[-1] @ s).astype(np.float32))
        truth.append((truth[-1] @ step).astype(np.float32))
        edges.append((i - 1, i, s, 1.0))
    edges.append((0, N - 1, (np.linalg.inv(truth[0]) @ truth[-1])
                  .astype(np.float32), 10.0))
    return poses, edges, truth


def test_optimize_poses_matches_jax():
    poses, edges, truth = _noisy_graph()
    ij = np.array([e[:2] for e in edges], np.int32)
    Ts = np.stack([e[2] for e in edges])
    w = np.array([e[3] for e in edges], np.float32)
    ref = np.asarray(jpose_graph.optimize_poses(
        jnp.asarray(np.stack(poses)), jnp.asarray(ij), jnp.asarray(Ts),
        jnp.asarray(w), iters=15))
    got = pose_graph.optimize_poses(_t(np.stack(poses)), _t(ij), _t(Ts),
                                    _t(w), iters=15)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # the graph API: same poses, and the closure pins the endpoint
    g = PoseGraph(device="cpu")
    for p in poses:
        g.add_keyframe(p)
    for e in edges:
        g.add_edge(*e[:3], weight=e[3])
    out = g.optimize(iters=15)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    err = np.linalg.norm(out[-1, :3, 3] - truth[-1][:3, 3])
    assert err < 0.35 * np.linalg.norm(poses[-1][:3, 3] - truth[-1][:3, 3])


def test_backproject_matches_jax():
    rng = np.random.default_rng(8)
    disp = rng.uniform(-1.0, 30.0, (48, 64)).astype(np.float32)
    disp[::7] = -1.0
    pts = np.concatenate([rng.uniform(-0.6, [48.4, 64.4], (60, 2)),
                          [[0.5, 0.5], [47.5, 63.5], [2.5, 3.5]]]
                         ).astype(np.float32)
    intr = np.array([200.0, 201.0, 32.0, 24.0], np.float32)
    X_j, ok_j = jfused.backproject(jnp.asarray(pts), jnp.asarray(disp),
                                   jnp.asarray(intr), jnp.float32(0.5),
                                   0.5, 80.0)
    X_p, ok_p = fused.backproject(_t(pts), _t(disp), _t(intr),
                                  torch.tensor(0.5), 0.5, 80.0)
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(X_p.numpy(), np.asarray(X_j), rtol=1e-6,
                               atol=1e-5)
    assert 0 < ok_p.sum() < len(pts)


# --- the tracked step and the sequence ------------------------------------

def _intr(calib):
    return np.array([calib.fx, calib.fy, calib.cx, calib.cy], np.float32)


def _zeros(K):
    return (np.zeros((K, 64), np.float32), np.zeros((K,), bool),
            np.zeros((K, 3), np.float32))


def test_fused_track_step_matches_jax():
    jcfg = JConfig(num_disparities=24, speckle_window_size=20, backend="jnp")
    jocfg = JOdometryConfig(max_corners=128)
    cfg, ocfg = _port(jcfg), _port_o(jocfg)
    calib, frames, _ = _frames(seed=3, n=2)
    intr, b = _intr(calib), np.float32(calib.baseline)
    j_kf = jfused.fused_track_step(
        jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]),
        *(jnp.asarray(z) for z in _zeros(128)), jnp.asarray(intr), b,
        jcfg, jocfg)
    kf = (np.asarray(j_kf.desc), np.asarray(j_kf.valid), np.asarray(j_kf.X))
    ref = jfused.fused_track_step(
        jnp.asarray(frames[1][0]), jnp.asarray(frames[1][1]),
        *(jnp.asarray(k) for k in kf), jnp.asarray(intr), b, jcfg, jocfg)
    got = fused.fused_track_step(_t(frames[1][0]), _t(frames[1][1]),
                                 *(_t(k) for k in kf), _t(intr),
                                 torch.tensor(b), cfg, ocfg)
    d_ref = np.asarray(ref.disp)
    np.testing.assert_array_equal(got.disp.numpy() == -1.0, d_ref == -1.0)
    np.testing.assert_allclose(got.disp.numpy(), d_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.pts.numpy(), np.asarray(ref.pts),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), atol=1e-5)
    assert int(got.n_matches) == int(ref.n_matches) > 20
    # the bootstrap state holds T = I and matches nothing
    boot = fused.fused_track_step(_t(frames[0][0]), _t(frames[0][1]),
                                  *(_t(z) for z in _zeros(128)), _t(intr),
                                  torch.tensor(b), cfg, ocfg)
    assert int(boot.n_matches) == 0 and torch.equal(boot.T, torch.eye(4))


def test_fused_track_frames_matches_single_steps():
    cfg = _port(JConfig(num_disparities=16, speckle_window_size=20))
    ocfg = OdometryConfig(max_corners=128)
    calib, frames, _ = synthetic_sequence(
        n_frames=4, shape=(48, 64), depth=8.0, fx=200.0, baseline=0.5,
        step_x=0.08, slant=0.35, seed=3)
    intr, b = _t(_intr(calib)), torch.tensor(calib.baseline,
                                            dtype=torch.float32)
    kf0 = fused.fused_track_step(_t(frames[0][0]), _t(frames[0][1]),
                                 *(_t(z) for z in _zeros(128)), intr, b, cfg,
                                 ocfg)
    kf = (kf0.desc, kf0.valid, kf0.X)
    Ls = torch.stack([_t(L) for L, _ in frames[1:]])
    Rs = torch.stack([_t(R) for _, R in frames[1:]])
    chunk = fused.fused_track_frames(Ls, Rs, *kf, intr, b, cfg, ocfg)
    assert chunk.T.shape == (3, 4, 4) and chunk.pts.shape == (3, 128, 2)
    for f in range(3):
        single = fused.fused_track_step(Ls[f], Rs[f], *kf, intr, b, cfg,
                                        ocfg)
        for name in ("disp", "pts", "desc", "valid", "X", "n_matches"):
            assert torch.equal(getattr(chunk, name)[f],
                               getattr(single, name)), name
        np.testing.assert_allclose(chunk.T[f].numpy(), single.T.numpy(),
                                   atol=1e-5)


@pytest.fixture(scope="module")
def pinned_run(tmp_path_factory):
    """The pinned sequence through the JAX odometry: its trajectory, and a
    checkpoint written after SPLIT frames."""
    calib, frames, gt = j_sequence(**SEQ)
    odo = JStereoOdometry(calib, PIN_CFG, PIN_OCFG)
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt") / "ckpt.npz")
    for i, (L, R) in enumerate(frames):
        odo.step(L, R)
        if i + 1 == SPLIT:
            odo.save(ckpt)
    return dict(calib=calib, frames=frames, gt=gt, traj=odo.trajectory(),
                ckpt=ckpt)


def test_synthetic_sequence_matches_jax(pinned_run):
    calib, frames, gt = synthetic_sequence(**SEQ)
    assert calib == KittiCalib(**dataclasses.asdict(pinned_run["calib"]))
    np.testing.assert_array_equal(gt, pinned_run["gt"])
    for (L, R), (jL, jR) in zip(frames, pinned_run["frames"]):
        np.testing.assert_array_equal(L, jL)
        np.testing.assert_array_equal(R, jR)


def test_run_sequence_matches_jax_and_pins(pinned_run):
    calib, frames, gt = synthetic_sequence(**SEQ)
    traj = api.run_sequence(frames, calib, _port(PIN_CFG), _port_o(PIN_OCFG),
                            device="cpu")
    assert traj.shape == pinned_run["traj"].shape == (len(frames), 4, 4)
    np.testing.assert_allclose(traj[:, :3, 3], pinned_run["traj"][:, :3, 3],
                               rtol=0, atol=ATE_TOL)
    a, r = metrics.ate(traj, gt), metrics.rpe(traj, gt, delta=1)
    got = {"ate_rmse": a["rmse"], "ate_max": a["max"],
           "rpe_trans_rmse": r["trans_rmse"],
           "rpe_rot_rmse_deg": r["rot_rmse_deg"]}
    with open(PIN_PATH) as f:
        pinned = json.load(f)
    for k, v in pinned.items():
        tol = (ATE_TOL if k.startswith("ate")
               else RPE_R_TOL if "rot" in k else RPE_T_TOL)
        assert abs(got[k] - v) <= tol, (k, got[k], v)


def test_jax_checkpoint_resumes_in_the_port(pinned_run):
    calib, frames = pinned_run["calib"], pinned_run["frames"]
    odo = StereoOdometry.resume(pinned_run["ckpt"], calib, _port(PIN_CFG),
                                _port_o(PIN_OCFG), device="cpu")
    assert odo._frames == SPLIT and len(odo.kfs) >= 2
    for L, R in frames[SPLIT:]:
        odo.step(L, R)
    np.testing.assert_allclose(odo.trajectory()[:, :3, 3],
                               pinned_run["traj"][:, :3, 3], rtol=0,
                               atol=ATE_TOL)


def test_port_checkpoint_loads_and_resumes_in_jax(pinned_run, tmp_path):
    calib, frames = pinned_run["calib"], pinned_run["frames"]
    odo = StereoOdometry(calib, _port(PIN_CFG), _port_o(PIN_OCFG),
                         device="cpu")
    for L, R in frames[:SPLIT]:
        odo.step(L, R)
    ckpt = str(tmp_path / "port")            # save adds the .npz suffix
    odo.save(ckpt)
    assert sorted(os.listdir(tmp_path)) == ["port.npz"]   # tmp renamed
    graph, extra = JPoseGraph.load(ckpt + ".npz")
    np.testing.assert_array_equal(np.stack(graph.poses),
                                  np.stack(odo.graph.poses))
    assert [e[:2] for e in graph.edges] == [e[:2] for e in odo.graph.edges]
    assert int(extra["frames"]) == SPLIT
    np.testing.assert_array_equal(extra["kfs_desc"],
                                  np.stack([k.desc for k in odo.kfs]))
    resumed = JStereoOdometry.resume(ckpt + ".npz", calib, PIN_CFG,
                                     PIN_OCFG)
    for L, R in frames[SPLIT:]:
        resumed.step(L, R)
    np.testing.assert_allclose(resumed.trajectory()[:, :3, 3],
                               pinned_run["traj"][:, :3, 3], rtol=0,
                               atol=ATE_TOL)


def test_loop_closure_on_out_and_back():
    """The JAX out-and-back test's run and bars, on the port: a closure
    between distant keyframes, and an endpoint no worse than without
    closures."""
    out = [i * 0.08 for i in range(8)]
    calib, frames, gt = synthetic_sequence(
        shape=(96, 128), depth=8.0, fx=200.0, baseline=0.5, slant=0.35,
        seed=5, cam_xs=out + out[::-1][1:])
    cfg = _port(JConfig(num_disparities=24, speckle_window_size=0,
                        median_filter=False))
    odo = StereoOdometry(calib, cfg, OdometryConfig(
        keyframe_translation=0.05, lc_min_gap=6, lc_min_matches=25),
        device="cpu")
    for L, R in frames:
        odo.step(L, R)
    assert any(b - a >= 6 for a, b in odo.closures), odo.closures
    err_end = float(np.linalg.norm(odo.trajectory()[-1, :3, 3] - gt[-1, :3, 3]))
    open_traj = api.run_sequence(frames, calib, cfg, OdometryConfig(
        keyframe_translation=0.05, loop_closure=False), device="cpu")
    err_open = float(np.linalg.norm(open_traj[-1, :3, 3] - gt[-1, :3, 3]))
    assert err_end < max(0.05, err_open * 1.05), (err_end, err_open)


# --- refusals -------------------------------------------------------------

def test_strips_past_one_raise():
    """strips > 1 runs the strip-tiled matcher; what still raises is a mesh
    over several distinct devices (ROADMAP.md queue 1) and a mesh on
    another device than the odometry's."""
    calib = KittiCalib(200.0, 200.0, 64.0, 48.0, 0.5)
    cfg = _port(JPRESETS["kitti_odometry"])
    assert cfg.strips == 2
    with pytest.raises(NotImplementedError, match="several cards"):
        make_mesh(1, 2, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="mesh"):
        StereoOdometry(calib, cfg, device="cpu",
                       mesh=make_mesh(1, 2, devices=["meta"] * 2))
    for c in (cfg, cfg.replace(strips=1)):
        assert api.run_sequence([], calib, c,
                                device="cpu").shape == (0, 4, 4)


def test_odometry_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calib, frames, _ = _frames(n=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.run_sequence(frames, calib)
    with pytest.raises(RuntimeError, match="CUDA"):
        StereoOdometry(calib)
    assert api.run_sequence(frames, calib, device="cpu").shape == (1, 4, 4)


# --- metrics, calibration, config -----------------------------------------

def _trajectory(rng, n):
    T = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        xi = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 0.1, 3)])
        T[i] = np.asarray(jse3.exp_se3(jnp.asarray(xi.astype(np.float32))))
    T[:, :3, 3] = np.cumsum(T[:, :3, 3], axis=0) * 20.0
    return T


def test_metrics_match_jax():
    rng = np.random.default_rng(11)
    gt = _trajectory(rng, 60)
    est = gt.copy()
    est[:, :3, 3] += np.cumsum(rng.normal(0, 0.05, (60, 3)), axis=0)
    for fn, args in [("ate", (est, gt)), ("rpe", (est, gt)),
                     ("kitti_segment_errors", (est, gt)),
                     ("kitti_segment_errors", (est, gt, (50, 100)))]:
        assert getattr(metrics, fn)(*args) == getattr(jmetrics, fn)(*args)
    for delta in (1, 3):
        assert metrics.rpe(est, gt, delta) == jmetrics.rpe(est, gt, delta)
    R, t = metrics.align_rigid(est[:, :3, 3], gt[:, :3, 3])
    R_j, t_j = jmetrics.align_rigid(est[:, :3, 3], gt[:, :3, 3])
    np.testing.assert_array_equal(R, R_j)
    np.testing.assert_array_equal(t, t_j)
    pred = rng.uniform(-1, 40, (30, 40)).astype(np.float32)
    gtd = rng.uniform(0, 40, (30, 40)).astype(np.float32)
    gtd[::5] = 0
    mask = rng.random((30, 40)) < 0.7
    for fn in ("d1_all", "bad", "end_point_error"):
        for m in (None, mask):
            assert (getattr(metrics, fn)(pred, gtd, mask=m)
                    == getattr(jmetrics, fn)(pred, gtd, mask=m))


def test_kitti_calib_parses_as_jax(tmp_path):
    p = tmp_path / "calib.txt"
    rows = {"P0": [718.856, 0, 607.1928, 0, 0, 718.856, 185.2157, 0, 0, 0, 1,
                   0],
            "P1": [718.856, 0, 607.1928, -386.1448, 0, 718.856, 185.2157, 0,
                   0, 0, 1, 0],
            "P2": [1] * 12, "Tr": [0.5] * 12}
    p.write_text("".join(f"{k}: {' '.join(map(str, v))}\n"
                         for k, v in rows.items()) + "no colon here\n")
    got = parse_kitti_odometry_calib(str(p))
    ref = jdatasets.parse_kitti_odometry_calib(str(p))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.baseline == pytest.approx(0.5371657)
    disp = np.array([[-1.0, 0.0, 10.0, 50.0]], np.float32)
    np.testing.assert_array_equal(got.depth_from_disparity(disp),
                                  ref.depth_from_disparity(disp))


def test_odometry_config_from_jax():
    j = JOdometryConfig(max_corners=128, lc_min_gap=4, loop_closure=False)
    assert dataclasses.asdict(_port_o(j)) == dataclasses.asdict(j)
    assert _port_o(JOdometryConfig()) == OdometryConfig()
    with pytest.raises(ValueError, match="OdometryConfig lacks"):
        odometry_config_from_jax(dict(dataclasses.asdict(j), extra=1))
