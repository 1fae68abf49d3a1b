"""The port's command line (`tpustereo_torch.cli`) against the JAX
package's (`tpustereo.cli`), on the CPU, in process (one subprocess test
runs `python -m tpustereo_torch.cli`).

Exact throughout: configurations equal field for field; the `.pfm` and
`.npy` files of `match` equal byte for byte (float32 disparity, which the
port's pipeline gives the JAX jnp pipeline's bit for bit on these pairs),
the KITTI `.png` equal as decoded uint16. The odometry resume is held to
the JAX resume test's 1e-5 (m, and the rotation entries).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_cli import _SET_VALUES
from tpustereo.cli.main import config_from_args as j_config_from_args
from tpustereo.cli.main import main as jax_main
from tpustereo.data import io as jio
from tpustereo_torch import Config, PRESETS, api
from tpustereo_torch.cli.main import config_from_args, main
from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.data import io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--preset", "kitti_sgm8", "--set", "num_disparities=32",
         "--set", "frames_per_step=1"]


def _args(sets, preset=None):
    return argparse.Namespace(preset=preset, config=None, set=sets)


def test_every_config_field_has_a_roundtrip_case():
    assert {f.name for f in dataclasses.fields(Config)} == set(_SET_VALUES)


@pytest.mark.parametrize("field", sorted(_SET_VALUES))
def test_set_roundtrips_as_in_jax(field):
    raw, expected = _SET_VALUES[field]
    cfg = config_from_args(_args([f"{field}={raw}"]))
    assert getattr(cfg, field) == expected
    assert type(getattr(cfg, field)) is type(expected)
    jcfg = j_config_from_args(_args([f"{field}={raw}"]))
    assert cfg == config_from_jax(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_with_sets_as_in_jax(preset):
    sets = ["frames_per_step=2", "census_window=7x5", "fill_mode=background"]
    cfg = config_from_args(_args(sets, preset=preset))
    assert cfg == config_from_jax(dataclasses.asdict(
        j_config_from_args(_args(sets, preset=preset))))
    assert cfg.paths == PRESETS[preset].paths


def test_config_file_and_unknown_key(tmp_path):
    toml = os.path.join(ROOT, "configs", "kitti_sgm8.toml")
    args = argparse.Namespace(preset=None, config=toml, set=["p2=100"])
    assert config_from_args(args) == config_from_jax(dataclasses.asdict(
        j_config_from_args(args)))
    with pytest.raises(SystemExit):
        config_from_args(_args(["not_a_field=1"]))


@pytest.mark.parametrize("ext", [".pfm", ".npy", ".png"])
def test_match_writes_what_the_jax_cli_writes(tmp_path, ext, capsys):
    ours, theirs = str(tmp_path / f"o{ext}"), str(tmp_path / f"t{ext}")
    assert main(["match", "--device", "cpu", "--synthetic", "48x64",
                 "--out", ours] + SMALL) == 0
    assert jax_main(["match", "--synthetic", "48x64", "--out",
                     theirs] + SMALL) == 0
    out = capsys.readouterr().out.splitlines()
    # the same summary lines, one set from each CLI
    assert out[:2] == out[3:5]
    if ext == ".png":
        np.testing.assert_array_equal(io.read_png(ours), io.read_png(theirs))
        np.testing.assert_array_equal(io.read_kitti_disparity(ours),
                                      jio.read_kitti_disparity(theirs))
    else:
        with open(ours, "rb") as f1, open(theirs, "rb") as f2:
            assert f1.read() == f2.read()


def test_match_reads_image_files(tmp_path):
    from tpustereo_torch.data import synthetic_pair
    L, R, _, _ = synthetic_pair((40, 56), disparity=6.0, seed=4)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.pgm")
    io.write_image(lp, L)
    io.write_image(rp, R)
    out = str(tmp_path / "d.pfm")
    main(["match", "--device", "cpu", "--left", lp, "--right", rp,
          "--out", out, "--set", "num_disparities=16"])
    np.testing.assert_array_equal(
        io.read_pfm(out), api.match_pair(L, R, Config(num_disparities=16),
                                         device="cpu"))


def test_entry_points_need_cuda_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["match", "--synthetic", "16x24"],
                 ["bench", "--shape", "16x24", "--batch", "1"],
                 ["bench", "--odometry", "--shape", "16x24"],
                 ["eval", "--synthetic-eval"],
                 ["odometry", "--max-frames", "2"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


def test_multihost_names_the_roadmap_item(capsys):
    """`bench --multihost N` runs (see the slow test below); its help says
    what it starts and measures, and names the ROADMAP item that keeps the
    scaling across several cards open. Fewer than 2 hosts are refused."""
    with pytest.raises(SystemExit):
        main(["bench", "--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "torch.distributed ranks" in text
    assert "fps(N) / (N fps(1))" in text
    assert "queue 1, item 7" in text
    with pytest.raises(ValueError, match="at least 2 hosts"):
        main(["bench", "--multihost", "1", "--device", "cpu"])


@pytest.mark.slow
def test_bench_multihost_cpu(tmp_path, capsys):
    """`bench --multihost 2 --device cpu`: two gloo clusters (1 host, then
    2) on this machine; the record's keys and arithmetic."""
    rec = str(tmp_path / "mh.jsonl")
    main(["bench", "--multihost", "2", "--device", "cpu", "--shape", "32x64",
          "--batch", "1", "--iters", "1", "--record", rec] + SMALL)
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(open(rec).read())
    assert printed["hosts"] == 2 and printed["transport"] == "gloo"
    assert printed["global_batch_nhost"] == 2 * printed["global_batch_1host"]
    eff = printed["fps_total_nhost"] / (2 * printed["fps_total_1host"])
    assert abs(eff - printed["value"]) <= 1e-3


def test_bench_prints_and_records(tmp_path, capsys):
    rec = str(tmp_path / "rec.jsonl")
    main(["bench", "--device", "cpu", "--shape", "24x40", "--batch", "2",
          "--iters", "1", "--record", rec] + SMALL)
    printed = json.loads(capsys.readouterr().out)
    recorded = json.loads(open(rec).read())
    assert printed["backend"] == recorded["backend"] == "cpu"
    assert printed["metric"] == "SGM 8-path fps/chip (24x40, D=32)"
    main(["bench", "--device", "cpu", "--shape", "24x40", "--batch", "1",
          "--iters", "1", "--report", "--preset", "tsukuba_sad"])
    assert capsys.readouterr().out.startswith("| tsukuba_sad | 24x40 |")


def test_eval_report_as_jax(tmp_path, capsys):
    sets = SMALL + ["--set", "speckle_window_size=20"]
    main(["eval", "--device", "cpu", "--synthetic-eval"] + sets)
    ours = json.loads(capsys.readouterr().out)
    jax_main(["eval", "--synthetic-eval"] + sets)
    theirs = json.loads(capsys.readouterr().out)
    assert ours["pairs"] == theirs["pairs"]
    assert ours["mean"] == theirs["mean"]


ODO = ["--device", "cpu", "--no-loop-closure", "--set", "num_disparities=32",
       "--set", "speckle_window_size=0", "--set", "median_filter=false"]


def test_odometry_checkpoint_resume_equals_uninterrupted(tmp_path, capsys):
    """A run stopped after 3 frames and resumed from its checkpoint gives
    the uninterrupted run's trajectory, on a KITTI tree (a synthetic
    sequence of another length is another scene: its texture spans the
    camera's whole path)."""
    from tests.test_torch_io import _odometry_tree, _pairs
    _odometry_tree(tmp_path, _pairs(6, shape=(48, 80), d0=6.0))
    root = ["--root", str(tmp_path)]
    straight, resumed = str(tmp_path / "s.txt"), str(tmp_path / "r.txt")
    ck = str(tmp_path / "ck.npz")
    main(["odometry", "--max-frames", "6", "--out", straight] + root + ODO)
    main(["odometry", "--max-frames", "3", "--checkpoint", ck] + root + ODO)
    main(["odometry", "--max-frames", "6", "--checkpoint", ck, "--resume",
          "--out", resumed] + root + ODO)
    assert "resumed at frame 3" in capsys.readouterr().err
    a, b = np.loadtxt(straight), np.loadtxt(resumed)
    assert a.shape == b.shape == (6, 12) and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_odometry_reports_ate_rpe(tmp_path, capsys):
    """On the synthetic sequence the report holds ATE and RPE; scored
    against its own trajectory file a run's ATE is ~0."""
    traj = str(tmp_path / "t.txt")
    main(["odometry", "--max-frames", "5", "--out", traj] + ODO)
    out = capsys.readouterr().out
    rep = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert {"ate", "rpe_1", "kitti_segments"} <= set(rep)
    assert rep["ate"]["rmse"] < 1.0
    main(["odometry", "--max-frames", "5", "--gt-poses", traj] + ODO)
    out = capsys.readouterr().out
    rep = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert rep["ate"]["rmse"] < 1e-5


def test_odometry_over_a_kitti_tree(tmp_path):
    from tests.test_torch_io import _odometry_tree, _pairs
    _odometry_tree(tmp_path, _pairs(3, shape=(48, 80), d0=6.0))
    out = str(tmp_path / "traj.txt")
    main(["odometry", "--root", str(tmp_path), "--max-frames", "3",
          "--prefetch", "2", "--out", out] + ODO)
    traj = np.loadtxt(out)
    assert traj.shape == (3, 12) and np.isfinite(traj).all()


def test_python_m_cli_runs(tmp_path):
    out = str(tmp_path / "d.npy")
    res = subprocess.run(
        [sys.executable, "-m", "tpustereo_torch.cli", "match", "--device",
         "cpu", "--synthetic", "32x48", "--set", "num_disparities=16",
         "--out", out], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert np.load(out).shape == (32, 48)
    assert "wrote" in res.stdout
