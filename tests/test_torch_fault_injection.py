"""Process-kill fault injection on the port, as `tests/test_fault_injection.py`
does it on the JAX package: a real `python -m tpustereo_torch.cli
odometry --device cpu` process, checkpointing every frame, is SIGKILLed
as soon as its first checkpoint exists, resumed from it with `--resume`,
and the trajectory must equal an uninterrupted run within 1e-5 (the
JAX test's tolerance; the trajectory file holds 7 digits).

60 frames, as the JAX test: a short sequence could finish before the
kill lands."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_N_FRAMES = 60
_FLAGS = ["--device", "cpu", "--max-frames", str(_N_FRAMES),
          "--set", "num_disparities=16", "--set", "speckle_window_size=0",
          "--set", "median_filter=false", "--set", "uniqueness_ratio=0"]
_CLI = [sys.executable, "-m", "tpustereo_torch.cli", "odometry"]


def _run_cli(extra, timeout=500):
    p = subprocess.run(_CLI + extra, capture_output=True, text=True,
                       cwd=_REPO, timeout=timeout)
    assert p.returncode == 0, (p.returncode, p.stdout, p.stderr[-3000:])
    return p


@pytest.mark.slow
def test_process_kill_resume_matches_uninterrupted(tmp_path):
    traj_full = str(tmp_path / "full.txt")
    traj_res = str(tmp_path / "resumed.txt")
    ckpt = str(tmp_path / "ckpt.npz")

    _run_cli(["--out", traj_full] + _FLAGS)

    # checkpoints are written atomically (a temporary file, then
    # os.replace), so the file is whole the instant it exists
    p = subprocess.Popen(
        _CLI + ["--checkpoint", ckpt, "--checkpoint-every", "1"] + _FLAGS,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=_REPO)
    deadline = time.time() + 400
    killed = False
    while time.time() < deadline:
        if os.path.exists(ckpt) and os.path.getsize(ckpt) > 0:
            os.kill(p.pid, signal.SIGKILL)
            killed = True
            break
        if p.poll() is not None:
            break
        time.sleep(0.005)
    _, err = p.communicate(timeout=60)
    assert killed, f"never saw a checkpoint; rc={p.returncode}\n{err[-3000:]}"
    assert p.returncode == -signal.SIGKILL

    r = _run_cli(["--checkpoint", ckpt, "--resume", "--out", traj_res]
                 + _FLAGS)
    assert "resumed at frame" in r.stderr, r.stderr[-2000:]
    start = int(r.stderr.split("resumed at frame")[1].split()[0])
    assert 0 < start < _N_FRAMES

    a = np.loadtxt(traj_full)
    b = np.loadtxt(traj_res)
    assert a.shape == b.shape == (_N_FRAMES, 12)
    np.testing.assert_allclose(a, b, atol=1e-5)
