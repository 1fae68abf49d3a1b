"""Command-line tools, each on `--device cuda` (default) or `cpu`:

    python -m tpustereo_torch.cli match     — one pair -> disparity map
    python -m tpustereo_torch.cli bench     — throughput + per-stage profile
    python -m tpustereo_torch.cli eval      — D1-all / bad-2.0 vs ground truth
    python -m tpustereo_torch.cli odometry  — stereo odometry over a sequence
"""

from tpustereo_torch.cli.main import main  # noqa: F401
