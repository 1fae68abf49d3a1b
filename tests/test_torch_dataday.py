"""The `EVAL.md` data-day recipes through the port's CLI, on the CPU:
real-format KITTI 2015 and Middlebury trees (PNG images, uint16 x 256
KITTI disparity, PFM ground truth) written from synthetic pairs with
analytic truth, then `eval ... --golden --record` run verbatim through
`tpustereo_torch.cli.main` and through the JAX package's `tpustereo.cli`
on the same tree, at `tests/test_dataday.py`'s sizes (96 x 160,
`--set num_disparities=32`).

Tolerance: none. Each record's pairs (names, shapes, the pipeline's and
the golden's metrics, the golden delta) and mean equal the JAX record's;
only the timestamps and the config's JAX-only keys differ.
"""

import json
import os

import numpy as np
import pytest

from tpustereo.cli.main import main as jax_main
from tpustereo_torch.cli.main import main
from tpustereo_torch.data import io, synthetic_pair

SMALL = ["--set", "num_disparities=32", "--set", "frames_per_step=1"]


def _pairs(n, shape=(96, 160), d0=10.0):
    """`tests/test_dataday.py`'s pairs: d0 + i, slope 0.04, seeds 40 on."""
    out = []
    for i in range(n):
        L, R, gt, valid = synthetic_pair(shape, disparity=d0 + i,
                                         slope=0.04, seed=40 + i)
        out.append((L, R, np.where(valid & (gt > 0), gt, -1.0)))
    return out


def _both(tmp_path, argv) -> tuple:
    """The port's and the JAX package's one-line records of `argv`."""
    recs = []
    for who, run, extra in (("port", main, ["--device", "cpu"]),
                            ("jax", jax_main, [])):
        rec = tmp_path / f"EVAL_{who}.jsonl"
        assert run(argv + SMALL + extra + ["--record", str(rec)]) == 0
        lines = rec.read_text().splitlines()
        assert len(lines) == 1
        recs.append(json.loads(lines[0]))
    ours, theirs = recs
    assert ours["pairs"] == theirs["pairs"]
    assert ours["mean"] == theirs["mean"]
    return ours, theirs


def test_kitti2015_recipe_as_jax(tmp_path, capsys):
    root = tmp_path / "kitti2015"
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(root / "training" / sub)
    for i, (L, R, gt) in enumerate(_pairs(2)):
        name = f"{i:06d}_10.png"
        io.write_image(str(root / "training" / "image_2" / name), L)
        io.write_image(str(root / "training" / "image_3" / name), R)
        io.write_kitti_disparity(str(root / "training" / "disp_occ_0" / name),
                                 gt)
    ours, _ = _both(tmp_path, ["eval", "--preset", "kitti_sgm8",
                               "--kitti2015", str(root), "--indices", "0-1",
                               "--golden"])
    assert [p["pair"] for p in ours["pairs"]] == \
        ["kitti2015_000000", "kitti2015_000001"]
    for p in ours["pairs"]:
        assert p["shape"] == [96, 160]
        assert p["tpu_vs_golden_max_abs"] == 0.0
        assert p["tpu"] == p["golden"]
        assert p["tpu"]["d1_all"] < 0.05
    assert set(ours["mean"]) == {"d1_all", "bad_2.0", "bad_1.0", "epe"}


@pytest.mark.parametrize("half_res", [False, True])
def test_middlebury_recipe_as_jax(tmp_path, capsys, half_res):
    scene = tmp_path / "Adirondack"
    os.makedirs(scene)
    (L, R, gt), = _pairs(1, d0=12.0)
    io.write_image(str(scene / "im0.png"), L)
    io.write_image(str(scene / "im1.png"), R)
    io.write_pfm(str(scene / "disp0GT.pfm"), np.where(gt > 0, gt, np.inf))
    ours, _ = _both(tmp_path, ["eval", "--preset", "middlebury_sgm4",
                               "--middlebury", str(scene), "--golden"]
                    + ["--half-res"] * half_res)
    p, = ours["pairs"]
    assert p["pair"] == str(scene)
    # half resolution halves the geometry and the disparities
    assert p["shape"] == ([48, 80] if half_res else [96, 160])
    assert p["tpu_vs_golden_max_abs"] == 0.0
    assert p["tpu"]["d1_all"] < (0.10 if half_res else 0.05)
