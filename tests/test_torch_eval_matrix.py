"""The port's evaluation matrix (`tpustereo_torch.eval.matrix`) against the
JAX package's `scripts/gen_eval_md.py` and its stored records
`scripts/eval_head.json`, on the CPU.

Tolerance: none. Each row's mean D1-all, bad-2.0, bad-1.0 and EPE equal
the record's (both rounded as the runner rounds them), and the largest
|pipeline - golden| is 0.0, as the record holds.
"""

import dataclasses
import importlib.util
import json
import os

import pytest

from tpustereo_torch.convert import config_from_jax
from tpustereo_torch.eval import matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "gen_eval_md.py")
RECORD = os.path.join(ROOT, "scripts", "eval_head.json")


def _jax_script():
    """`scripts/gen_eval_md.py` as a module, its `main` not run."""
    spec = importlib.util.spec_from_file_location("gen_eval_md", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record() -> dict:
    with open(RECORD) as f:
        return json.load(f)


def test_rows_equal_the_jax_script():
    theirs = _jax_script().ROWS
    assert len(matrix.ROWS) == len(theirs) == 13
    for (name, cfg, shape), (jname, jcfg, jshape) in zip(matrix.ROWS,
                                                         theirs):
        assert name == jname
        assert config_from_jax(dataclasses.asdict(jcfg)) == cfg, name
        assert shape == jshape, name
    assert [n for n, _, _ in matrix.ROWS] == list(_record())


@pytest.mark.parametrize("name", [n for n, _, _ in matrix.ROWS])
def test_row_equals_the_stored_record(name):
    want = _record()[name]
    got = matrix.run_matrix(device="cpu", rows=[name])
    assert list(got) == [name]
    assert got[name]["pairs"] == want["pairs"] == 3
    assert got[name]["mean"] == want["mean"]
    assert got[name]["golden_max_abs"] == want["golden_max_abs"] == 0.0


def test_main_prints_the_table_and_writes_only_out(tmp_path, capsys,
                                                  monkeypatch):
    name = "tsukuba_sad + LR + min_disp=8"
    monkeypatch.setattr(matrix, "ROWS",
                        [r for r in matrix.ROWS if r[0] == name])
    out = tmp_path / "m.json"
    assert matrix.main(["--device", "cpu", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert text.splitlines()[-1] == matrix.table(
        {name: _record()[name]}).splitlines()[-1]
    rec = json.loads(out.read_text())
    assert rec[name]["mean"] == _record()[name]["mean"]
    assert sorted(os.listdir(tmp_path)) == ["m.json"]


def test_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        matrix.run_matrix()
    with pytest.raises(KeyError, match="no such rows"):
        matrix.run_matrix(device="cpu", rows=["kitti_sgm8 at D=1024"])
