"""The import rule: nothing under benchmark/ imports JAX or the JAX
package, compared by whole top-level name (the port's name begins with the
JAX package's), and the reference imports nothing of the port either."""

import ast
import os
import sys

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpustereo"}


def _modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield "benchmark" if node.level else node.module.split(".")[0]


def _files(sub=""):
    for d, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_no_jax_anywhere():
    for path in _files():
        bad = set(_modules(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        names = set(_modules(path))
        assert names <= {"__future__", "torch"}, f"{path} imports {names}"


def test_only_the_harness_and_tests_import_the_port():
    for path in _files():
        rel = os.path.relpath(path, BENCH)
        if "tpustereo_torch" in set(_modules(path)):
            assert rel in ("harness.py", "control.py") or \
                rel.startswith("tests"), rel


def test_forbidden_modules_by_whole_name(monkeypatch):
    for m in list(sys.modules):
        if m.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "tpustereo_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpustereo.config", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "tpustereo.config"]
