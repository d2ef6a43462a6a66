"""Nothing of the benchmark imports JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), the
reference side imports nothing of the program, and a run refuses to print
a result without a card or with JAX loaded."""
from __future__ import annotations

import ast
import sys
import types

import pytest

from bench_tiny import REPO, run_cpu, tiny_tree

FORBIDDEN = {"jax", "jaxlib", "flax", "curve_gaussian_tpu"}
PORT = "curve_gaussian_tpu_torch"
SOURCES = sorted((REPO / "benchmark").rglob("*.py"))


def imported_tops(path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    assert not imported_tops(path) & FORBIDDEN


def test_only_the_adapter_imports_the_program():
    users = {p.name for p in SOURCES if PORT in imported_tops(p)}
    assert users <= {"program.py", "calibrate.py", "test_bench_reference.py",
                     "test_bench_faults.py"}
    assert "program.py" in users


def test_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "curve_gaussian_tpu_torch_extra", types.ModuleType("x"))
    assert "curve_gaussian_tpu_torch_extra" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax.numpy"]


def test_jax_loaded_prints_no_result(tmp_path, monkeypatch):
    root = tiny_tree(tmp_path)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res, err = run_cpu(root, "tiny.dense", seconds=0.1)
    assert rc == 3 and res is None and "jax" in err


def test_no_card_exits_nonzero(capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    from benchmark import run

    rc = run.main(["--workload", "abc_nef.sparse", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
