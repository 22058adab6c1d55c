"""The benchmark stands apart from the JAX package: no file of ``bench/``
imports ``jax``, ``jaxlib``, ``flax`` or ``repro`` (top-level names
compared whole, since ``repro_torch`` begins with ``repro``), the plain
reference imports nothing of the port either, nothing opens a path under
``benchmarks/``, and the harness imports with those packages blocked."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

from portbench_util import REPO

BENCH = REPO / "bench"
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.partition(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).partition(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_package(path):
    assert not _roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _roots(path) <= {"__future__", "dataclasses", "numpy", "torch"}
    relative = {node.module for node in ast.walk(ast.parse(path.read_text()))
                if isinstance(node, ast.ImportFrom) and node.level}
    assert relative <= {"tapes", "replay", None}


def test_the_scan_sees_whole_names():
    assert "repro_torch" not in FORBIDDEN and "repro_torch".partition(".")[0] != "repro"
    assert _roots(BENCH / "harness" / "cell.py") >= {"repro_torch"}


@pytest.mark.parametrize("path", [p for p in FILES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_nothing_reads_the_old_benchmarks(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "benchmarks" not in node.value, node.value
        if isinstance(node, ast.Name | ast.Attribute):
            assert getattr(node, "id", getattr(node, "attr", "")) != "benchmarks"


def test_the_harness_imports_with_jax_and_the_reference_package_blocked():
    code = f"""
import sys
sys.modules["jax"] = sys.modules["repro"] = sys.modules["jaxlib"] = sys.modules["flax"] = None
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
import bench.run
import bench.harness.cell, bench.reference.sweep
from bench.harness import registry
for name in [w["name"] for w in registry.benchmark()["workloads"]]:
    registry.cell(name)
import repro_torch.core.fleet
from bench.harness.cell import forbidden_modules
assert forbidden_modules() == [], forbidden_modules()
print("ok")
"""
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=300, cwd=str(REPO))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().endswith("ok")


def test_forbidden_modules_names_what_was_loaded(monkeypatch):
    from bench.harness.cell import forbidden_modules

    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    monkeypatch.setitem(sys.modules, "repro.core", type(sys)("repro.core"))
    assert {"jax", "repro"} <= set(forbidden_modules())


def test_run_refuses_without_a_card_and_prints_no_result():
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "ior-segrandom-2n.resweep", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300,
                       cwd=str(REPO), env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr
