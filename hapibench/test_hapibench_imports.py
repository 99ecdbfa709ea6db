"""Nothing the benchmark runs imports JAX or the JAX package, and its plain
reference imports nothing of the program either. Module names are compared
by their top-level name, whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from hapibench import bench, run

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN
    if "reference" in path.relative_to(HERE).parts:
        assert "repro_torch" not in imported_tops(path)


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.kernels.ops", "torch"]) == []
    assert run.forbidden_modules(["repro.models", "jaxlib.xla", "repro_torch"]) == ["jaxlib",
                                                                                  "repro"]
    assert run.forbidden_modules(["flax", "jax"]) == ["flax", "jax"]


def test_a_run_without_a_card_prints_no_result(capsys):
    if run.torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert run.main(["--workload", "nemo12b-pushdown-2x4k", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "hapibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "hapibench/run.py", "--workload",
                           "nemo12b-pushdown-2x4k", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


def test_benchmark_json_is_json():
    json.loads((bench.ROOT / "BENCHMARK.json").read_text())
