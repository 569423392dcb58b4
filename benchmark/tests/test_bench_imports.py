"""What the benchmark may import, and what it does without a card.

Nothing it runs imports a module whose top-level name (before the first
dot, compared whole: `ndpp_tpu_torch` is not `ndpp_tpu`) is jax, jaxlib,
flax or ndpp_tpu; its reference imports nothing of the port either."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "ndpp_tpu"}


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def _run_files() -> list[Path]:
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


@pytest.mark.parametrize("path", _run_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_the_jax_package(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "ndpp_tpu_torch" not in _imports(path)


def test_run_loads_no_jax_module():
    code = ("import runpy, sys; sys.argv = ['run.py']; import benchmark.run as r; "
            "import benchmark.reference.check, benchmark.harness.trace; "
            "import ndpp_tpu_torch.driver; print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_to_run_without_a_card():
    """No CUDA device here: exit 2, nothing on stdout, no CPU fallback."""
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "xmas172-structural", "--seed",
                          str(2**31 + 7), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_fails_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "xmas172-structural", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
