"""The port runs from a wheel, and without g++.

A wheel built from the files git ships carries the port's CUDA and C++
sources (pyproject.toml's package data); installed into a directory of its
own, the package builds the ACE tokenizer into the per-user cache
($XDG_CACHE_HOME/ndpp_tpu_torch), never beside site-packages. With no g++ on
PATH neither the tokenizer nor the ASCII formatter can be built: ACE parsing
takes numpy's path, as the reference's does, the writer formats in Python,
and a deck runs to the end with nothing quarantined.
"""

import logging
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from ndpp_tpu_torch import driver as t_driver
from ndpp_tpu_torch import native
from ndpp_tpu_torch.config import RunConfig
from ndpp_tpu_torch.host.ace import synth
from ndpp_tpu_torch.host.ace.write import write_ace
from ndpp_tpu_torch.io.library import compare
from ndpp_tpu_torch.utils import log as log_mod

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCES = [
    "ndpp_tpu_torch/csrc/twobody_inner.cu",
    "ndpp_tpu_torch/csrc/freegas_sab.cu",
    "ndpp_tpu_torch/csrc/cm_pointwise.cu",
    "ndpp_tpu_torch/native/ace_tokenizer.cpp",
    "ndpp_tpu_torch/native/ascii_format.cpp",
]


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def log_messages():
    """The messages the port's logger emits during the test (its stream
    handler may hold a capture stream of an earlier test)."""
    logger = log_mod.get()
    rec = _Messages()
    logger.addHandler(rec)
    yield rec.messages
    logger.removeHandler(rec)


def _source_tree(dst: Path) -> Path:
    """The files a source distribution of the repo holds for the build: the
    packaging file and both packages, without caches or built libraries."""
    dst.mkdir()
    shutil.copy(ROOT / "pyproject.toml", dst)
    skip = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "*.tmp")
    for pkg in ("ndpp_tpu", "ndpp_tpu_torch"):
        shutil.copytree(ROOT / pkg, dst / pkg, ignore=skip)
    return dst


def test_wheel_ships_the_sources_and_builds_outside_site_packages(tmp_path):
    src = _source_tree(tmp_path / "src")
    env = {**os.environ, "PIP_NO_INDEX": "1", "PIP_DISABLE_PIP_VERSION_CHECK": "1"}
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation", "-w", str(tmp_path / "dist"), str(src)],
        check=True, capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path,
    )
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = zipfile.ZipFile(wheel).namelist()
    assert all(s in names for s in SOURCES), [n for n in names if n.startswith("ndpp_tpu_torch/")]

    site = tmp_path / "site"
    subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps", "--no-index", "--target", str(site), str(wheel)],
        check=True, capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path,
    )
    cache = tmp_path / "cache"
    code = (
        "import numpy as np\n"
        "from ndpp_tpu_torch import native\n"
        "from ndpp_tpu_torch.ops import twobody_inner\n"
        "assert native.library() is not None\n"
        "np.testing.assert_array_equal(native.tokenize_floats('1.5 -2e3 7'), [1.5, -2e3, 7.0])\n"
        "assert twobody_inner._SRC.is_file()\n"
        "print(native.__file__)\n"
        "print(native.build())\n"
        "print(twobody_inner._BUILD_DIR)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(site), "XDG_CACHE_HOME": str(cache)},
    )
    assert out.returncode == 0, out.stderr
    module, lib, kernel_dir = (Path(line) for line in out.stdout.split())
    assert module.is_relative_to(site)  # the installed copy ran, not this checkout
    assert lib.parent == kernel_dir == cache / "ndpp_tpu_torch" and lib.is_file()
    assert not (site / "build").exists() and not (tmp_path / "build").exists()


def test_deck_without_gxx_parses_with_numpy(tmp_path, monkeypatch, log_messages):
    lib = tmp_path / "lib"
    lib.mkdir()
    lines = []
    for key, n in (("h1", 30), ("fe56", 30)):
        nuc = synth.ALL_FIXTURES[key](n)
        p = write_ace(nuc, lib / f"{key}.ace")
        lines.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    (lib / "xsdir").write_text("directory\n" + "\n".join(lines) + "\n")

    def run(tag):
        cfg = RunConfig(library=str(lib / "xsdir"), groups="uniform-lethargy-47", legendre_order=1, freegas_for=["none"])
        cfg.output.path = str(tmp_path / f"{tag}.txt")
        cfg.output.format = "ascii"
        cfg.validate()
        m = t_driver.run(cfg, device="cpu")
        assert m.nuclides_done == 2 and m.nuclides_quarantined == 0
        return cfg.output.path

    with_native = run("native")
    empty = tmp_path / "bin"
    empty.mkdir()
    (empty / "python3").symlink_to(sys.executable)
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "nobuild")  # no library built before
    monkeypatch.setattr(native, "_LIB", {})
    assert shutil.which("g++") is None
    log_messages.clear()
    np.testing.assert_array_equal(native.tokenize_floats("1 2.5e-3"), [1.0, 2.5e-3])
    numpy_path = run("numpy")
    assert native._LIB == {native._SRC: None, native._FORMAT_SRC: None}  # tried once, not again on every parse
    assert sum(m.startswith("native tokenizer unavailable") for m in log_messages) == 1
    assert sum(m.startswith("native formatter unavailable") for m in log_messages) == 1
    assert not (tmp_path / "nobuild").exists()
    report = compare(numpy_path, with_native, rtol=0.0, atol=0.0)
    assert report["match"], report
