"""Where the port builds its native libraries (the ACE tokenizer, the CUDA
kernels), and the one nvcc build every CUDA kernel goes through.

From a writable source checkout (the package's parent holds pyproject.toml)
it is build/ndpp_tpu_torch/ at the checkout root, which .gitignore covers.
An installed package (a wheel, site-packages) may not write beside itself,
so it builds into the per-user cache, $XDG_CACHE_HOME/ndpp_tpu_torch
(default ~/.cache/ndpp_tpu_torch), as torch.utils.cpp_extension does.
Libraries are keyed by their source's hash, so installs of different
versions share the directory safely.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]  # the checkout root, or site-packages when installed

# The flags every kernel of the port is built with: Hopper's sm_90a, a shared
# library with a plain C interface (bound with ctypes), the optimizer's passes
# over the many template instances split across every CPU (a library builds
# about twice as fast with the same registers: scripts/torch_build_time.py),
# ptxas's register report.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--split-compile=0", "-Xptxas", "-v",
]


def build_dir() -> Path:
    """The directory native libraries are built into (not created here)."""
    if (_ROOT / "pyproject.toml").is_file() and os.access(_ROOT, os.W_OK):
        return _ROOT / "build" / "ndpp_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "ndpp_tpu_torch"


def nvcc() -> str:
    """The nvcc to build with: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(src: Path, flags: list[str]) -> Path:
    """The library build_cuda makes from `src` with `flags`: <stem>-<hash>.so
    in build_dir(), the hash over the source's bytes and the flags."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return build_dir() / f"{src.stem}-{digest}.so"


def build_cuda(src: Path, flags: list[str] = NVCC_FLAGS) -> tuple[Path, float]:
    """Compile the CUDA source `src` into a shared library unless one built
    from the same source bytes and flags exists; returns (path, seconds spent
    building). ptxas's report (registers, spills per kernel) is kept beside
    the library as <library>.ptxas.txt. The library appears by an atomic
    rename, so concurrent builders never see a partial file."""
    path = library_path(src, flags)
    if path.exists():
        return path, 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(src)], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{proc.stderr[-4000:]}")
    ptxas_report(path).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def ptxas_report(path: Path) -> Path:
    """Where build_cuda keeps ptxas's report for the library at `path`."""
    return path.with_name(f"{path.name}.ptxas.txt")
