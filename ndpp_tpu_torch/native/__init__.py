"""Native (C++) host components, built at first use and loaded with ctypes
(counterpart of ndpp_tpu/native).

  ace_tokenizer  whitespace-float tokenization of ACE ASCII tables (the
                 host-parse hot path at library scale)

The shared library is compiled with g++ from the package's source into
utils.build.build_dir() (build/ndpp_tpu_torch/ at the root of a source
checkout, the per-user cache for an installed package), keyed by the
source's hash; no binary is kept in the repository. As in the reference, g++
is optional: when it is missing or the build fails, the parse takes numpy's
path, and the first such parse logs why (once per process). build() itself
raises NdppError with the compiler's output. NDPP_TPU_NO_NATIVE=1 selects
the numpy path outright, and a token the native parser refuses is re-parsed
by numpy for its error message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ndpp_tpu_torch.utils import log as log_mod
from ndpp_tpu_torch.utils.build import build_dir
from ndpp_tpu_torch.utils.errors import NdppError

_SRC = Path(__file__).resolve().parent / "ace_tokenizer.cpp"
_BUILD_DIR = build_dir()
_FLAGS = ["-O3", "-shared", "-fPIC"]
# The driver parses ACE files on two prefetch threads: the first use builds
# and loads the library under this lock, once per process. None in the list
# records a build or load that failed: the numpy path, without a retry.
_LOCK = threading.Lock()
_LIB: list[ctypes.CDLL | None] = []


def build() -> Path:
    """Compile ace_tokenizer.cpp unless a library built from the same source
    bytes and flags exists; returns its path."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    path = _BUILD_DIR / f"ace_tokenizer-{digest}.so"
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise NdppError("native tokenizer: g++ not found on PATH")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NdppError(f"native tokenizer: g++ failed ({proc.returncode}):\n{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, path)  # atomic: another process building at once never sees a partial file
    return path


def library() -> ctypes.CDLL | None:
    """The loaded tokenizer library, built on first use (thread-safe); None
    when it cannot be built or loaded (logged once)."""
    with _LOCK:
        if not _LIB:
            try:
                lib = ctypes.CDLL(str(build()))
            except (NdppError, OSError, subprocess.SubprocessError) as e:
                log_mod.get().warning("native tokenizer unavailable, ACE parsing takes numpy's path: %s", e)
                _LIB.append(None)
                return None
            lib.ndpp_tokenize.restype = ctypes.c_longlong
            lib.ndpp_tokenize.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.ndpp_count_tokens.restype = ctypes.c_longlong
            lib.ndpp_count_tokens.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            _LIB.append(lib)
        return _LIB[0]


def tokenize_floats(text: str | bytes) -> np.ndarray:
    """All whitespace-separated floats in `text` as float64."""
    data = text.encode() if isinstance(text, str) else text
    lib = None if os.environ.get("NDPP_TPU_NO_NATIVE") else library()
    if lib is not None:
        cap = int(lib.ndpp_count_tokens(data, len(data)))
        out = np.empty(cap, dtype=np.float64)
        consumed = ctypes.c_size_t(0)
        n = lib.ndpp_tokenize(
            data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap, ctypes.byref(consumed)
        )
        if n >= 0:
            return out[:n]
        # a token strtod refuses: the numpy path below raises its error message
    return np.array(data.split(), dtype=np.float64)
