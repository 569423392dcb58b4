"""Native (C++) host components, built at first use and loaded with ctypes
(counterpart of ndpp_tpu/native).

  ace_tokenizer  whitespace-float tokenization of ACE ASCII tables (the
                 host-parse hot path at library scale)
  ascii_format   the ASCII library's value lines, byte for byte the text of
                 the writer's Python loop (io/library.AsciiLibraryWriter;
                 the writer thread's hot path, run without the interpreter
                 lock)

Each shared library is compiled with g++ from the package's source into
utils.build.build_dir() (build/ndpp_tpu_torch/ at the root of a source
checkout, the per-user cache for an installed package), keyed by the
source's hash; no binary is kept in the repository. As in the reference, g++
is optional: when it is missing or the build fails, the parse takes numpy's
path and the writer formats in Python, and the first such use logs why
(once per process and library). build() itself raises NdppError with the
compiler's output. NDPP_TPU_NO_NATIVE=1 selects those paths outright, and a
token the native parser refuses is re-parsed by numpy for its error message.
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
_FORMAT_SRC = _SRC.with_name("ascii_format.cpp")
_BUILD_DIR = build_dir()
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# Per source stem: what the library is, the path taken without it, and the
# ctypes signatures of its C functions.
_BINDINGS = {
    "ace_tokenizer": ("native tokenizer", "ACE parsing takes numpy's path", {
        "ndpp_tokenize": (ctypes.c_longlong, [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_double),
                                              ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]),
        "ndpp_count_tokens": (ctypes.c_longlong, [ctypes.c_char_p, ctypes.c_size_t]),
    }),
    "ascii_format": ("native formatter", "the ASCII writer formats each value in Python", {
        "ndpp_format_values": (ctypes.c_size_t, [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]),
    }),
}
# The driver parses ACE files on two prefetch threads: the first use of a
# library builds and loads it under this lock, once per process. None
# records a build or load that failed: the fallback path, without a retry.
_LOCK = threading.Lock()
_LIB: dict[Path, ctypes.CDLL | None] = {}
_FORMATTER_OFF_LOGGED = False


def build(src: Path | None = None) -> Path:
    """Compile the native source `src` (the tokenizer's by default) unless a
    library built from the same source bytes and flags exists; returns its
    path."""
    src = _SRC if src is None else src
    digest = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    path = _BUILD_DIR / f"{src.stem}-{digest}.so"
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise NdppError(f"native {src.name}: g++ not found on PATH")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NdppError(f"native {src.name}: g++ failed ({proc.returncode}):\n{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, path)  # atomic: another process building at once never sees a partial file
    return path


def library(src: Path | None = None) -> ctypes.CDLL | None:
    """The loaded library of `src` (the tokenizer's by default), built on
    first use (thread-safe); None when it cannot be built or loaded (logged
    once)."""
    src = _SRC if src is None else src
    with _LOCK:
        if src not in _LIB:
            what, fallback, signatures = _BINDINGS[src.stem]
            try:
                lib = ctypes.CDLL(str(build(src)))
            except (NdppError, OSError, subprocess.SubprocessError) as e:
                log_mod.get().warning("%s unavailable, %s: %s", what, fallback, e)
                lib = None
            else:
                for name, (restype, argtypes) in signatures.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
            _LIB[src] = lib
        return _LIB[src]


def formatter() -> ctypes.CDLL | None:
    """The ASCII writer's value formatter (ascii_format.cpp,
    `ndpp_format_values`), built on first use; None under
    NDPP_TPU_NO_NATIVE=1 or when it cannot be built, the reason logged once
    per process."""
    global _FORMATTER_OFF_LOGGED
    if not os.environ.get("NDPP_TPU_NO_NATIVE"):
        return library(_FORMAT_SRC)
    with _LOCK:
        if not _FORMATTER_OFF_LOGGED:
            _FORMATTER_OFF_LOGGED = True
            log_mod.get().warning("native formatter off (NDPP_TPU_NO_NATIVE=1), %s", _BINDINGS["ascii_format"][1])
    return None


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
