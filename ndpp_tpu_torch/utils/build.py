"""Where the port builds its native libraries (the ACE tokenizer, the CUDA
kernel).

From a writable source checkout (the package's parent holds pyproject.toml)
it is build/ndpp_tpu_torch/ at the checkout root, which .gitignore covers.
An installed package (a wheel, site-packages) may not write beside itself,
so it builds into the per-user cache, $XDG_CACHE_HOME/ndpp_tpu_torch
(default ~/.cache/ndpp_tpu_torch), as torch.utils.cpp_extension does.
Libraries are keyed by their source's hash, so installs of different
versions share the directory safely.
"""

from __future__ import annotations

import os
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]  # the checkout root, or site-packages when installed


def build_dir() -> Path:
    """The directory native libraries are built into (not created here)."""
    if (_ROOT / "pyproject.toml").is_file() and os.access(_ROOT, os.W_OK):
        return _ROOT / "build" / "ndpp_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "ndpp_tpu_torch"
