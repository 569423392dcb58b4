"""Run one of chip_smoke.py's decks on the card with an empty kernel build directory.

    python3 scripts/torch_cold_deck.py {twobody,continuum,thermal} [--root DIR] [--out FILE]

What a first ``ndpp run`` pays on a new install: every CUDA library the deck
dispatches (and the ACE tokenizer) is built inside the run, at its first
call, into a fresh temporary build directory. Writes the deck's synthetic
fixture library (as scripts/torch_profile_deck.py does), runs it through
``driver.run(cfg, device="cuda")`` and prints one JSON line (also written to
--out, if given): the run's wall seconds, each kernel library built during
it with its nvcc seconds, the seconds spent in nvcc in all, the run's phase
seconds, and the card's name and power limit.

--root DIR runs the ndpp_tpu_torch package of another checkout (for example
an earlier commit unpacked with ``git archive <commit> | tar -x -C DIR``), so
that two trees can be compared in one call, in turns. It needs a CUDA card
and nvcc, and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("deck", choices=("twobody", "continuum", "thermal"))
    ap.add_argument("--root", type=Path, help="checkout whose ndpp_tpu_torch package runs (default: this one)")
    ap.add_argument("--out", type=Path, help="also write the JSON line to this file")
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT / "scripts"))
    sys.path.insert(0, str(ROOT))
    if a.root is not None:
        sys.path.insert(0, str(a.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_cold_deck: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    import ndpp_tpu_torch
    import ndpp_tpu_torch.native
    import ndpp_tpu_torch.ops.continuum
    import ndpp_tpu_torch.ops.freegas
    import ndpp_tpu_torch.ops.twobody_inner  # noqa: F401  (the modules that build, loaded to be redirected)
    from ndpp_tpu_torch import driver
    from ndpp_tpu_torch.utils import build

    from torch_profile_deck import make_deck

    builds = []
    real_build_cuda, real_build_dir = build.build_cuda, build.build_dir

    def timed_build_cuda(src, *args, **kw):
        path, secs = real_build_cuda(src, *args, **kw)
        builds.append({"library": path.name, "seconds": secs})
        return path, secs

    with tempfile.TemporaryDirectory(prefix="ndpp_cold_deck_") as work:
        work = Path(work)
        fresh = work / "build"
        # every module that builds does so into `fresh`, and its nvcc builds are timed
        for mod in [m for name, m in sys.modules.items() if name.startswith("ndpp_tpu_torch") and m is not None]:
            if getattr(mod, "build_cuda", None) is real_build_cuda:
                mod.build_cuda = timed_build_cuda
            if getattr(mod, "build_dir", None) is real_build_dir:
                mod.build_dir = lambda: fresh
            if isinstance(getattr(mod, "_BUILD_DIR", None), Path):
                mod._BUILD_DIR = fresh
        cfg = make_deck(a.deck, work)
        t0 = time.perf_counter()
        metrics = driver.run(cfg, device="cuda")
        wall = time.perf_counter() - t0
    rec = {
        "deck": a.deck, "card": smi, "package": str(Path(ndpp_tpu_torch.__file__).parent),
        "wall_s": wall, "builds": builds, "nvcc_s": sum(b["seconds"] for b in builds),
        "nuclides_done": metrics.nuclides_done, "phase_seconds": metrics.phase_seconds,
    }
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
