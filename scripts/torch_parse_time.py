"""ACE parse time with the native tokenizer and with numpy, on the three decks
of chip_smoke.py.

    python scripts/torch_parse_time.py [--reps 5] [--out FILE]

Writes the ACE files of chip_smoke.py's two-body, continuum/chi and thermal
decks (the same fixtures, through its write_fixtures) into a temporary
directory, then reads every file with the port's readers (read_ace,
read_thermal_ace: file read, tokenize, decode) in turns: once through the
native tokenizer, once with NDPP_TPU_NO_NATIVE=1 (numpy's split). Each
file's time is the median of --reps turns; a deck's time is the sum over its
files, which is what the driver's two parse threads do for that deck, one
file after another. The tokenizer's first use (g++ build unless a library of
the same source is already under build/, then load) is timed apart. All
times are host seconds on the machine it runs on. Prints one JSON line;
--out keeps a copy.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ndpp_tpu_torch import native  # noqa: E402
from ndpp_tpu_torch.host.ace import synth  # noqa: E402
from ndpp_tpu_torch.host.ace.parse import read_ace  # noqa: E402
from ndpp_tpu_torch.host.ace.thermal import read_thermal_ace  # noqa: E402

DECKS = {
    "twobody": (chip_smoke.TWOBODY_FIXTURES, chip_smoke.STRESS, ()),
    "continuum": (chip_smoke.CONTINUUM_FIXTURES, (), ()),
    "thermal": (chip_smoke.THERMAL_FIXTURES, (), chip_smoke.THERMAL_TABLES),
}


def _timed(fn, path, numpy_path: bool) -> float:
    if numpy_path:
        os.environ["NDPP_TPU_NO_NATIVE"] = "1"
    else:
        os.environ.pop("NDPP_TPU_NO_NATIVE", None)
    t0 = time.perf_counter()
    fn(path)
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    os.environ.pop("NDPP_TPU_NO_NATIVE", None)
    t0 = time.perf_counter()
    native.library()
    report: dict = {"native_first_use_seconds": time.perf_counter() - t0, "reps": args.reps, "decks": {}}
    with tempfile.TemporaryDirectory(prefix="ndpp_parse_") as tmp:
        for deck, (keys, stress, tables) in DECKS.items():
            lib = Path(tmp) / deck
            chip_smoke.write_fixtures(lib, keys, stress, tables)
            thermal_names = {synth.build_thermal(k).name for k in tables}
            files = sorted(lib.glob("*.ace"))
            native_s = numpy_s = 0.0
            for p in files:
                fn = read_thermal_ace if p.stem in thermal_names else read_ace
                fn(p)  # page the file in
                nat, nump = [], []
                for _ in range(args.reps):
                    nat.append(_timed(fn, p, numpy_path=False))
                    nump.append(_timed(fn, p, numpy_path=True))
                native_s += statistics.median(nat)
                numpy_s += statistics.median(nump)
            report["decks"][deck] = {
                "files": len(files),
                "bytes": sum(p.stat().st_size for p in files),
                "native_seconds": native_s,
                "numpy_seconds": numpy_s,
            }
    os.environ.pop("NDPP_TPU_NO_NATIVE", None)
    line = json.dumps(report)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
