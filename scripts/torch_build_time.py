"""Time nvcc on each CUDA kernel source of the port, with and without split compilation.

    python3 scripts/torch_build_time.py [--out FILE]

Builds csrc/twobody_inner.cu, csrc/freegas_sab.cu and csrc/cm_pointwise.cu
one at a time into a temporary directory, each twice, in turns: with the
port's nvcc flags (utils.build.NVCC_FLAGS, which split the optimizer's work
across every CPU: --split-compile=0) and with the same flags less that one.
Prints one JSON line (also written to --out, if given): per source and flag
set the wall seconds, the kernel instances ptxas compiled, their register
range and the spill bytes in all, and the host's CPU count. Needs nvcc, not
a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SPLIT = "--split-compile=0"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the JSON line to this file")
    a = ap.parse_args()
    from ndpp_tpu_torch.utils.build import NVCC_FLAGS, nvcc

    if SPLIT not in NVCC_FLAGS:
        raise SystemExit(f"torch_build_time: NVCC_FLAGS has no {SPLIT}")
    flag_sets = {"port": NVCC_FLAGS, "no_split": [f for f in NVCC_FLAGS if f != SPLIT]}
    csrc = ROOT / "ndpp_tpu_torch" / "csrc"
    res = {}
    with tempfile.TemporaryDirectory(prefix="ndpp_build_time_") as tmp:
        for src in ("twobody_inner.cu", "freegas_sab.cu", "cm_pointwise.cu"):
            for name, flags in flag_sets.items():
                t0 = time.perf_counter()
                proc = subprocess.run([nvcc(), *flags, "-o", str(Path(tmp) / f"{name}.so"), str(csrc / src)],
                                      capture_output=True, text=True, timeout=900)
                secs = time.perf_counter() - t0
                if proc.returncode:
                    raise SystemExit(f"nvcc failed on {src} ({name}):\n{proc.stderr[-4000:]}")
                report = proc.stdout + proc.stderr
                regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
                spills = sum(int(s) + int(ld) for s, ld in
                             re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report))
                res[f"{src}:{name}"] = {"seconds": secs, "instances": report.count("Compiling entry function"),
                                        "registers": [min(regs), max(regs)], "spill_bytes": spills}
                print(f"[build_time] {src} {name}: {json.dumps(res[f'{src}:{name}'])}", flush=True)
    rec = {"cpus": os.cpu_count(), "nvcc": nvcc(), "flags": flag_sets, "builds": res}
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
