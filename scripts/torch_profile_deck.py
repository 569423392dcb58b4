"""Profile chip_smoke.py's deck on the card and break down the device's time.

    python3 scripts/torch_profile_deck.py [--out FILE]

Writes the synthetic fixture library (h1, fe56, o16 and six stress
nuclides), runs the P5 / uniform-lethargy-361 deck through
``driver.run(cfg, device="cuda")`` with ``device.profile`` on (torch.profiler
over CPU and CUDA activity), and reads the chrome trace the driver exports:
device time by kernel or copy name, summed over the run, the device-busy
total, the host wall up to the profiler's stop, and the share of the
device-to-host result copies. It prints one JSON line (also written to
--out, if given) with those numbers and the card's name and power limit.
It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (fixtures and deck)

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the JSON line to this file")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_deck: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from ndpp_tpu_torch import driver
    from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments

    with tempfile.TemporaryDirectory(prefix="ndpp_profile_deck_") as work:
        work = Path(work)
        names = chip_smoke.write_fixtures(work / "lib")
        cfg = chip_smoke.deck(work / "lib", names, work / "cuda.txt")
        cfg.device.profile = True
        twobody_group_moments.launches = 0
        t0 = time.perf_counter()
        metrics = driver.run(cfg, device="cuda")
        wall = time.perf_counter() - t0
        events = json.loads((work / "torch_trace.json").read_text())["traceEvents"]
    by_name: dict[str, float] = defaultdict(float)
    count: dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            by_name[e["name"][:90]] += e.get("dur", 0) * 1e-3  # us -> ms
            count[e["name"][:90]] += 1
    busy_ms = sum(by_name.values())
    d2h_ms = sum(v for k, v in by_name.items() if "DtoH" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    rec = {
        "card": smi,
        "wall_s": wall,
        "nuclides_done": metrics.nuclides_done,
        "quarantined": metrics.nuclides_quarantined,
        "kernel_launches": twobody_group_moments.launches,
        "device_busy_ms": busy_ms,
        "d2h_ms": d2h_ms,
        "d2h_share_of_busy": d2h_ms / busy_ms if busy_ms else None,
        "top_ms": [{"name": k, "ms": v, "count": count[k]} for k, v in top],
    }
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
