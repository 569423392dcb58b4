#!/usr/bin/env python
"""Host time of a free-gas dispatch alone and beside the ASCII writer's loop.

    python3 scripts/torch_dispatch_gil.py [--device cuda|cpu] [--rows 111] [--reps 5] [--out FILE]

The driver writes the library on a thread of its own while the main thread
enqueues the next nuclide's device work. The ASCII writer formats every
value in Python (io/library.AsciiLibraryWriter._write_array), so it holds
the interpreter lock most of the time it runs, and each of the main
thread's torch calls must win the lock back. This script times one
`freegas_moments_sab` call at the thermal deck's shape (--rows rows from
1e-5 to 10 eV, A = 0.999167, kT = 0.0253 eV, P5, the 257-group window of
uniform-lethargy-361 with the catch group), host wall up to a synchronise,
in turns: alone, then while a second thread runs the writer's formatting
loop into an in-memory buffer, then alone again. It prints one JSON line
(also to --out) with the medians, their ratio, the torch calls one call
makes on the run's device (the profiler's aten ops; on the card the free-gas
density is one launch of the hand-written kernel, which is no aten op, so
its launches per call are counted beside them), the same count for the
plain path on the CPU, and the device's name and power limit.
"""

from __future__ import annotations

import argparse
import io
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=111)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    from ndpp_tpu_torch import groups
    from ndpp_tpu_torch.ops.continuum import CHUNK_BUDGET_BYTES
    from ndpp_tpu_torch.ops.freegas import chunk_for, freegas_moments_sab, sab_density

    dev = torch.device(args.device)
    gpu = "cpu"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_dispatch_gil: no CUDA device (use --device cpu)")
        gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    bounds = groups.get("uniform-lethargy-361").bounds
    window = torch.as_tensor(np.concatenate([[0.0], bounds[:257]]), device=dev)
    e = torch.as_tensor(np.geomspace(1e-5, 10.0, args.rows), device=dev)
    chunk = chunk_for(256, CHUNK_BUDGET_BYTES)

    def one_call() -> float:
        t0 = time.perf_counter()
        freegas_moments_sab(e, 0.999167, 0.0253, window, 5, chunk=chunk)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    values = np.random.default_rng(0).standard_normal(4000)
    stop = threading.Event()

    def writer_loop():
        buf = io.StringIO()
        while not stop.is_set():
            for i in range(0, values.size, 4):  # the writer's own line loop
                buf.write("".join(f"{v:26.17E}" for v in values[i : i + 4]) + "\n")
            buf.seek(0)
            buf.truncate()

    one_call()  # first use
    alone = [one_call() for _ in range(args.reps)]
    th = threading.Thread(target=writer_loop, daemon=True)
    th.start()
    beside = [one_call() for _ in range(args.reps)]
    stop.set()
    th.join(timeout=60)
    alone += [one_call() for _ in range(args.reps)]

    def aten_ops(e_, window_) -> int:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            freegas_moments_sab(e_, 0.999167, 0.0253, window_, 5, chunk=chunk)
        return sum(x.count for x in prof.key_averages() if x.key.startswith("aten::"))

    before = sab_density.launches
    ops_here = aten_ops(e, window)
    kernel_launches = sab_density.launches - before
    ops_cpu = aten_ops(e.cpu(), window.cpu())

    row = {
        "device": str(dev), "gpu": gpu, "rows": args.rows, "reps": args.reps,
        "alone_s": statistics.median(alone), "beside_writer_s": statistics.median(beside),
        "ratio": statistics.median(beside) / statistics.median(alone),
        "aten_ops_per_call": ops_here, "kernel_launches_per_call": kernel_launches,
        "aten_ops_per_call_cpu_plain": ops_cpu, "switch_interval_s": sys.getswitchinterval(),
        "alone_all_s": alone, "beside_writer_all_s": beside,
    }
    line = json.dumps(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
