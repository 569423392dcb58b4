"""The device trace of the traced window: torch.profiler's CUDA activity
(kernels, copies, memsets), put on the host's clock by a marker kernel, and
reduced to the union of busy intervals, the idle gaps and time by name.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted intervals covering the same points."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: list[tuple[float, float]], start: float, end: float) -> list[tuple[float, float]]:
    """The idle intervals of [start, end] between the merged busy ones."""
    out, t = [], start
    for a, b in busy:
        a, b = max(a, start), min(b, end)
        if b <= a:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if end > t:
        out.append((t, end))
    return out


def clipped_total(intervals, start: float, end: float) -> float:
    return sum(max(0.0, min(b, end) - max(a, start)) for a, b in intervals)


class DeviceTrace:
    """Starts the profiler and a marker; after stop(), `events` holds every
    device event as (t0, t1, name, cat) in seconds on time.perf_counter's clock."""

    def __init__(self, torch_mod, workdir: Path):
        self.torch = torch_mod
        self.workdir = workdir
        self.prof = torch_mod.profiler.profile(activities=[torch_mod.profiler.ProfilerActivity.CUDA])
        self.events: list[tuple[float, float, str, str]] = []
        self.marker_host = None

    def start(self) -> None:
        torch = self.torch
        self.prof.start()
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        torch.cuda._sleep(20000)
        torch.cuda.synchronize()
        self.marker_host = 0.5 * (h0 + time.perf_counter())

    def stop(self) -> None:
        self.prof.stop()
        path = self.workdir / "device_trace.json"
        self.prof.export_chrome_trace(str(path))
        raw = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        dev = [e for e in raw if e.get("cat") in DEVICE_CATS and "dur" in e]
        marker = [e for e in dev if MARKER in e.get("name", "")]
        if not marker:
            raise RuntimeError("device trace: no marker kernel, so no common clock with the host")
        m = marker[0]
        offset = self.marker_host - (float(m["ts"]) + 0.5 * float(m["dur"])) * 1e-6
        self.events = [
            (float(e["ts"]) * 1e-6 + offset, (float(e["ts"]) + float(e["dur"])) * 1e-6 + offset, e["name"], e["cat"])
            for e in dev
            if e is not m
        ]
