#!/usr/bin/env python3
"""One run of one cell of the benchmark of ndpp_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration
(benchmark/configs/<config>.json) and a traffic file
(benchmark/workloads/<traffic>.json). The run makes the deck's ACE files
from the seed, then drives the port's `driver.run` (what `ndpp run` calls)
in this process as a closed loop: one library sweep (a pass) at a time,
back to back, ASCII output into an anonymous memory file that a reader
thread follows (benchmark/harness/stream.py). Set-up is everything from
the process's start to the window's opening: imports, the CUDA context,
the kernel libraries, the deck, and a warm-up pass over one nuclide of
each kind in the deck at the cell's shapes. The window then runs for
--seconds; at its close the run counts the scatter values that reached the
library, parks the program's threads, checks a sample of what the window
wrote against the plain reference (benchmark/reference/), prints one JSON
line and exits without waiting for the pass in flight.

--trace 1 records spans around the calls into the port's layers and the
card's activity (torch.profiler) and reports the per-layer metrics
instead of the end-to-end ones. Each metric is the reader
benchmark/metrics/<name>.py.

Exits 2 without a card (or with fewer than the cell asks for), 3 when the
port cannot be imported, 4 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "ndpp_tpu")

if __name__ == "__main__":
    # Kernel caches at fixed paths inside the checkout, set before torch
    # loads; one thread for the CPU math libraries, so their pools do not
    # spin against the pipeline's own threads (the writer is one CPU-bound
    # Python thread).
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[_var] = "1"
    sys.path.insert(0, str(ROOT))

from benchmark.gen import deck as deck_mod  # noqa: E402
from benchmark.harness import spans as spans_mod  # noqa: E402
from benchmark.harness import trace as trace_mod  # noqa: E402
from benchmark.harness.stream import MemLibrary  # noqa: E402
from benchmark.reference import check as check_mod  # noqa: E402

HAND_KERNELS = {"twobody_group": "twobody_group_kernel", "freegas_sab": "freegas_sab_kernel",
                "cm_inner": "cm_inner_kernel"}


def process_age_s() -> float:
    """Seconds since this process started (kernel clock ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(manifest, cell, configuration, traffic) of a cell by its name."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in manifest["workloads"] if w["name"] == name)
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH / "workloads" / f"{cell['traffic']}.json").read_text())
    return manifest, cell, config, traffic


def metric_module(name: str):
    """benchmark/metrics/<name>.py: read(run) -> value or None, and
    optionally on_call(span, args, result, run) for the traced run."""
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class RunData:
    """What a metric reader reads. Times are seconds from the window's opening."""

    def __init__(self, cell: str, device_name: str):
        self.cell = cell
        self.device_name = device_name
        self.window_s = self.setup_s = 0.0
        self.moments = 0
        self.spans: list = []
        self.device_events: list[tuple[float, float, str, str]] = []  # (t0, t1, name, cat)
        # per hand kernel, the calls that launched it: (t0, t1, flops, bytes), filled by readers' on_call
        self.kernel_calls: dict[str, list[tuple[float, float, float, float]]] = {}
        self.notes: list[str] = []

    def spans_named(self, *names: str) -> list:
        return [s for s in self.spans if s.name in names]

    def kernel_seconds(self, key: str, t0: float, t1: float) -> float:
        """Device time of a hand kernel's launches that started in [t0, t1]."""
        needle = HAND_KERNELS[key]
        return sum(b - a for a, b, n, c in self.device_events if c == "kernel" and needle in n and t0 <= a <= t1)


def run_config(config: dict, deck, path: str, chips: int):
    from ndpp_tpu_torch.config import RunConfig

    run = config["run"]
    cfg = RunConfig(
        nuclides=deck.order,
        library=str(deck.xsdir),
        groups=run["groups"],
        legendre_order=run["legendre_order"],
        temperatures=list(run["temperatures"]),
        thermal_cutoff_kt=run["thermal_cutoff_kt"],
        include_yield=run["include_yield"],
        clamp_outside=run["clamp_outside"],
        freegas_for=list(run["freegas_for"]),
    )
    cfg.output.path = path
    cfg.output.format = run["output_format"]
    cfg.device.e_tile = run["e_tile"]
    cfg.device.quad_points = run["quad_points"]
    cfg.device.max_devices = chips
    cfg.device.watchdog_minutes = 0
    cfg.validate()
    return cfg


def install_tracing(rec, data: RunData, hooks: list) -> None:
    """Spans around the calls into the port's layers (module attributes the
    program looks up at call time). After each call, every metric reader's
    on_call(span, args, result, data) sees it, outside the span's time: a
    reader that needs a call's inputs (a roofline's work) takes them there."""
    from ndpp_tpu_torch import continuum_driver, driver, freegas_driver, thermal_driver
    from ndpp_tpu_torch.io.library import AsciiLibraryWriter

    def on_return(span, args, result):
        if span.name == "write_nuclide":
            span.moments = int(args[1].scatter.size)
        for hook in hooks:
            hook(span, args, result, data)

    for owner, attr, name in (
        (driver, "_process_with_oom_retry", "compute"),
        (AsciiLibraryWriter, "write_nuclide", "write_nuclide"),
        (driver, "read_ace", "parse"),
        (thermal_driver, "read_thermal_ace", "parse"),
        (driver, "prepare_twobody", "host.prep"),
        (freegas_driver, "prepare_twobody", "host.prep"),
        (thermal_driver, "prepare_twobody", "host.prep"),
        (thermal_driver, "prepare_thermal", "host.prep"),
        (continuum_driver, "prepare_continuum", "host.prep"),
        (driver, "_tiled_twobody_multi", "family.twobody"),
        (driver, "batched_continuum_moments", "family.continuum"),
        (driver, "apply_freegas", "family.freegas"),
        (driver, "apply_sab", "family.sab"),
        (driver, "chi_collapse", "family.chi"),
    ):
        rec.wrap(owner, attr, name, on_return)


def host_label(data: RunData, t: float) -> str:
    """What the host was doing at time t: the open spans of the pipeline."""
    active = {s.name for s in data.spans if s.t0 <= t <= s.t1 and s.name in ("compute", "write_nuclide", "parse")}
    return "+".join(sorted(active)) if active else "between_passes"


def breakdown(data: RunData) -> dict:
    by_name: dict[str, float] = {}
    for a, b, n, c in data.device_events:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = trace_mod.union([(a, b) for a, b, _, _ in data.device_events])
    idle = sorted(trace_mod.gaps(busy, 0.0, data.window_s), key=lambda g: g[0] - g[1])[:10]
    return {
        "device_ops": [[n[:120], s] for n, s in ops],
        "idle_gaps": [[f"{host_label(data, 0.5 * (a + b))} from {a:.3f} s", b - a] for a, b in idle],
    }


def run_cell(manifest: dict, cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             device: str, workdir: Path, join: bool = False) -> dict:
    """One run of a cell on `device` ("cuda", or "cpu" in the CPU tests,
    which skip the look for a card). Returns the result line's object.
    join: release the parked program at the end and wait for its threads
    (the CPU tests; a run on the card exits without waiting)."""
    import torch

    from ndpp_tpu_torch import driver
    from ndpp_tpu_torch.io.library import AsciiLibraryWriter
    from ndpp_tpu_torch.utils import log as log_mod
    from ndpp_tpu_torch.utils.build import build_dir

    log_mod.setup(level=30)
    # The port builds its native libraries on first use, keyed by source;
    # what appears during set-up was built by this run.
    libs_before = set(build_dir().glob("*.so"))
    on_card = device.startswith("cuda")
    chips = int(cell["chips"])
    run = config["run"]
    deck = deck_mod.build(config, traffic, seed)
    deck_mod.write(deck, workdir / "deck")
    check = traffic["check"]
    lib = MemLibrary(check_mod.row_chooser(seed, run, deck, int(check["rows"])))
    cfg = run_config(config, deck, lib.path, chips)
    wu = traffic["warmup"]
    warm_deck = deck_mod.build(config, traffic, seed, wu["nuclides"], int(wu["n_base"]))
    deck_mod.write(warm_deck, workdir / "warmup")
    warm = run_config(config, warm_deck, lib.path, chips)

    gate = spans_mod.Gate()
    gate.install(driver, AsciiLibraryWriter, lib.rewind)
    rec = spans_mod.Recorder()
    device_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    data = RunData(cell["name"], device_name)
    kind = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: metric_module(m["name"]) for m in manifest[kind]
               if "workloads" not in m or cell["name"] in m["workloads"]}
    if trace:
        install_tracing(rec, data, [m.on_call for m in readers.values() if hasattr(m, "on_call")])

    lib.reset()
    driver.run(warm, device=device)
    lib.drain()
    lib.passes.clear()
    gate.started = gate.failed = 0

    dtrace = trace_mod.DeviceTrace(torch, workdir) if trace and on_card else None
    setup_s = process_age_s()
    built = sorted(p.name for p in set(build_dir().glob("*.so")) - libs_before)
    if dtrace is not None:
        dtrace.start()
    fault: list[BaseException] = []

    def passes():
        try:
            while not gate.closed.is_set():
                lib.reset()
                driver.run(cfg, device=device)
                lib.drain()
        except spans_mod.GateClosed:
            pass
        except Exception as e:  # noqa: BLE001 — reported by the main thread
            if not gate.closed.is_set():
                fault.append(e)

    t_open = time.perf_counter()
    rec.recording = True
    worker = threading.Thread(target=passes, name="bench-passes", daemon=True)
    worker.start()
    while not fault and time.perf_counter() < t_open + seconds:
        time.sleep(min(0.05, max(t_open + seconds - time.perf_counter(), 0.0)))
    moments = lib.snapshot()
    t_close = time.perf_counter()
    gate.closed.set()
    spans = rec.close(t_close)
    lib.stop()
    window_s = t_close - t_open
    if fault:
        raise RuntimeError(f"a pass failed in the window: {fault[0]!r}") from fault[0]
    peak = max(torch.cuda.max_memory_allocated(d) for d in range(chips)) if on_card else 0
    data.window_s, data.setup_s, data.moments = window_s, setup_s, moments
    if dtrace is not None:
        dtrace.stop()
        data.device_events = [(a - t_open, b - t_open, n, c) for a, b, n, c in dtrace.events
                              if a < t_close and b > t_open]
    for s in spans:
        s.t0 -= t_open
        s.t1 -= t_open
    data.spans = spans
    for calls in data.kernel_calls.values():
        calls[:] = [(a - t_open, b - t_open, *rest) for a, b, *rest in calls]

    units = {m["name"]: m["unit"] for m in manifest[kind]}
    metrics = {}
    for name, mod in readers.items():
        value = mod.read(data)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}

    t_check = time.perf_counter()
    numbers = check_mod.verify(run, deck, lib.passes, gate.failed, seed, int(check["nuclides"]),
                               device=device)
    check_s = time.perf_counter() - t_check
    limits = check_mod.limits(config)
    result = {
        "correct": not check_mod.failed(numbers, limits),
        "attempted": gate.started,
        "failed": gate.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": device_name, "count": chips,
                   "memory_peak_bytes": int(peak)},
    }
    if trace and dtrace is not None:
        busy = trace_mod.union([(a, b) for a, b, _, _ in data.device_events])
        result["device"]["busy_s"] = trace_mod.clipped_total(busy, 0.0, window_s)
        result["device"]["window_s"] = window_s
        result["breakdown"] = breakdown(data)
    # A run that built kernel libraries carries nvcc's time in its setup_s.
    result["setup_built"] = built
    for note in data.notes + [f for p in lib.passes for f in p.faults][:10]:
        print(note, file=sys.stderr)
    if trace:
        steps = sorted((s.t0, s.t1, s.name) for s in data.spans if s.name in ("compute", "write_nuclide"))
        print("timeline " + " ".join(f"{n}:{a:.2f}-{b:.2f}" for a, b, n in steps), file=sys.stderr)
    if numbers.get("worst"):
        print(numbers["worst"], file=sys.stderr)
    print(f"reader thread cpu_s {lib.thread_cpu_s} resident_peak_bytes {lib.peak_resident} "
        f"check_s {check_s} nuclides {numbers['nuclides_checked']}", file=sys.stderr)
    print(f"setup_s {setup_s} " + (f"includes building {', '.join(built)}" if built else
                                   "built nothing: every kernel library was already built"), file=sys.stderr)
    for k, lim in limits.items():
        rel = ">=" if k in check_mod.FLOORS else "<="
        print(f"check {k} {numbers[k]} {rel} {lim}", file=sys.stderr)
    result["check_s"] = check_s
    result["check"] = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    if join:
        gate.release()
        worker.join()
        rec.restore()
        gate.uninstall()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest, cell, config, traffic = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"error: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
        return 2
    try:
        import ndpp_tpu_torch.driver  # noqa: F401
    except ImportError as e:
        print(f"error: the port ndpp_tpu_torch cannot be imported: {e}", file=sys.stderr)
        return 3
    workdir = Path(tempfile.mkdtemp(prefix="ndpp-bench-"))
    try:
        result = run_cell(manifest, cell, config, traffic, args.seed, args.seconds, bool(args.trace), "cuda",
                          workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"error: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
