"""Profile one of chip_smoke.py's decks on the card and break down the device's time.

    python3 scripts/torch_profile_deck.py {twobody,continuum} [--out FILE]
    python3 scripts/torch_profile_deck.py continuum --plan      (no card needed)

Writes the deck's synthetic fixture library (twobody: h1, fe56, o16 and two
stress nuclides; continuum: the twelve continuum and chi fixtures), runs the
P5 / uniform-lethargy-361 deck through ``driver.run(cfg, device="cuda")``
with ``device.profile`` on (torch.profiler over CPU and CUDA activity), and
reads the chrome trace the driver exports: device time by kernel or copy
name, summed over the run; the device-busy total (the union of the device
events' intervals) and its share of the span from the first device event to
the last; the largest idle gaps of the device inside that span, each with
the events on both sides; the host wall up to the profiler's stop; the share
of the device-to-host result copies; the run's phase seconds. It prints one
JSON line (also written to --out, if given) with those numbers and the
card's name and power limit. It needs a CUDA card and exits non-zero
without one.

--plan runs nothing on a device. It drives the same deck through the driver
on the CPU with every device op replaced by a recorder that returns zeros of
the right shape, and prints, per op, the calls, rows, and for
cm_moments_pointwise the quadrature nodes (rows x outer nodes x inner panels
x inner nodes) and the bytes of one (T, NW, SY, QY) float64 tensor per chunk:
the sizes a prediction of the device time is reckoned from.
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

import chip_smoke  # noqa: E402  (fixtures and decks)

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def make_deck(which: str, work: Path):
    if which == "twobody":
        names = chip_smoke.write_fixtures(work / "lib")
    else:
        names = chip_smoke.write_fixtures(work / "lib", chip_smoke.CONTINUUM_FIXTURES, ())
    return chip_smoke.deck(work / "lib", names, work / "cuda.txt")


def plan(which: str) -> dict:
    """The deck's dispatch plan, from a CPU run whose device ops only record."""
    import torch

    from ndpp_tpu_torch import chi_driver, continuum_driver, driver
    from ndpp_tpu_torch.ops import continuum as cont_ops

    calls: dict[str, dict] = defaultdict(lambda: defaultdict(int))

    def count(name, rows, **more):
        c = calls[name]
        c["calls"] += 1
        c["rows"] += rows
        for k, v in more.items():
            c[k] += v

    def twobody(e, knots, pdf, bounds, c1, c2, awr, order, nq, clamp):
        count("twobody_moments", e.shape[0], subintervals=e.shape[0] * (knots.shape[1] + bounds.shape[-1] + 10 - 1))
        return e.new_zeros((e.shape[0], order + 1, bounds.shape[-1] - 1))

    def cm(e, e_knots, pdf_e, r_rows, a_rows, mu_knots, mu_pdf, emax, expo, bounds, awr, order, nq_w, nq_y,
           angular, energy, clamp, chunk, ksel, group_split, cross_edges):
        t = e.shape[0]
        ke = cont_ops.NBODY_KNOTS if energy == "nbody" else e_knots.shape[1]
        kmu = 0 if mu_knots is None else mu_knots.shape[0]
        nb = bounds.shape[-1] - 1
        npan = cont_ops.outer_panel_count(ke, nb, angular, kmu, group_split, cross_edges)
        sy = cont_ops.inner_panel_count(ke, ksel, angular, kmu)
        count(
            f"cm_moments_pointwise[{angular},{energy}]", t, nodes=t * npan * nq_w * sy * nq_y,
            chunks=-(-npan // chunk), chunk_tensor_bytes_max=0,
        )
        c = calls[f"cm_moments_pointwise[{angular},{energy}]"]
        c["chunk_tensor_bytes_max"] = max(c["chunk_tensor_bytes_max"], t * min(chunk, npan) * nq_w * sy * nq_y * 8)
        c.setdefault("shapes", set()).add((ke, ksel, kmu, npan, sy, nb))
        return e.new_zeros((t, order + 1, nb))

    def lab(e_knots, pdf, moms, bounds, order, nq=6, clamp=True):
        count("lab_tabular_moments", e_knots.shape[0], subintervals=e_knots.shape[0] * (e_knots.shape[1] + bounds.shape[-1] - 1))
        return pdf.new_zeros((e_knots.shape[0], order + 1, bounds.shape[-1] - 1))

    def lines(e_out, w, am, bounds, clamp=True):
        count("discrete_lines_moments", e_out.shape[0])
        return am.new_zeros((am.shape[0], am.shape[2], bounds.shape[0] - 1))

    def analytic(e, theta, b, u, bounds, law, clamp=True, nq=24):
        count("analytic_group_fractions", e.shape[0])
        return e.new_zeros((e.shape[0], bounds.shape[0] - 1))

    def tabular(e_knots, pdf, bounds, clamp=True):
        count("tabular_group_fractions", e_knots.shape[0])
        return pdf.new_zeros((e_knots.shape[0], bounds.shape[-1] - 1))

    patches = [
        (driver, "twobody_moments", twobody),
        (continuum_driver, "cm_moments_pointwise", cm),
        (continuum_driver, "lab_tabular_moments", lab),
        (continuum_driver, "discrete_lines_moments", lines),
        (continuum_driver, "analytic_group_fractions", analytic),
        (chi_driver, "analytic_group_fractions", analytic),
        (chi_driver, "tabular_group_fractions", tabular),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        with tempfile.TemporaryDirectory(prefix="ndpp_plan_deck_") as work:
            cfg = make_deck(which, Path(work))
            cfg.output.path = str(Path(work) / "plan.txt")
            metrics = driver.run(cfg, device=torch.device("cpu"))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    ops = {}
    for name, c in sorted(calls.items()):
        ops[name] = {k: (sorted(v) if isinstance(v, set) else v) for k, v in c.items()}
    return {
        "deck": which, "plan_only": True, "nuclides": metrics.nuclides_done, "moments": metrics.moments_computed,
        "cm_shapes_key": "(ke, ksel, kmu, outer panels, inner panels, G|B)", "ops": ops,
    }


def short_name(kernel: str) -> str:
    """A device event's name without namespaces and pointer-array noise, cut
    to 120 characters: long enough to tell torch's elementwise functors apart."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::cuda::detail::", "binary_internal::"):
        kernel = kernel.replace(noise, "")
    return kernel[:120]


def busy_and_gaps(events: list[dict], n_gaps: int = 5):
    """(busy ms, span ms, largest idle gaps) of the device events: busy is the
    union of their intervals, the span runs from the first start to the last
    end, and a gap is device-idle time between two merged busy intervals."""
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATEGORIES), key=lambda e: e["ts"])
    if not dev:
        return 0.0, 0.0, []
    busy = 0.0
    gaps = []
    t0 = dev[0]["ts"]
    cur_end, last = dev[0]["ts"], dev[0]
    for e in dev:
        start, end = e["ts"], e["ts"] + e.get("dur", 0)
        if start > cur_end:
            gaps.append({"ms": (start - cur_end) * 1e-3, "at_ms": (cur_end - t0) * 1e-3,
                         "after": short_name(last["name"])[:60], "before": short_name(e["name"])[:60]})
        busy += max(0.0, end - max(start, cur_end))
        if end > cur_end:
            cur_end, last = end, e
    return busy * 1e-3, (cur_end - t0) * 1e-3, sorted(gaps, key=lambda g: -g["ms"])[:n_gaps]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("deck", choices=("twobody", "continuum"))
    ap.add_argument("--plan", action="store_true", help="print the dispatch plan from a CPU run of recorders")
    ap.add_argument("--out", type=Path, help="also write the JSON line to this file")
    a = ap.parse_args()

    if a.plan:
        rec = plan(a.deck)
    else:
        rec = profile(a.deck)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


def profile(which: str) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_deck: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from ndpp_tpu_torch import driver
    from ndpp_tpu_torch.ops import twobody_inner
    from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments

    twobody_inner.library()  # build the kernel now: nvcc's seconds are no idle gap of the deck
    with tempfile.TemporaryDirectory(prefix="ndpp_profile_deck_") as work:
        work = Path(work)
        cfg = make_deck(which, work)
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
            by_name[short_name(e["name"])] += e.get("dur", 0) * 1e-3  # us -> ms
            count[short_name(e["name"])] += 1
    busy_ms, span_ms, gaps = busy_and_gaps(events)
    d2h_ms = sum(v for k, v in by_name.items() if "DtoH" in k)
    h2d_ms = sum(v for k, v in by_name.items() if "HtoD" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    return {
        "deck": which,
        "card": smi,
        "wall_s": wall,
        "nuclides_done": metrics.nuclides_done,
        "quarantined": metrics.nuclides_quarantined,
        "moments": metrics.moments_computed,
        "kernel_launches": twobody_group_moments.launches,
        "device_events": sum(count.values()),
        "device_busy_ms": busy_ms,
        "device_span_ms": span_ms,  # first device event's start to the last one's end
        "busy_share_of_span": busy_ms / span_ms if span_ms else None,
        "busy_share_of_wall": busy_ms * 1e-3 / wall,
        "largest_idle_gaps": gaps,
        "d2h_ms": d2h_ms,
        "h2d_ms": h2d_ms,
        "d2h_share_of_busy": d2h_ms / busy_ms if busy_ms else None,
        "peak_device_bytes": metrics.device_mem_highwater_bytes,
        "continuum_chunks": {str(k): v for k, v in sorted(metrics.continuum_chunks.items())},
        "phase_seconds": metrics.phase_seconds,
        "top_ms": [{"name": k, "ms": v, "count": count[k]} for k, v in top],
    }


if __name__ == "__main__":
    sys.exit(main())
