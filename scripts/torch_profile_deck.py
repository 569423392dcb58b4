"""Profile one of chip_smoke.py's decks on the card and break down the device's time.

    python3 scripts/torch_profile_deck.py {twobody,continuum,thermal} [--out FILE]
    python3 scripts/torch_profile_deck.py thermal --plan      (no card needed)

Writes the deck's synthetic fixture library (twobody: h1, fe56, o16 and two
stress nuclides; continuum: the twelve continuum and chi fixtures; thermal:
h1, o16, fe56, u235, h1_iso and the lwtr and grph tables, at 293.6 K and
600 K with free-gas on every nuclide), runs the
P5 / uniform-lethargy-361 deck through ``driver.run(cfg, device="cuda")``
with ``device.profile`` on (torch.profiler over CPU and CUDA activity), and
reads the chrome trace the driver exports: device time by kernel or copy
name, summed over the run; the device-busy total (the union of the device
events' intervals) and its share of the span from the first device event to
the last; the largest idle gaps of the device inside that span, each with
the events on both sides; the host wall up to the profiler's stop; the share
of the device-to-host result copies; the run's phase seconds. It prints one
JSON line (also written to --out, if given) with those numbers and the
card's name and power limit. It names the port's three hand-written
kernels in their own table (hand_kernels: device ms and launches of
twobody_group_kernel, freegas_sab_kernel and cm_inner_kernel, summed over
their template instances, beside each wrapper's launch count). For the
free-gas op and the CM-continuum op it adds the device time of everything
that freegas_moments_sab and cm_moments_pointwise launched (the CUDA
launches inside a profiler range around each call, matched to the device
events by their correlation ids), their kernel count and calls; for the
free-gas op also its rows, its share of the busy time, and its bound: the
least time the card could take for the same work, the larger of the bytes
it must move (each row's energy and the window read once, the (T, L+1, w+1)
result written once) over the HBM rate and its float64 operations (per
quadrature node: one exp, one sqrt and 30 other operations) over the peak
float64 rate. It needs a CUDA card and exits non-zero without one.

--plan runs nothing on a device. It drives the same deck through the driver
on the CPU with every device op replaced by a recorder that returns zeros of
the right shape, and prints, per op, the calls, rows, and for
cm_moments_pointwise the quadrature nodes (rows x outer nodes x inner panels
x inner nodes) and the bytes of one (T, NW, SY, QY) float64 tensor per chunk,
and for freegas_moments_sab its rows, chunks and quadrature nodes (rows x
y-panels x nq_g x u-panels x nq_u) and the bytes of one (T, chunk x nq_g,
u-panels, nq_u) float64 tensor: the sizes a prediction of the device time is
reckoned from. The chunks and chunk tensors are the plain (CPU) path's; on
the card each call is one kernel launch, and kernel_tiles lists, per call
of either op, that launch: its kernel, rows, lanes per point (G, as the
wrapper chooses it for an H100's 132 SMs), grid (rows x 128-thread blocks),
the order the kernel is instantiated for (free-gas: L; CM: the L bucket),
and for cm_inner_kernel the bytes of a row's tables and whether they are
staged in shared memory or read through L2.
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
FREEGAS_RANGE = "ndpp.freegas_moments_sab"  # profiler range around each free-gas call
CM_RANGE = "ndpp.cm_moments_pointwise"  # profiler range around each CM-continuum call
HAND_KERNELS = {  # device kernel name -> the wrapper that launches it
    "twobody_group_kernel": "twobody_group_moments", "freegas_sab_kernel": "sab_density",
    "cm_inner_kernel": "cm_inner_moments",
}
THREADS = 128  # threads per block of freegas_sab_kernel and cm_inner_kernel
SMEM_BYTES_MAX = 232448  # the most dynamic shared memory an H100 block may hold (227 KB)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP64_PEAK_FLOPS_PER_S = 67e12  # H100 SXM peak float64 (tensor cores); 34e12 outside them
FLOPS_PER_FREEGAS_NODE = 32  # exp, sqrt and 30 other float64 operations per (y, u) node


def make_deck(which: str, work: Path):
    if which == "twobody":
        names = chip_smoke.write_fixtures(work / "lib")
        return chip_smoke.deck(work / "lib", names, work / "cuda.txt")
    if which == "continuum":
        names = chip_smoke.write_fixtures(work / "lib", chip_smoke.CONTINUUM_FIXTURES, ())
        return chip_smoke.deck(work / "lib", names, work / "cuda.txt")
    names = chip_smoke.write_fixtures(work / "lib", chip_smoke.THERMAL_FIXTURES, (), chip_smoke.THERMAL_TABLES)
    return chip_smoke.deck(work / "lib", names, work / "cuda.txt", **chip_smoke.THERMAL_RUN)


def freegas_work(e, bounds, order: int) -> dict:
    """Quadrature nodes, float64 operations and bytes of one freegas_moments_sab call."""
    from ndpp_tpu_torch.ops import freegas as fg_ops

    rows, nb = e.shape[0], bounds.shape[0]
    nodes = rows * fg_ops.Y_PANELS * fg_ops.NQ_G * fg_ops.U_PANELS * fg_ops.NQ_U
    return {
        "rows": rows, "nodes": nodes, "flops": nodes * FLOPS_PER_FREEGAS_NODE,
        "bytes": 8 * (rows + nb + rows * (order + 1) * (nb - 1)),
    }


def cm_row_table_bytes(ke: int, kmu: int, angular: str, energy: str) -> int:
    """Bytes of one row's tables that cm_inner_launch (csrc/cm_pointwise.cu)
    stages in shared memory when they fit in SMEM_BYTES_MAX: yk, the channel
    payload and, for tabular angles, e_knots, mu_knots and mu_pdf. The launch
    decides on the card; this copy of its rule serves the plan, which runs
    without one."""
    from ndpp_tpu_torch.ops import continuum as cont_ops

    n = ke + (ke - 1) * cont_ops.payload_columns(angular, energy)
    if angular == "tabular":
        n += ke + kmu + ke * kmu
    return 8 * n


def freegas_tile(rows: int, order: int) -> dict:
    """The launch of freegas_sab_kernel for a freegas_moments_sab call of
    `rows` rows, as sab_density makes it on an H100."""
    from ndpp_tpu_torch.ops import freegas as fg_ops

    lanes = fg_ops.sab_lanes(rows, fg_ops.Y_PANELS)
    return {
        "kernel": "freegas_sab_kernel", "rows": rows, "y_nodes": fg_ops.Y_PANELS * fg_ops.NQ_G, "lanes": lanes,
        "order": order, "grid": [rows, -(-fg_ops.Y_PANELS * fg_ops.NQ_G * lanes // THREADS)], "threads": THREADS,
        "path": "fixed-ladder table in shared memory",
    }


def cm_tile(rows: int, nw: int, ke: int, kmu: int, ksel: int, order: int, angular: str, energy: str) -> dict:
    """The launch of cm_inner_kernel for a (rows, nw) tile, as
    cm_inner_moments makes it on an H100."""
    from ndpp_tpu_torch.ops import continuum as cont_ops

    row_bytes = cm_row_table_bytes(ke, kmu, angular, energy)
    lanes = cont_ops.cm_lanes(rows, nw)
    return {
        "kernel": "cm_inner_kernel", "variant": [angular, energy, "window" if 0 < ksel < ke else "all knots"],
        "rows": rows, "outer_nodes": nw, "lanes": lanes, "order_bucket": cont_ops.cm_order_bucket(order),
        "grid": [rows, -(-nw * lanes // THREADS)], "threads": THREADS, "row_table_bytes": row_bytes,
        "path": "shared" if row_bytes <= SMEM_BYTES_MAX else "l2",
    }


def plan(which: str) -> dict:
    """The deck's dispatch plan, from a CPU run whose device ops only record."""
    import torch

    from ndpp_tpu_torch import chi_driver, continuum_driver, driver, freegas_driver, thermal_driver
    from ndpp_tpu_torch.ops import continuum as cont_ops

    calls: dict[str, dict] = defaultdict(lambda: defaultdict(int))
    kernel_tiles: list[dict] = []

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
           angular, energy, clamp, chunk, ksel, group_split, cross_edges, lanes=None):
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
        kernel_tiles.append(cm_tile(t, npan * nq_w, ke, kmu, ksel, order, angular, energy))
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

    def freegas(e, awr, kt, bounds, order, chunk, lanes=None):
        from ndpp_tpu_torch.ops import freegas as fg_ops

        work = freegas_work(e, bounds, order)
        count("freegas_moments_sab", work["rows"], nodes=work["nodes"], flops=work["flops"], bytes=work["bytes"],
              chunks=-(-fg_ops.Y_PANELS // chunk), chunk_tensor_bytes_max=0)
        c = calls["freegas_moments_sab"]
        c["chunk_tensor_bytes_max"] = max(
            c["chunk_tensor_bytes_max"], e.shape[0] * chunk * fg_ops.NQ_G * fg_ops.U_PANELS * fg_ops.NQ_U * 8)
        c.setdefault("shapes", set()).add((e.shape[0], chunk, bounds.shape[0] - 1))
        kernel_tiles.append(freegas_tile(e.shape[0], order))
        return e.new_zeros((e.shape[0], order + 1, bounds.shape[0] - 1))

    def thermal_cont(e_knots, pdf, am, bounds, order):
        count("thermal_continuous_moments", e_knots.shape[0],
              panel_groups=e_knots.shape[0] * (e_knots.shape[1] - 1) * (bounds.shape[0] - 1))
        return pdf.new_zeros((e_knots.shape[0], order + 1, bounds.shape[0] - 1))

    def thermal_disc(e_out, w, am, bounds, clamp=True):
        count("thermal_discrete_moments", e_out.shape[0])
        return am.new_zeros((am.shape[0], am.shape[2], bounds.shape[0] - 1))

    def coherent(e, edges, s, bounds, order):
        count("coherent_elastic_moments", e.shape[0])
        return e.new_zeros((e.shape[0], order + 1, bounds.shape[0] - 1))

    def incoherent(f, e, bounds):
        count("incoherent_elastic_placement", e.shape[0])
        return f.new_zeros((f.shape[0], f.shape[1], bounds.shape[0] - 1))

    patches = [
        (driver, "twobody_moments", twobody),
        (continuum_driver, "cm_moments_pointwise", cm),
        (continuum_driver, "lab_tabular_moments", lab),
        (continuum_driver, "discrete_lines_moments", lines),
        (continuum_driver, "analytic_group_fractions", analytic),
        (chi_driver, "analytic_group_fractions", analytic),
        (chi_driver, "tabular_group_fractions", tabular),
        (freegas_driver, "freegas_moments_sab", freegas),
        (thermal_driver, "thermal_continuous_moments", thermal_cont),
        (thermal_driver, "thermal_discrete_moments", thermal_disc),
        (thermal_driver, "coherent_elastic_moments", coherent),
        (thermal_driver, "incoherent_elastic_placement", incoherent),
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
    launches = defaultdict(int)
    for k in kernel_tiles:
        launches[k["kernel"]] += 1
    return {
        "deck": which, "plan_only": True, "nuclides": metrics.nuclides_done, "moments": metrics.moments_computed,
        "cm_shapes_key": "(ke, ksel, kmu, outer panels, inner panels, G|B)", "ops": ops,
        "kernel_launches_on_card": dict(launches), "kernel_tiles": kernel_tiles,
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
    ap.add_argument("deck", choices=("twobody", "continuum", "thermal"))
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
    from ndpp_tpu_torch import continuum_driver, driver, freegas_driver

    chip_smoke.build()  # build the kernels now: nvcc's seconds are no idle gap of the deck
    wrappers = chip_smoke.kernel_wrappers()
    fg_calls = []
    fg_op = freegas_driver.freegas_moments_sab
    cm_op = continuum_driver.cm_moments_pointwise

    def fg_ranged(e, awr, kt, bounds, order, chunk, lanes=None):
        fg_calls.append(freegas_work(e, bounds, order))
        with torch.profiler.record_function(FREEGAS_RANGE):
            return fg_op(e, awr, kt, bounds, order, chunk, lanes)

    def cm_ranged(*args, **kw):
        with torch.profiler.record_function(CM_RANGE):
            return cm_op(*args, **kw)

    freegas_driver.freegas_moments_sab = fg_ranged
    continuum_driver.cm_moments_pointwise = cm_ranged
    try:
        with tempfile.TemporaryDirectory(prefix="ndpp_profile_deck_") as work:
            work = Path(work)
            cfg = make_deck(which, work)
            cfg.device.profile = True
            chip_smoke.reset_counts()
            t0 = time.perf_counter()
            metrics = driver.run(cfg, device="cuda")
            wall = time.perf_counter() - t0
            events = json.loads((work / "torch_trace.json").read_text())["traceEvents"]
    finally:
        freegas_driver.freegas_moments_sab = fg_op
        continuum_driver.cm_moments_pointwise = cm_op
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
    fg_ms, fg_kernels = ranged_device_time(events, FREEGAS_RANGE)
    cm_ms, cm_kernels = ranged_device_time(events, CM_RANGE)
    hand = {}
    for kernel, wrapper in HAND_KERNELS.items():
        names = [k for k in by_name if kernel in k]
        hand[kernel] = {"device_ms": sum(by_name[k] for k in names), "device_launches": sum(count[k] for k in names),
                        "wrapper_launches": wrappers[wrapper].launches}
    fg = None
    if fg_calls:
        nbytes = sum(c["bytes"] for c in fg_calls)
        flops = sum(c["flops"] for c in fg_calls)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP64_PEAK_FLOPS_PER_S * 1e3
        fg = {
            "calls": len(fg_calls), "rows": sum(c["rows"] for c in fg_calls),
            "nodes": sum(c["nodes"] for c in fg_calls), "device_ms": fg_ms, "kernel_launches": fg_kernels,
            "share_of_busy": fg_ms / busy_ms if busy_ms else None, "bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
    return {
        "deck": which,
        "card": smi,
        "wall_s": wall,
        "nuclides_done": metrics.nuclides_done,
        "quarantined": metrics.nuclides_quarantined,
        "moments": metrics.moments_computed,
        "kernel_launches": wrappers["twobody_group_moments"].launches,
        "hand_kernels": hand,
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
        "freegas_moments_sab": fg,
        "cm_moments_pointwise": {"calls": sum(1 for e in events if e.get("cat") == "user_annotation"
                                              and e.get("name") == CM_RANGE),
                                 "device_ms": cm_ms, "kernel_launches": cm_kernels,
                                 "share_of_busy": cm_ms / busy_ms if busy_ms else None},
    }


def ranged_device_time(events: list[dict], range_name: str) -> tuple[float, int]:
    """Device ms and kernel count of the work launched inside the host ranges
    named `range_name`: CUDA runtime calls that start inside a range, matched
    to device events by their correlation ids."""
    import bisect

    ranges = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") == range_name)
    starts = [r[0] for r in ranges]
    corr = set()
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] <= ranges[i][1]:
                corr.add(e.get("args", {}).get("correlation"))
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES and e.get("args", {}).get("correlation") in corr]
    return sum(e.get("dur", 0) for e in dev) * 1e-3, sum(1 for e in dev if e.get("cat") == "kernel")


if __name__ == "__main__":
    sys.exit(main())
