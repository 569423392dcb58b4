"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It imports only the port (ndpp_tpu_torch),
never jax or the reference package, and proves in one process that:

  1. environment: a CUDA card is present (else it exits non-zero and prints
     no result); prints the card's name and power limit, torch/CUDA/nvcc;
  2. build: the two-body kernel (ndpp_tpu_torch/csrc/twobody_inner.cu)
     builds with nvcc for sm_90a from the checkout's sources; ptxas's
     registers and spills per kernel instance are printed;
  3. kernel vs plain: at the bench shape (2048 rows, P5, 361 groups, 16 GL
     points; panels from the port's prologue on fe56 rows) the fused kernel
     agrees with its plain torch version (inner stage, then the group
     epilogue) within |k - p| <= 1e-14 + 1e-12 |p| elementwise, on the dense
     361-group table, on per-row B = 32 windows, and with clamp off. On the
     dense table the kernel, the plain version and the torch epilogue alone
     are timed in turns by CUDA events around CUDA-graph replays of 20 calls
     (median of 2 x 10 replays), and the kernel also by CUDA events around
     one eager call (median of 20), which puts the launch's host overhead on
     the clock;
  4. the two-body deck: ``driver.run(cfg, device="cuda")`` on a P5 /
     uniform-lethargy-361 deck over h1, fe56, o16 and two stress nuclides
     (two-body only; free-gas off; until the continuum deck joined, this
     deck held six stress nuclides: four were cut to keep the script's time)
     quarantines nothing, launches the kernel, writes finite moments whose
     P0 rows sum to the mean yield (1 here) within 1e-10 wherever
     sigma_scatter > 0, and matches the same deck run on the CPU (plain
     path) under the library comparator at rtol 1e-8, atol 1e-14;
  5. the continuum and chi deck, same width, over kalbach, law61, law61cm,
     law67, law4nd, nbody, law1, law5, u235, maxwell, evap and watt (every
     continuum law kind and both chi paths, each beside elastic and level
     inelastic reactions on the two-body kernel), held to the same checks,
     plus chi rows (prompt, delayed, total) summing to 1 within 1e-10 where
     the spectrum is not empty (analytic rows below the restriction energy U
     are 0), and compared whole with its CPU run at rtol 1e-8, atol 1e-14;
  6. the thermal deck, same width, at 293.6 K and 600 K over h1, o16, fe56,
     u235 and h1_iso with the default free-gas settings (every nuclide,
     below 400 kT) and S(alpha,beta) tables on h1 (lwtr.20t) and o16
     (grph.20t), held to the same checks and compared whole with its CPU run;
  7. the CLI on the card's machine: ``python -m ndpp_tpu_torch info`` on the
     two-body deck's ASCII library names every nuclide the deck wrote, and
     ``python -m ndpp_tpu_torch groups`` lists the deck's group structure;
  8. selfcheck: ``python -m ndpp_tpu_torch selfcheck`` in a process of its
     own at the production shape (2048 rows, P5, 361 groups, nq 16) exits 0:
     the two-body kernel against its plain version on the card (relative
     error at most 1e-8, at least one launch), free-gas against the
     panel-split kernel, continuum (with the small-a probe and the
     tabular-angle leg) and chi against an exact host integral, each under
     the reference's gates. Its kernel launches join the kernel line;
  9. shards: a mixed deck (h1 with lwtr.20t, o16, fe56, kalbach and u235 at
     293.6 K, free-gas on: every family) through driver.run on one shard
     and on two (on two cards where the machine has them, else both on
     cuda:0, each shard on its own stream); each run launches the kernel,
     the kernel launches on both shards, and the two libraries agree at
     rtol 1e-13, atol 1e-16 (the reference's bound for its 8-device run
     against 1); walls and launches per shard are printed;
 10. mesh: parallel.mesh.sharded_twobody_moments on a 1 x 2 mesh at the
     bench shape (four fe56 reactions of 512 rows: 2048 rows, P5, 361
     groups, nq 16) against one-device twobody_moments at the same bound,
     one kernel launch per cell;
 11. scale: scripts/torch_scale_demo.py --nuclides 5 as a subprocess (its
     cold and warm passes, P5, 361 groups, 293.6 and 600 K): exit 0, both
     passes' SCALE lines, nothing quarantined; moments/s printed beside
     the card's name and power limit. Its kernel launches join the line.

Worker runs (``run --workers``) and ``merge`` are not driven here: their
shards are HDF5 and the card's machine has no h5py; the CPU tests hold them.

The line before the last is a JSON object describing each kernel of the
path; the last line is {"ok": true, "device": {...}}. Any failed phase
raises, which exits non-zero before either line is printed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SHAPE = {"rows": 2048, "order": 5, "groups": 361, "nq": 16}
TWOBODY_FIXTURES = ("h1", "fe56", "o16")
STRESS = (1, 12)  # stress_nuclide indices of the two-body deck (a dense and a banded elastic pool)
CONTINUUM_FIXTURES = (
    "kalbach", "law61", "law61cm", "law67", "law4nd", "nbody", "law1", "law5", "u235", "maxwell", "evap", "watt",
)
THERMAL_FIXTURES = ("h1", "o16", "fe56", "u235", "h1_iso")
THERMAL_TABLES = ("lwtr", "grph")
# The fixture set has no carbon: o16 carries the graphite table only so that
# the discrete-inelastic and Bragg-edge paths run on the card. Both tables are
# at 293.6 K, so at 600 K match_tables warns that the nearest one is far.
THERMAL_SAB = {"1001.80c": ["lwtr.20t"], "8016.80c": ["grph.20t"]}
THERMAL_TEMPERATURES = [293.6, 600.0]
THERMAL_RUN = {"freegas_for": [], "sab": THERMAL_SAB, "temperatures": THERMAL_TEMPERATURES}  # default free-gas
BAND = 32  # per-row window width of the banded variant
RTOL, ATOL = 1e-12, 1e-14  # kernel vs plain, elementwise
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP64_FLOPS_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores
LIB_RTOL, LIB_ATOL = 1e-8, 1e-14  # CUDA library vs CPU library
# the shards phase: one nuclide of every family at one temperature
SHARD_FIXTURES = ("h1", "o16", "fe56", "kalbach", "u235")
SHARD_RUN = {"freegas_for": [], "sab": {"1001.80c": ["lwtr.20t"]}, "temperatures": [293.6]}
SHARD_RTOL, SHARD_ATOL = 1e-13, 1e-16  # two shards vs one (the reference's bound for its 8 devices vs 1)
SCALE_NUCLIDES = 5  # torch_scale_demo.py's first five fixtures: evap, fe56, h1 (with lwtr), h1_iso, kalbach
P0_TOL = 1e-10  # P0 row sums against the mean yield, chi row sums against 1


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False -- this run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    import ndpp_tpu_torch
    from ndpp_tpu_torch.ops import twobody_inner as inner_mod

    pkg = Path(ndpp_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise SystemExit(f"chip_smoke: ndpp_tpu_torch imported from {pkg}, not from this checkout")
    nvcc = subprocess.run([inner_mod._nvcc(), "--version"], capture_output=True, text=True, timeout=60, check=True)
    print(smi, flush=True)  # name, power limit (nvidia-smi csv)
    phase("env", f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    phase("env", f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    phase("env", f"device 0: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    return smi


def build():
    import re

    from ndpp_tpu_torch.ops import twobody_inner as inner_mod

    path, seconds = inner_mod.build()
    inner_mod.library()
    phase("build", f"{path.relative_to(ROOT)} built in {seconds:.2f} s")
    name = "?"
    for line in inner_mod.ptxas_report(path).read_text().splitlines():
        entry = re.search(r"Compiling entry function '.*?twobody_group_kernelILi(\d+)ELi(\d+)E", line)
        if entry:
            name = f"L={entry.group(1)} nq={entry.group(2) if entry.group(2) != '0' else 'any'}"
        elif "spill" in line or "Used" in line:
            phase("build", f"ptxas {name}: {line.strip()}")
    return seconds


def fe56_preps():
    """The port's two-body preparation of every fe56 two-body reaction on its
    moment grid, and the knot count they pad to."""
    from ndpp_tpu_torch.host import unionize
    from ndpp_tpu_torch.host.ace import synth
    from ndpp_tpu_torch.host.prep import prepare_twobody

    nuc = synth.fe56_like()
    e_grid = unionize.moment_grid(nuc.energy)
    preps = [prepare_twobody(nuc, r, e_grid) for r in nuc.scattering_reactions(include_fission=False)]
    return preps, unionize.bucket_pow2(max(p.knots.shape[1] for p in preps))


def bench_inputs(device, band: int, clamp: bool, n_rows: int = KERNEL_SHAPE["rows"]):
    """The port's prologue on fe56 rows (every two-body reaction), tiled to
    `n_rows` rows, against the 361-group table (band 0) or per-row windows of
    `band` groups over each row's reach. Returns the fused kernel's
    arguments (mid, half, a_s, b_s, kin, valid_e, bounds)."""
    import numpy as np
    import torch

    from ndpp_tpu_torch import groups
    from ndpp_tpu_torch.host import unionize
    from ndpp_tpu_torch.ops.twobody import twobody_panels

    preps, k = fe56_preps()
    take = np.arange(n_rows)

    def rows(f):
        return np.concatenate([f(p) for p in preps])[take % sum(p.e.size for p in preps)]

    e = rows(lambda p: p.e)
    knots = rows(lambda p: unionize.pad_to(p.knots, k, axis=1))
    pdf = rows(lambda p: unionize.pad_to(p.pdf, k, axis=1))
    c1, c2, awr = (rows(lambda p, a=a: np.full(p.e.size, getattr(p, a))) for a in ("c1", "c2", "awr"))
    bounds = groups.get(f"uniform-lethargy-{KERNEL_SHAPE['groups']}").bounds
    if band:
        # the lowest group each row reaches, E'_lab(mu = -1), one group of margin
        ecm = np.maximum(c2 * (e - c1), 0.0)
        lo = (np.sqrt(ecm) - np.sqrt(e) / (awr + 1.0)) ** 2
        g0 = np.clip(np.searchsorted(bounds, lo, side="right") - 2, 0, bounds.size - 1 - band)
        bounds = bounds[g0[:, None] + np.arange(band + 1)[None, :]]
    t = [torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64, device=device) for x in (e, knots, pdf, bounds, c1, c2, awr)]
    mid, half, a_s, b_s, base, slope, ecm, e_safe, ap1, valid_e = twobody_panels(*t, clamp)
    kin = torch.stack([base, slope, torch.sqrt(ecm), torch.sqrt(e_safe) / ap1], dim=1)
    return mid, half, a_s, b_s, kin, valid_e, t[3]


def time_turns(fns: dict, n: int = 20, reps: int = 10) -> dict:
    """Median device time in ms of one call of each fn. The n calls are
    captured in one CUDA graph and the graph is replayed between CUDA events,
    so host overhead (Python, the wrapper's checks, launch latency) stays out
    of the time; turns (a, b, c, c, b, a) let drift of the card's clocks fall
    on every function alike. Inputs stay in L2 across calls, as they do when
    the prologue has just written them."""
    import torch

    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(n):
                fn()
    times = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        graphs[name].replay()
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / n)
    return {name: statistics.median(v) for name, v in times.items()}


def time_eager(fn, n: int = 20) -> float:
    """Median time in ms of one eager call of fn, CUDA events around each of
    n calls: the launch's host overhead is on the clock (the timing of the
    `ms` series before time_turns)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(args, order: int, nq: int, clamp: bool) -> tuple[float, str]:
    """The least time the card could take for the fused kernel's work on
    these inputs, the larger of two: bytes over the HBM rate, or f64
    operations over the FP64 rate. Bytes: kin, valid_e and the bounds read
    once; on each row above threshold (a row below is all zeros whatever its
    panels hold) every half read once, to find the live subintervals
    (half > 0), and mid, a_s, b_s of the live ones; the output written once.
    Operations count the live subintervals inside the table: per GL node 15
    flops of kinematics, pdf and weight (an FMA is 2, a min/max or rsqrt 1),
    2 for P_1 and 6 per Bonnet step after it, and 2(L+1) per subinterval to
    scale and sum; plus 2 per live subinterval for E'_lab(mid)."""
    import torch

    mid, half, a_s, b_s, kin, valid_e, bounds = args
    t, s = mid.shape
    ng = bounds.shape[-1] - 1
    rows = int(valid_e.sum())
    alive = (half > 0) & valid_e[:, None]
    n_alive = int(alive.sum())
    nbytes = (
        sum(x.numel() * x.element_size() for x in (kin, valid_e, bounds))
        + rows * s * 8 + 3 * n_alive * 8 + t * (order + 1) * ng * 8
    )
    elab = kin[:, 0:1] + kin[:, 1:2] * mid
    b2 = bounds.expand(t, ng + 1).contiguous() if bounds.dim() == 1 else bounds
    if clamp:
        inside = torch.ones_like(elab, dtype=torch.bool)
    else:
        inside = (elab >= b2[:, :1]) & (elab < b2[:, -1:])
    live = int((alive & inside).sum())
    per_node = 15 + (2 if order >= 1 else 0) + 6 * max(order - 1, 0)
    flops = live * (nq * per_node + 2 * (order + 1)) + 2 * n_alive
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS_PER_S
    phase("kernel", f"bound: {nbytes} B -> {t_bytes * 1e3:.5f} ms, {flops:.4e} f64 flops -> {t_ops * 1e3:.5f} ms "
          f"({n_alive} live of {t * s} subintervals, {live} inside the table; {rows} of {t} rows above threshold)")
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_vs_plain(smi: str):
    import torch

    from ndpp_tpu_torch.ops.twobody_inner import (
        twobody_group_moments, twobody_group_moments_ref, twobody_inner_ref, twobody_scatter,
    )

    order, nq = KERNEL_SHAPE["order"], KERNEL_SHAPE["nq"]
    dev = torch.device("cuda", 0)
    max_abs = 0.0
    for label, band, clamp in (("dense", 0, True), (f"banded B={BAND}", BAND, True), ("dense clamp=False", 0, False)):
        args = bench_inputs(dev, band, clamp)
        out = twobody_group_moments(*args, order, nq, clamp)
        ref = twobody_group_moments_ref(*args, order, nq, clamp)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{label}: kernel output {tuple(out.shape)} is not finite or not {tuple(ref.shape)}")
        err = (out - ref).abs()
        bad = int((err > ATOL + RTOL * ref.abs()).sum())
        max_abs = max(max_abs, float(err.max()))
        phase(
            "kernel",
            f"twobody_group_moments {label} T,S={tuple(args[0].shape)} -> {tuple(out.shape)} L={order} nq={nq}: "
            f"max_abs={float(err.max()):.3e} "
            f"max_rel(|p| > {ATOL:g})={float((err / ref.abs())[ref.abs() > ATOL].max()):.3e} "
            f"outside(|k-p| <= {ATOL:g} + {RTOL:g}|p|)={bad}",
        )
        if bad:
            raise RuntimeError(f"{label}: kernel disagrees with its plain version on {bad} elements")

    args = bench_inputs(dev, 0, True)
    mid, half, a_s, b_s, kin, valid_e, bounds = args
    m = twobody_inner_ref(mid, half, a_s, b_s, kin, order, nq)  # the (T, L+1, S) tensor the epilogue reads
    ms = time_turns({
        "kernel": lambda: twobody_group_moments(*args, order, nq, True),
        "plain": lambda: twobody_group_moments_ref(*args, order, nq, True),
        "epilogue": lambda: twobody_scatter(m, mid, half, kin[:, 0], kin[:, 1], valid_e, bounds, True),
    })
    eager_ms = time_eager(lambda: twobody_group_moments(*args, order, nq, True))
    bound_ms, bound_by = bound(args, order, nq, True)
    phase(
        "kernel",
        f"device time per call, median of 2 x 10 graph replays of 20 calls, in turns: "
        f"fused kernel {ms['kernel']:.5f} ms, plain torch {ms['plain']:.5f} ms, "
        f"torch epilogue alone {ms['epilogue']:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}) on {smi}",
    )
    phase("kernel", f"one eager call, CUDA events around it, median of 20: fused kernel {eager_ms:.5f} ms")
    return {
        "max_abs_err": max_abs, "ms": ms["kernel"], "plain_ms": ms["plain"], "epilogue_ms": ms["epilogue"],
        "eager_ms": eager_ms, "bound_ms": bound_ms, "bound_by": bound_by, "shape": list(mid.shape),
    }


def write_fixtures(lib: Path, keys=TWOBODY_FIXTURES, stress=STRESS, thermal=()) -> list[str]:
    """ACE files of the fixtures `keys`, the stress nuclides and the thermal
    tables `thermal` under `lib`, with their xsdir; returns the nuclide names."""
    from ndpp_tpu_torch.host.ace import synth
    from ndpp_tpu_torch.host.ace.thermal import write_thermal_ace
    from ndpp_tpu_torch.host.ace.write import write_ace

    lib.mkdir(parents=True, exist_ok=True)
    nucs = [synth.build(k) for k in keys] + [synth.stress_nuclide(i) for i in stress]
    lines = []
    for nuc in nucs:
        p = write_ace(nuc, lib / f"{nuc.name}.ace")
        lines.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    for key in thermal:
        tab = synth.build_thermal(key)
        p = write_thermal_ace(tab, lib / f"{tab.name}.ace")
        lines.append(f"{tab.name} {tab.awr:.6f} {p.name} 0 1 1 0")
    (lib / "xsdir").write_text("directory\n" + "\n".join(lines) + "\n")
    return [n.name for n in nucs]


def deck(lib: Path, names: list[str], out: Path, **run):
    """The P5 / 361-group ASCII deck over `names`; free-gas off unless `run`
    (RunConfig fields) says otherwise."""
    from ndpp_tpu_torch.config import RunConfig

    cfg = RunConfig(
        nuclides=names,
        library=str(lib / "xsdir"),
        groups=f"uniform-lethargy-{KERNEL_SHAPE['groups']}",
        legendre_order=KERNEL_SHAPE["order"],
        **{"freegas_for": ["none"], **run},
    )
    cfg.output.path = str(out)
    cfg.output.format = "ascii"
    cfg.validate()
    return cfg


def run_on_card(tag: str, cfg, n_nuclides: int, device="cuda"):
    """driver.run on the card (`device`: what driver.run takes) with the
    kernel's count set to 0 just before and read just after; raises on a
    quarantine or on a run that never launched the kernel. Returns (metrics,
    launches, wall seconds)."""
    import torch

    from ndpp_tpu_torch import driver
    from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments

    twobody_group_moments.launches = 0  # launches of the compare phase and of other decks do not count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = driver.run(cfg, device=device)
    wall = time.perf_counter() - t0
    launches = twobody_group_moments.launches
    phase(
        tag,
        f"cuda: wall {wall:.3f} s, {metrics.moments_computed} moments, "
        f"{metrics.moments_computed / wall:.4e} moments/s, done {metrics.nuclides_done}, "
        f"quarantined {metrics.nuclides_quarantined}, kernel launches {launches}, "
        f"max_memory_allocated {metrics.device_mem_highwater_bytes} B",
    )
    phase(tag, "cuda phase seconds: " + json.dumps({k: round(v, 4) for k, v in metrics.phase_seconds.items()}))
    if metrics.nuclides_quarantined or metrics.nuclides_done != n_nuclides:
        raise RuntimeError(f"{metrics.nuclides_quarantined} nuclide(s) quarantined on the card")
    if launches <= 0:
        raise RuntimeError("the run never launched the two-body kernel")
    return metrics, launches, wall


def mean_yield(nuc, energy):
    """sum_MT sigma_MT y_MT / sigma_scatter on `energy`: what a P0 row sums to
    (1 unless a reaction emits more than one neutron, as (n,2n) does)."""
    import numpy as np

    from ndpp_tpu_torch.driver import reaction_yield

    num = den = 0.0
    for rxn in nuc.scattering_reactions(include_fission=False):
        sig = np.interp(energy, nuc.energy, nuc.sigma_on_grid(rxn))
        num = num + sig * reaction_yield(rxn, energy, True)
        den = den + sig
    return np.where(den > 0, num / np.where(den > 0, den, 1.0), 1.0)


def check_library(tag: str, path, lib: Path, names: list[str]) -> None:
    """Every moment finite; P0 rows sum to the mean yield wherever
    sigma_scatter > 0; chi rows sum to 1 where the spectrum is not empty.
    The yields are read from the ACE files under `lib` that the run parsed."""
    import numpy as np

    from ndpp_tpu_torch.host.ace.parse import read_ace
    from ndpp_tpu_torch.io.library import read_ascii

    datasets, _ = read_ascii(path)
    worst_p0 = worst_chi = 0.0
    chi_rows = 0
    for name in names:
        nuc = read_ace(lib / f"{name}.ace", name_hint=name)
        sc = datasets[f"/nuclides/{name}/scatter"]  # (NT, NE, L+1, G)
        sig = datasets[f"/nuclides/{name}/sigma_scatter"]
        energy = datasets[f"/nuclides/{name}/energy"]
        if not np.isfinite(sc).all():
            raise RuntimeError(f"{name}: non-finite moments")
        p0 = sc[:, :, 0, :].sum(axis=2) - mean_yield(nuc, energy)[None, :]
        worst_p0 = max(worst_p0, float(np.abs(p0[:, sig > 0]).max()))
        for ds in ("chi_prompt", "chi_delayed", "chi_total"):
            chi = datasets.get(f"/nuclides/{name}/{ds}")
            if chi is None:
                continue
            if not np.isfinite(chi).all():
                raise RuntimeError(f"{name}: non-finite {ds}")
            sums = chi.sum(axis=1)
            live = sums > 0
            chi_rows += int(live.sum())
            worst_chi = max(worst_chi, float(np.abs(sums[live] - 1.0).max()))
        if nuc.fissionable and f"/nuclides/{name}/chi_total" not in datasets:
            raise RuntimeError(f"{name}: fissionable but the library holds no chi")
    phase(tag, f"all moments finite; max |P0 row sum - mean yield| = {worst_p0:.3e}, "
          f"max |chi row sum - 1| = {worst_chi:.3e} over {chi_rows} non-empty chi rows (limit {P0_TOL:g})")
    if worst_p0 > P0_TOL or worst_chi > P0_TOL:
        raise RuntimeError("P0 or chi rows do not sum to what they must")


def compare_with_cpu(tag: str, cuda_cfg, cpu_cfg) -> None:
    """Run cpu_cfg's deck on the CPU (plain path) and hold cuda_cfg's library to it."""
    from ndpp_tpu_torch import driver
    from ndpp_tpu_torch.io.library import compare

    t0 = time.perf_counter()
    cpu_metrics = driver.run(cpu_cfg, device="cpu")
    phase(tag, f"cpu (plain path): wall {time.perf_counter() - t0:.3f} s, done {cpu_metrics.nuclides_done}, "
          f"quarantined {cpu_metrics.nuclides_quarantined}")
    report = compare(cuda_cfg.output.path, cpu_cfg.output.path, rtol=LIB_RTOL, atol=LIB_ATOL)
    worst = {
        kind: max((v["max_abs"] for k, v in report["datasets"].items() if kind in k.rsplit("/", 1)[-1]), default=0.0)
        for kind in ("scatter", "chi")
    }
    phase(
        tag,
        f"cuda vs cpu library: match={report['match']} (rtol {LIB_RTOL:g}, atol {LIB_ATOL:g}) over "
        f"{len(report['datasets'])} datasets, scatter max_abs={worst['scatter']:.3e}, chi max_abs={worst['chi']:.3e}",
    )
    if cpu_metrics.nuclides_quarantined or not report["match"]:
        failing = {k: v for k, v in report["datasets"].items() if not v.get("ok", False)}
        raise RuntimeError(f"CUDA and CPU libraries differ: {failing} missing={report['missing']}")


def port_cli(*args: str, timeout: float = 600) -> tuple[str, float]:
    """`python -m ndpp_tpu_torch *args` in a process of its own, from this
    checkout; returns (stdout, wall seconds) and raises unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ndpp_tpu_torch", *args], capture_output=True, text=True, timeout=timeout, cwd=ROOT
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"ndpp_tpu_torch {' '.join(args)} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc.stdout, wall


def cli_phase(library: Path, names: list[str], groups: str) -> None:
    """info on a library the deck wrote, and groups, through the CLI."""
    out, wall = port_cli("info", str(library))
    if f"nuclides ({len(names)}):" not in out or not all(f"  {n} " in out for n in names):
        raise RuntimeError(f"info does not list the {len(names)} nuclides the deck wrote:\n{out}")
    phase("cli", f"info {library.name}: exit 0 in {wall:.2f} s, " + "; ".join(out.splitlines()[1:5]))
    out, wall = port_cli("groups")
    if not any(line.startswith(groups) and f" {KERNEL_SHAPE['groups']} groups" in line for line in out.splitlines()):
        raise RuntimeError(f"groups does not list {groups}:\n{out}")
    phase("cli", f"groups: exit 0 in {wall:.2f} s, {len(out.splitlines())} structures listed")


def selfcheck_phase() -> int:
    """The port's accuracy gate at the production shape, as a user runs it;
    returns the two-body kernel's launches in its run."""
    out, wall = port_cli("selfcheck")
    report = json.loads(out.strip().splitlines()[-1])
    phase(
        "selfcheck",
        f"{report['device_name']} shape {json.dumps(report['shape'])}: two-body route {report['twobody_route']} "
        f"launches {report['twobody_kernel_launches']} on {report['twobody_subintervals']} subintervals, "
        f"max_abs {report['twobody_max_abs']:.3e} max_rel {report['twobody_max_rel']:.3e} "
        f"(gate 1e-8) in {report['twobody_seconds']:.3f} s",
    )
    for name in ("freegas", "continuum", "chi"):
        r = report[name]
        extra = f", small-a max_abs {r['small_aa_max_abs']:.3e}" if name == "continuum" else ""
        phase("selfcheck", f"{name}: ok={r['ok']} max_abs {r['max_abs']:.3e} "
              f"max_rel_significant {r['max_rel_significant']:.3e}{extra} in {r['seconds']:.3f} s, "
              f"peak device memory {r['peak_device_bytes']} B")
    phase("selfcheck", f"exit 0, ok={report['ok']}, process wall {wall:.2f} s")
    if not (report["ok"] and report["twobody_route"] == "cuda" and report["twobody_kernel_launches"] >= 1
            and report["twobody_max_rel"] <= 1e-8):
        raise RuntimeError(f"selfcheck failed: {report['failed']}")
    return report["twobody_kernel_launches"]


def twobody_deck(work: Path) -> int:
    names = write_fixtures(work / "lib")
    cfg = deck(work / "lib", names, work / "cuda.txt")
    phase("e2e", f"{len(names)} nuclides (h1, fe56, o16, stress {STRESS}), P{cfg.legendre_order}, {cfg.groups}, "
          f"e_tile {cfg.device.e_tile}, quad_points {cfg.device.quad_points}")
    _, launches, _ = run_on_card("e2e", cfg, len(names))
    check_library("e2e", cfg.output.path, work / "lib", names)
    compare_with_cpu("e2e", cfg, deck(work / "lib", names, work / "cpu.txt"))
    cli_phase(Path(cfg.output.path), names, cfg.groups)
    return launches


def continuum_deck(work: Path) -> int:
    lib = work / "contlib"
    names = write_fixtures(lib, CONTINUUM_FIXTURES, ())
    cfg = deck(lib, names, work / "cont_cuda.txt")
    phase("cont", f"{len(names)} nuclides ({', '.join(CONTINUUM_FIXTURES)}), P{cfg.legendre_order}, {cfg.groups}, "
          f"e_tile {cfg.device.e_tile}, quad_points {cfg.device.quad_points}")
    metrics, launches, _ = run_on_card("cont", cfg, len(names))
    phase("cont", "chunk (outer panels at a time) -> cm_moments_pointwise tiles: "
          + json.dumps({str(k): v for k, v in sorted(metrics.continuum_chunks.items())}))
    check_library("cont", cfg.output.path, lib, names)
    compare_with_cpu("cont", cfg, deck(lib, names, work / "cont_cpu.txt"))
    return launches


def thermal_deck(work: Path) -> int:
    lib = work / "thermlib"
    names = write_fixtures(lib, THERMAL_FIXTURES, (), THERMAL_TABLES)
    cfg = deck(lib, names, work / "therm_cuda.txt", **THERMAL_RUN)
    phase("therm", f"{len(names)} nuclides ({', '.join(THERMAL_FIXTURES)}) at {cfg.temperatures} K, free-gas on "
          f"every nuclide below {cfg.thermal_cutoff_kt:g} kT, sab {json.dumps(THERMAL_SAB)}, P{cfg.legendre_order}, "
          f"{cfg.groups}, e_tile {cfg.device.e_tile}, quad_points {cfg.device.quad_points}")
    _, launches, _ = run_on_card("therm", cfg, len(names))
    check_library("therm", cfg.output.path, lib, names)
    compare_with_cpu("therm", cfg, deck(lib, names, work / "therm_cpu.txt", **THERMAL_RUN))
    return launches


def shard_devices() -> tuple[list[str], str]:
    """Two shards: on two cards where the machine has them, else both on
    cuda:0, each with its own stream."""
    import torch

    if torch.cuda.device_count() >= 2:
        return ["cuda:0", "cuda:1"], "two cards"
    return ["cuda:0", "cuda:0"], "one card, two streams"


def shards_phase(work: Path) -> int:
    """The mixed deck (every family) through driver.run on one shard and on
    two; the libraries agree at SHARD_RTOL / SHARD_ATOL and the kernel runs
    on both shards. Returns the launches of both runs."""
    from ndpp_tpu_torch.io.library import compare
    from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments
    from ndpp_tpu_torch.parallel.rows import Placement

    lib = work / "shardlib"
    names = write_fixtures(lib, SHARD_FIXTURES, (), ("lwtr",))
    devices, where = shard_devices()
    place = Placement(devices)
    phase("shards", f"{len(names)} nuclides ({', '.join(SHARD_FIXTURES)}) at {SHARD_RUN['temperatures']} K, free-gas "
          f"on, sab {json.dumps(SHARD_RUN['sab'])}, P{KERNEL_SHAPE['order']}, {KERNEL_SHAPE['groups']} groups; "
          f"two shards on {where}: {devices}")
    paths, total = {}, 0
    for tag, device in (("one shard", "cuda:0"), ("two shards", place)):
        cfg = deck(lib, names, work / f"shards_{len(paths) + 1}.txt", **SHARD_RUN)
        twobody_group_moments.launches_by_stream.clear()
        _, launches, wall = run_on_card("shards", cfg, len(names), device)
        by_stream = dict(twobody_group_moments.launches_by_stream)
        total += launches
        paths[tag] = cfg.output.path
        phase("shards", f"{tag}: wall {wall:.3f} s, kernel launches {launches}")
    per_shard = [by_stream.get(st.cuda_stream, 0) for st in place.streams]
    phase("shards", f"two shards: kernel launches per shard {per_shard} (streams of {devices})")
    if min(per_shard) <= 0:
        raise RuntimeError(f"a shard never launched the two-body kernel: {per_shard}")
    check_library("shards", paths["two shards"], lib, names)
    report = compare(paths["two shards"], paths["one shard"], rtol=SHARD_RTOL, atol=SHARD_ATOL)
    worst = max((v["max_abs"] for v in report["datasets"].values()), default=0.0)
    phase("shards", f"two shards vs one: match={report['match']} (rtol {SHARD_RTOL:g}, atol {SHARD_ATOL:g}) over "
          f"{len(report['datasets'])} datasets, max_abs={worst:.3e}")
    if not report["match"]:
        failing = {k: v for k, v in report["datasets"].items() if not v.get("ok", False)}
        raise RuntimeError(f"the two-shard library differs from the one-shard library: {failing}")
    return total


def mesh_phase() -> int:
    """sharded_twobody_moments on a 1 x 2 mesh at the bench shape (every fe56
    two-body reaction a block of 512 rows: 2048 rows, P5, 361 groups, nq 16)
    against one-device twobody_moments at SHARD_RTOL / SHARD_ATOL. Returns
    the kernel's launches of the sharded call."""
    import numpy as np
    import torch

    from ndpp_tpu_torch import groups
    from ndpp_tpu_torch.host import unionize
    from ndpp_tpu_torch.ops.twobody import twobody_moments
    from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments
    from ndpp_tpu_torch.parallel.mesh import auto_mesh, place_batch, sharded_twobody_moments

    preps, k = fe56_preps()
    n, t = 4, KERNEL_SHAPE["rows"] // 4
    take = np.arange(t)
    e = np.stack([preps[i % len(preps)].e[take % preps[i % len(preps)].e.size] for i in range(n)])
    knots, pdf = (
        np.stack([unionize.pad_to(getattr(preps[i % len(preps)], f), k, axis=1)[take % preps[i % len(preps)].e.size]
                  for i in range(n)])
        for f in ("knots", "pdf")
    )
    c1, c2, awr = (np.array([getattr(preps[i % len(preps)], f) for i in range(n)]) for f in ("c1", "c2", "awr"))
    bounds = groups.get(f"uniform-lethargy-{KERNEL_SHAPE['groups']}").bounds
    order, nq = KERNEL_SHAPE["order"], KERNEL_SHAPE["nq"]
    devices, where = shard_devices()
    mesh = auto_mesh(devices, n_nuclide=1)
    placed = place_batch(mesh, {"e": e, "knots": knots, "pdf": pdf, "c1": c1, "c2": c2, "awr": awr})
    twobody_group_moments.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sharded_twobody_moments(mesh, placed["e"], placed["knots"], placed["pdf"], bounds, placed["c1"],
                                  placed["c2"], placed["awr"], order, nq)
    wall = time.perf_counter() - t0
    launches = twobody_group_moments.launches
    dev = torch.device(devices[0])
    rows = [torch.as_tensor(np.ascontiguousarray(x), device=dev) for x in
            (e.reshape(-1), knots.reshape(n * t, k), pdf.reshape(n * t, k), bounds,
             np.repeat(c1, t), np.repeat(c2, t), np.repeat(awr, t))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = twobody_moments(*rows, order, nq).cpu().reshape(got.shape)
    one_wall = time.perf_counter() - t0
    err = (got - one).abs()
    bad = int((err > SHARD_ATOL + SHARD_RTOL * one.abs()).sum())
    phase("mesh", f"sharded_twobody_moments on a {mesh.shape} mesh over {where} {devices}: ({n}, {t}) rows -> "
          f"{tuple(got.shape)}, kernel launches {launches}, wall {wall:.4f} s (one device {one_wall:.4f} s), "
          f"max_abs={float(err.max()):.3e}, outside(|s-o| <= {SHARD_ATOL:g} + {SHARD_RTOL:g}|o|)={bad}")
    if bad or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"the mesh's two-body moments differ from one device's on {bad} elements")
    if launches < mesh.place.nd:
        raise RuntimeError(f"the mesh launched the two-body kernel {launches} times for {mesh.place.nd} cells")
    return launches


def scale_phase(work: Path, smi: str) -> int:
    """scripts/torch_scale_demo.py at SCALE_NUCLIDES nuclides as a user runs
    it: exit 0, both passes' SCALE lines, nothing quarantined. Returns the
    kernel's launches over both passes."""
    cmd = [sys.executable, str(ROOT / "scripts" / "torch_scale_demo.py"), "--nuclides", str(SCALE_NUCLIDES),
           "--workdir", str(work / "scale")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=ROOT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"torch_scale_demo.py exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    rows = [json.loads(line[len("SCALE "):]) for line in proc.stdout.splitlines() if line.startswith("SCALE ")]
    for r in rows:
        phase("scale", f"{r['pass']}: {r['nuclides_done']} nuclides, {r['moments']} moments in {r['wall_s']:.3f} s = "
              f"{r['moments_per_sec']:.4e} moments/s, quarantined {r['quarantined']}, kernel launches "
              f"{r['kernel_launches']}, write {r['phase_seconds'].get('write', 0.0):.3f} s on {smi}")
    if [r["pass"] for r in rows] != ["cold", "warm"] or any(r["quarantined"] or r["kernel_launches"] <= 0 for r in rows):
        raise RuntimeError(f"torch_scale_demo.py: passes {rows}")
    phase("scale", f"exit 0 in {wall:.2f} s (the library build and both passes)")
    return sum(r["kernel_launches"] for r in rows)


def main() -> int:
    import torch

    t_start = time.perf_counter()
    smi = environment()
    build_s = build()
    kern = kernel_vs_plain(smi)
    with tempfile.TemporaryDirectory(prefix="ndpp_chip_smoke_") as work:
        by_deck = {
            "twobody": twobody_deck(Path(work)),
            "continuum": continuum_deck(Path(work)),
            "thermal": thermal_deck(Path(work)),
        }
        by_deck["shards"] = shards_phase(Path(work))
        by_deck["mesh"] = mesh_phase()
        by_deck["scale"] = scale_phase(Path(work), smi)
    by_deck["selfcheck"] = selfcheck_phase()
    phase("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "twobody_group_moments",
        "route": "cuda",
        "source": "ndpp_tpu_torch/csrc/twobody_inner.cu",
        "replaces": "ndpp_tpu/ops/twobody_pallas_dd.py:120",
        "launches": sum(by_deck.values()),  # each deck (and selfcheck's process) counted from 0
        "launches_by_deck": by_deck,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        # ms, plain_ms, epilogue_ms: device time per call from graph replays
        # (time_turns); eager_ms: CUDA events around one eager call (time_eager)
        "timing": "cuda_graph_replay_x20_l2_warm",
        "eager_ms": kern["eager_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,  # no single PyTorch call computes these group moments
        "epilogue_ms": kern["epilogue_ms"],
        "build_s": build_s,
        "shape": kern["shape"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
