"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It imports only the port (ndpp_tpu_torch),
never jax or the reference package, and proves in one process that:

  1. environment: a CUDA card is present (else it exits non-zero and prints
     no result); prints the card's name and power limit, torch/CUDA/nvcc;
  2. build: the three hand-written kernels (ndpp_tpu_torch/csrc/
     twobody_inner.cu, freegas_sab.cu, cm_pointwise.cu) build with nvcc for
     sm_90a from the checkout's sources, one library a kernel (the lane
     groups G = 1, 2, 4, 8 of the other two are template instances in it),
     three nvcc processes started together; each library's seconds, instance
     count, register range and spill bytes are printed, and ptxas's
     registers, stack and spills (with the warps per SM the registers allow)
     for every two-body instance and the P5 instances of the others;
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
  3b. free-gas kernel vs plain ([fgk] lines): one freegas_moments_sab
     call at the thermal deck's shape (256 rows of h1's grid below 400 kT at
     293.6 K, P5, the driver's covering window with its catch group) on the
     card, and one at the decks' own tile size (7 rows): the density kernel
     (sab_density) against its plain torch version on the same y-panels,
     and the op's (T, L+1, G) result through the kernel against the same op
     through the plain density, each within |k - p| <= 1e-12 max_row |p|;
     kernel and plain version timed in turns by CUDA-graph replays, beside
     their bound, with the lanes per y-node G, the instance's registers and
     the instruction floor (live nodes times the FP64-pipe instructions per
     node of the compiled node loops, read from cuobjdump -sass, over the
     FP64 pipe's issue rate);
  3c. CM-continuum kernel vs plain ([cmk] lines): cm_inner_moments on one
     tile each of the kalbach, law61cm (tabular angles, cross_edges) and
     nbody preparations, 256 rows each and 16 rows each (the decks' tile
     size) as the continuum driver prepares them (its quadrature and group
     split, dense table), against cm_inner_moments_ref within the
     same bound, with the tile's lanes, registers and shared memory path;
     timed, bounded and floored the same way; and two untimed check tiles
     (200 mu knots; row tables read through L2);
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

Every deck counts each kernel's launches from 0: the two-body kernel must
launch on every deck, the free-gas kernel on the thermal, shards, scale and
selfcheck runs, the continuum kernel on the continuum, shards, scale and
selfcheck runs.

The line before the last is a JSON object describing each kernel of the
path; the last line is {"ok": true, "device": {...}}. Any failed phase
raises, which exits non-zero before either line is printed.
"""

from __future__ import annotations

import functools
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
FREEGAS_ROWS, FREEGAS_TEMP = 256, 293.6  # the thermal deck's free-gas tile: h1's rows at 293.6 K
CM_ROWS = 256  # rows of each CM-continuum tile (the continuum driver's tile)
# the decks' own tiles (torch_profile_deck.py --plan: free-gas calls of 7-239
# rows, CM calls of 1-15 rows), timed beside the 256-row ones
FREEGAS_DECK_ROWS, CM_DECK_ROWS = 7, 16
CM_FIXTURES = {"kalbach": ("kalbach", "tabular"), "law61cm": ("tabular", "tabular"), "nbody": ("isotropic", "nbody")}
HAND_RTOL = 1e-12  # the new kernels vs plain: |k - p| <= HAND_RTOL * max over the row of |p|
# Which kernel each deck must launch (every deck launches the two-body kernel)
NEEDS = {"sab_density": ("thermal", "shards", "scale", "selfcheck"),
         "cm_inner_moments": ("continuum", "shards", "scale", "selfcheck")}
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
    from ndpp_tpu_torch.utils.build import nvcc

    pkg = Path(ndpp_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise SystemExit(f"chip_smoke: ndpp_tpu_torch imported from {pkg}, not from this checkout")
    version = subprocess.run([nvcc(), "--version"], capture_output=True, text=True, timeout=60, check=True)
    print(smi, flush=True)  # name, power limit (nvidia-smi csv)
    phase("env", f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    phase("env", f"nvcc: {version.stdout.strip().splitlines()[-1]}")
    phase("env", f"device 0: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    return smi


def ptxas_instances(path: Path) -> list[dict]:
    """Each kernel instance of a library's ptxas report (build_cuda keeps it
    beside the library): kernel name, template arguments, registers, stack
    frame and spill bytes."""
    import re

    from ndpp_tpu_torch.utils.build import ptxas_report

    out, own = [], False
    for line in ptxas_report(path).read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S*?(twobody_group_kernel|freegas_sab_kernel|cm_inner_kernel)"
                          r"I(.*?)EEv\S*)'", line)
        props = re.search(r"Function properties for (\S+)", line)
        if entry:  # template arguments: two-body <L, nq>, free-gas <L, G>, continuum <angular, nbody, window, LB, G>
            out.append({"kernel": entry.group(2), "args": [int(a) for a in re.findall(r"L[ib](\d+)E", entry.group(3))],
                        "registers": None, "stack": 0, "spill_bytes": 0, "mangled": entry.group(1)})
        elif props:  # the entry's own frame, or a subroutine's (its spills count too)
            own = bool(out) and props.group(1) == out[-1]["mangled"]
        elif out and "spill" in line:
            nums = [int(n) for n in re.findall(r"(\d+) bytes", line)]
            if own:
                out[-1]["stack"] = nums[0]
            out[-1]["spill_bytes"] += sum(nums[1:])
        elif out and "Used" in line:
            out[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def resident_warps(registers: int, threads: int = 128) -> int:
    """Warps of `threads`-thread blocks an H100 SM holds at this register count
    (registers are allocated 8 a thread at a time; 64 warps at most)."""
    per_thread = -(-registers // 8) * 8
    return min(65536 // (per_thread * threads), 2048 // threads) * threads // 32


def build() -> dict:
    """Build the three kernel libraries, one nvcc each, all started together;
    load them. Prints each library's seconds and ptxas's registers and spills
    (every instance of the two-body kernel, a summary and the P5 instances
    of the others). Returns {"wall_s", kernel: seconds, "libraries": {kernel:
    path}}."""
    from concurrent.futures import ThreadPoolExecutor

    from ndpp_tpu_torch.ops import continuum as cont_ops
    from ndpp_tpu_torch.ops import freegas as fg_ops
    from ndpp_tpu_torch.ops import twobody_inner as inner_mod
    from ndpp_tpu_torch.utils.build import build_cuda

    t0 = time.perf_counter()
    libs = {"twobody_group_moments": (inner_mod._SRC, inner_mod._NVCC_FLAGS),
            "sab_density": (fg_ops._SRC,), "cm_inner_moments": (cont_ops._SRC,)}
    with ThreadPoolExecutor(len(libs)) as ex:
        futures = {key: ex.submit(build_cuda, *args) for key, args in libs.items()}
        built = {key: f.result() for key, f in futures.items()}
    wall = time.perf_counter() - t0
    inner_mod.library()
    fg_ops._sab_library()
    cont_ops._cm_library()
    for kernel, (path, secs) in built.items():
        inst = ptxas_instances(path)
        spills = sum(i["spill_bytes"] for i in inst)
        regs = [i["registers"] for i in inst]
        phase("build", f"{kernel}: {path.relative_to(ROOT)} built in {secs:.2f} s, {len(inst)} instances, "
              f"registers {min(regs)}-{max(regs)}, spill bytes {spills} in all")
        for i in inst:
            hot = (i["kernel"] == "twobody_group_kernel" or (i["kernel"] == "freegas_sab_kernel" and i["args"][0] == 5)
                   or (i["kernel"] == "cm_inner_kernel" and i["args"][3] == 5))
            if hot or i["spill_bytes"]:
                phase("build", f"ptxas {i['kernel']}<{','.join(map(str, i['args']))}>: {i['registers']} registers "
                      f"({resident_warps(i['registers'])} warps per SM by registers), stack {i['stack']} B, "
                      f"spills {i['spill_bytes']} B")
    phase("build", f"{len(built)} nvcc processes in parallel: wall {wall:.2f} s")
    return {"wall_s": wall, **{k: secs for k, (_, secs) in built.items()},
            "libraries": {k: path for k, (path, _) in built.items()}}


FP64_OPS = ("DFMA", "DADD", "DMUL", "DMNMX", "DSETP")  # the FP64 pipe's instructions
FP64_INSTR_PER_S = 132 * 64 * 1.98e9  # H100 SXM: 64 FP64 lanes per SM, 132 SMs, 1.98 GHz boost clock


def cuobjdump() -> str | None:
    """The toolkit's cuobjdump (beside nvcc), else triton's copy, else None."""
    import shutil

    from ndpp_tpu_torch.utils.build import nvcc

    here = Path(nvcc()).parent / "cuobjdump"
    if here.exists():
        return str(here)
    try:
        import triton

        alt = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
        if alt.exists():
            return str(alt)
    except ImportError:
        pass
    return shutil.which("cuobjdump")


def sass_loops(path: Path, kernel: str, args: list[int]) -> list[dict] | None:
    """The innermost loops of one kernel instance in `cuobjdump -sass` of its
    library, most FP64-pipe instructions first: per loop the FP64_OPS
    instructions of one iteration ("fp64") and its MUFU.RSQ64H and
    MUFU.RCP64H ("rsq", "rcp"); None without cuobjdump. A loop runs from the
    target of a backward branch to that branch; innermost loops hold no
    other. Instructions of called subroutines (the slow paths of divisions
    and square roots, a pow that is not inlined) are not counted."""
    tool = cuobjdump()
    if tool is None:
        return None
    return sass_text_loops(sass_text(tool, path), kernel, args)


@functools.lru_cache(maxsize=4)
def sass_text(tool: str, path: Path) -> str:
    """`cuobjdump -sass` of a library, dumped once per library."""
    return subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, timeout=300, check=True).stdout


def sass_text_loops(text: str, kernel: str, args: list[int]) -> list[dict]:
    """sass_loops on the text of `cuobjdump -sass`."""
    import re

    want = "I" + "".join(f"L{'b' if kernel == 'cm_inner_kernel' and k in (1, 2) else 'i'}{a}E"
                         for k, a in enumerate(args)) + "EEv"
    body, on = [], False
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            on = kernel in head.group(1) and want in head.group(1)
            continue
        if on:
            body.append(line)
    if not body:
        raise RuntimeError(f"no SASS for {kernel}<{args}>")
    label_at, pending, instrs = {}, [], []
    for line in body:
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins:
            addr = int(ins.group(1), 16)
            label_at.update({lab: addr for lab in pending})
            pending = []
            instrs.append((addr, re.sub(r"^@!?U?P\w+\s+", "", ins.group(2))))
    loops = []
    for addr, txt in instrs:
        br = re.match(r"BRA(?:\.\w+)*\s+(?:!?U?P\w+,\s*)?`?\(?(\.L_x_\d+|0x[0-9a-f]+)", txt)
        if br:
            target = label_at.get(br.group(1)) if br.group(1).startswith(".L") else int(br.group(1), 16)
            if target is not None and target < addr:  # backward; the self-branch that ends a function is no loop
                loops.append((target, addr))
    inner = [lp for lp in loops if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    out = []
    for lo, hi in inner:
        ops = [t.split()[0] for a, t in instrs if lo <= a <= hi]
        out.append({"fp64": sum(1 for o in ops if o.split(".")[0] in FP64_OPS),
                    "rsq": ops.count("MUFU.RSQ64H"), "rcp": ops.count("MUFU.RCP64H")})
    return sorted(out, key=lambda d: -d["fp64"])


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


def row_rel_err(k, p) -> float:
    """max |k - p| / max over the row of |p|, over every row (rows of p that
    are all 0 count in absolute terms)."""
    t = p.shape[0]
    scale = p.abs().reshape(t, -1).amax(dim=1).clamp_min(1e-300).reshape((t,) + (1,) * (p.dim() - 1))
    return float(((k - p).abs() / scale).max())


def freegas_inputs(device, n_rows: int = FREEGAS_ROWS):
    """The thermal deck's free-gas tile: n_rows of h1's moment-grid
    rows below the free-gas cutoff at FREEGAS_TEMP (log-evenly sampled where
    there are more), and the driver's covering window: the groups reachable
    from thermal energies in a power-of-two bucket, behind the catch group
    [0, bounds[0]). Returns (e, awr, kt, window)."""
    import numpy as np
    import torch

    from ndpp_tpu_torch import groups
    from ndpp_tpu_torch.config import BOLTZMANN_EV_PER_K, RunConfig
    from ndpp_tpu_torch.host import unionize
    from ndpp_tpu_torch.host.ace import synth

    nuc = synth.build("h1")
    kt = BOLTZMANN_EV_PER_K * FREEGAS_TEMP
    cutoff = RunConfig().thermal_cutoff_kt * kt
    e_grid = unionize.moment_grid(nuc.energy)
    rows = e_grid[e_grid < cutoff]
    e = rows[np.round(np.linspace(0, rows.size - 1, n_rows)).astype(int)]
    gs = groups.get(f"uniform-lethargy-{KERNEL_SHAPE['groups']}")
    gamma, beta, vmax = nuc.awr / (nuc.awr + 1.0), np.sqrt(nuc.awr / kt), np.sqrt(cutoff)
    e_reach = 1.5 * (vmax + 2.0 * gamma * (vmax + 8.0 / beta)) ** 2  # as freegas_driver.apply_freegas
    w = min(unionize.bucket_pow2(int(np.clip(np.searchsorted(gs.bounds, e_reach), 1, gs.ng))), gs.ng)
    window = np.concatenate([[0.0], gs.bounds[: w + 1]])
    return torch.as_tensor(e, device=device), nuc.awr, kt, torch.as_tensor(window, device=device)


def freegas_bound(pm, ph, v, awr, kt, order: int) -> tuple[float, str, dict]:
    """The least time the card could take for the free-gas density on these
    panels, the larger of two: bytes over the HBM rate, or f64 operations
    over the FP64 rate. Bytes: pmid and phalf (T, NP) and v, awr, kt (T,)
    read once, the (T, NP, NQ_G, L+1) result written once. Operations count
    the (y, u) GL nodes of the live u-panels (width > 0; the plain version's
    own edges on these inputs): per node 20 (the u node and its weight, the
    root and its square root, t, the floored division, the exponent and its
    exp, the weight's two products, mu and its clip, the P_0 sum; an FMA is 2,
    a min, max, square root, exp or division 1), 2 for P_1 and 6 for each
    Bonnet step after it. A y-node's edges, merge and scaling are left out,
    which can only lower the bound."""
    import torch

    from ndpp_tpu_torch.ops import freegas as fg
    from ndpp_tpu_torch.ops.legendre import gl_nodes_weights

    t, npan = pm.shape
    xg = torch.as_tensor(gl_nodes_weights(fg.NQ_G)[0], device=pm.device)
    ulad = torch.as_tensor(fg._SAB_ULAD, device=pm.device)
    live = table = 0
    for c0 in range(0, npan, 4):  # a few panels at a time: (T, 4 x NQ_G, 21) edges
        y = (pm[:, c0 : c0 + 4, None] + ph[:, c0 : c0 + 4, None] * xg).reshape(t, -1)
        edges = fg.sab_u_edges(y, v, awr, kt)[0]
        e0, e1 = edges[..., :-1], edges[..., 1:]
        alive = e1 > e0
        live += int(alive.sum())
        # the kernel's table panels: [ULAD[k], ULAD[k+1]], both edges the ladder's own values
        k = torch.searchsorted(ulad, e0).clamp_(max=ulad.numel() - 2)
        table += int((alive & (ulad[k] == e0) & (ulad[k + 1] == e1)).sum())
    nodes = live * fg.NQ_U
    per_node = 20 + (2 if order >= 1 else 0) + 6 * max(order - 1, 0)
    nbytes = 8 * (2 * t * npan + 3 * t + t * npan * fg.NQ_G * (order + 1))
    flops = nodes * per_node
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS_PER_S
    info = {"bytes": nbytes, "flops": flops, "live_u_panels": live, "table_u_panels": table,
            "u_panels": t * npan * fg.NQ_G * fg.U_PANELS, "nodes": nodes, "table_nodes": table * fg.NQ_U}
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", info


def instance(built: dict, kernel: str, args: list[int]) -> tuple[Path, dict]:
    """The library of `kernel` and its ptxas entry for the template arguments `args`."""
    path = built["libraries"][kernel]
    name = {"sab_density": "freegas_sab_kernel", "cm_inner_moments": "cm_inner_kernel"}[kernel]
    return path, next(i for i in ptxas_instances(path) if i["kernel"] == name and i["args"] == args)


def node_floor(path: Path, kernel: str, args: list[int], nodes: dict) -> dict:
    """The FP64-pipe instructions per node of the compiled node loops (SASS of
    the G = 1 instance, whose node loops run one node a lane at a time) and
    the least time the FP64 pipe takes to issue them for `nodes` ({loop:
    node count}; free-gas: "exp" and "table", the loops holding one rsqrt a
    node, the table's the cheaper; CM: "node", the innermost loop with the
    most FP64 instructions). {"sass": None} without cuobjdump."""
    try:
        loops = sass_loops(path, kernel, args)
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        return {"sass": None, "note": f"cuobjdump -sass failed: {exc}"}
    if loops is None:
        return {"sass": None, "note": "the toolkit has no cuobjdump"}
    if "table" in nodes:
        per = sorted((lp["fp64"] / lp["rsq"] for lp in loops if lp["rsq"]), reverse=True)
        per_node = {"exp": per[0], "table": per[-1]} if per else None
    else:
        per_node = {"node": loops[0]["fp64"]} if loops else None
    if per_node is None:
        return {"sass": None, "note": "no node loop found in the SASS", "innermost_loops": loops[:6]}
    instr = sum(nodes[k] * per_node[k] for k in nodes)
    return {"fp64_per_node": per_node, "innermost_loops": loops[:6], "nodes": nodes,
            "floor_ms": instr / FP64_INSTR_PER_S * 1e3}


def freegas_kernel_phase(smi: str, built: dict) -> dict:
    """The free-gas density kernel against its plain version at the thermal
    deck's 256-row shape, and the op through each; then on a deck-size tile
    of FREEGAS_DECK_ROWS rows; timings, lanes, registers, bound and
    instruction floor of each."""
    import torch

    from ndpp_tpu_torch.ops import freegas as fg

    dev = torch.device("cuda", 0)
    order = KERNEL_SHAPE["order"]
    res = {"tiles": {}, "lanes": {}}
    for label, n_rows in ((f"{FREEGAS_ROWS} rows", FREEGAS_ROWS), (f"{FREEGAS_DECK_ROWS} rows", FREEGAS_DECK_ROWS)):
        e, awr, kt, window = freegas_inputs(dev, n_rows)
        chunk = fg.chunk_for(e.shape[0])
        v = torch.sqrt(e).contiguous()
        a_r, k_r = fg._per_row(awr, e).contiguous(), fg._per_row(kt, e).contiguous()
        panels = {}

        def plain_op():
            def gvals(pm, ph):
                panels.update(pm=pm, ph=ph)
                return fg.sab_density_ref(pm, ph, v, a_r, k_r, order, chunk)

            return fg._outgoing_panelsplit(e, v, a_r, k_r, window, order, fg.NQ_G, fg.NFILL_Y, gvals)

        ref_op = plain_op()
        pm, ph = panels["pm"], panels["ph"]
        reset_counts()
        out_op = fg.freegas_moments_sab(e, awr, kt, window, order, chunk=chunk)
        dens = fg.sab_density(pm, ph, v, a_r, k_r, order)
        torch.cuda.synchronize()
        launches = fg.sab_density.launches
        g = next(iter(fg.sab_density.lane_groups))
        ref = fg.sab_density_ref(pm, ph, v, a_r, k_r, order, chunk)
        err_d, err_op = row_rel_err(dens, ref), row_rel_err(out_op, ref_op)
        path, ptx = instance(built, "sab_density", [order, g])
        phase("fgk", f"sab_density {label} T,NP={tuple(pm.shape)} -> {tuple(dens.shape)} L={order}, one launch of grid "
              f"({pm.shape[0]}, {-(-pm.shape[1] * fg.NQ_G * g // 128)}) x 128 threads, G = {g} lanes per y-node, "
              f"{ptx['registers']} registers ({resident_warps(ptx['registers'])} warps per SM), fixed-ladder table in "
              f"shared memory: max |k-p| / max_row|p| = {err_d:.3e}; freegas_moments_sab -> {tuple(out_op.shape)} "
              f"through the kernel vs through the plain density: {err_op:.3e} (limit {HAND_RTOL:g}); launches {launches}")
        if launches != 2 or not (err_d <= HAND_RTOL and err_op <= HAND_RTOL) or not bool(torch.isfinite(dens).all()):
            raise RuntimeError(f"the free-gas kernel disagrees with its plain version ({err_d:.3e}, {err_op:.3e}) "
                               f"or did not launch ({launches})")
        ms = time_turns({
            "kernel": lambda: fg.sab_density(pm, ph, v, a_r, k_r, order),
            "plain": lambda: fg.sab_density_ref(pm, ph, v, a_r, k_r, order, chunk),
        }, n=5, reps=3)
        bound_ms, bound_by, info = freegas_bound(pm, ph, v, a_r, k_r, order)
        floor = node_floor(path, "freegas_sab_kernel", [order, 1],
                           {"table": info["table_nodes"], "exp": info["nodes"] - info["table_nodes"]})
        phase("fgk", f"{label}: device time per call, median of 2 x 3 graph replays of 5 calls, in turns: kernel "
              f"{ms['kernel']:.5f} ms, plain torch {ms['plain']:.5f} ms "
              f"(chunk {chunk} of {fg.Y_PANELS} y-panels); bound {bound_ms:.5f} ms ({bound_by}: {json.dumps(info)}); "
              f"instruction floor {json.dumps(floor)} on {smi}")
        tile = {"shape": list(dens.shape), "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound_ms,
                "bound_by": bound_by, "lanes": g, "registers": ptx["registers"],
                "warps_per_sm": resident_warps(ptx["registers"]), "floor": floor,
                "max_abs_err": float((dens - ref).abs().max()), "max_rel_row_err": max(err_d, err_op)}
        res["tiles"][label] = tile
        res["lanes"][label] = g
    main = res["tiles"][f"{FREEGAS_ROWS} rows"]
    res.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape")})
    res["max_abs_err"] = max(t["max_abs_err"] for t in res["tiles"].values())
    res["max_rel_row_err"] = max(t["max_rel_row_err"] for t in res["tiles"].values())
    return res


def cm_tiles(device, n_rows: int = CM_ROWS) -> dict:
    """cm_inner_moments' operands for one n_rows-row tile of each
    preparation in CM_FIXTURES, as the continuum driver prepares a tile:
    the reaction's rows from one below its threshold (cycled up to n_rows),
    knot tables padded to their power-of-two bucket, the driver's ksel rung,
    its quadrature (continuum_driver.cm_quadrature; cross_edges for tabular
    angles) and group split (CM_GROUP_SPLIT), P5 on the dense 361-group
    table, and the plain path's chunk for a tile of this size. They are
    captured from cm_moments_pointwise's call of the wrapper, which the
    capture then stops (no launch). Returns {fixture: (args, chunk)}."""
    import numpy as np
    import torch

    from ndpp_tpu_torch import groups
    from ndpp_tpu_torch.continuum_driver import CM_GROUP_SPLIT, _window_knot_bound, cm_quadrature, quantize_ksel
    from ndpp_tpu_torch.host import unionize
    from ndpp_tpu_torch.host.ace import synth
    from ndpp_tpu_torch.host.prep_continuum import prepare_continuum
    from ndpp_tpu_torch.ops import continuum as cont_ops

    order = KERNEL_SHAPE["order"]
    gs = groups.get(f"uniform-lethargy-{KERNEL_SHAPE['groups']}")
    bounds = torch.as_tensor(gs.bounds, device=device)
    tiles = {}
    real = cont_ops.cm_inner_moments

    class Captured(Exception):
        pass

    def put(a, k=None):
        return None if a is None else torch.as_tensor(np.ascontiguousarray(a if k is None else unionize.pad_to(a, k, axis=1)), device=device)

    for fixture, (angular, energy) in CM_FIXTURES.items():
        nuc = synth.build(fixture)
        e_grid = unionize.moment_grid(nuc.energy)
        rxn = next(r for r in nuc.scattering_reactions(include_fission=False) if r.energy_dists)
        sig = np.interp(e_grid, nuc.energy, nuc.sigma_on_grid(rxn))
        rows = e_grid[max(int(np.nonzero(sig > 0)[0][0]) - 1, 0):]
        rows = rows[np.arange(n_rows) % rows.size]
        prep = prepare_continuum(nuc, rxn, rxn.energy_dists[0], rows, order)
        tab = angular == "tabular"
        nq_w, nq_y = cm_quadrature(angular, order)
        if energy == "nbody":
            k16, ksel = cont_ops.NBODY_KNOTS, 0
        else:
            k16 = unionize.bucket_pow2(prep.e_knots.shape[1])
            ksel = quantize_ksel(_window_knot_bound(prep.e, nuc.awr, prep.e_knots), k16)
        kmu = prep.mu_knots.size if tab else 0
        npan = cont_ops.outer_panel_count(k16, gs.ng, angular, kmu, CM_GROUP_SPLIT, tab)
        chunk = cont_ops.chunk_for(n_rows, nq_w, nq_y, cont_ops.inner_panel_count(k16, ksel, angular, kmu), npan)

        def capture(*args, chunk=None, key=fixture, lanes=None):
            tiles[key] = (args, chunk)
            raise Captured

        cont_ops.cm_inner_moments = capture
        try:
            kal, nb = angular == "kalbach", energy == "nbody"
            cont_ops.cm_moments_pointwise(
                put(prep.e), None if nb else put(prep.e_knots, k16), None if nb else put(prep.pdf, k16),
                put(prep.r_rows, k16) if kal else None, put(prep.a_rows, k16) if kal else None,
                put(prep.mu_knots) if tab else None, put(prep.mu_pdf, k16) if tab else None,
                put(prep.nbody_emax) if nb else None, float(prep.nbody_expo or 0.0), bounds, nuc.awr, order,
                nq_w, nq_y, angular, energy, True, chunk, ksel, CM_GROUP_SPLIT, tab,
            )
        except Captured:
            pass
        finally:
            cont_ops.cm_inner_moments = real
    return tiles


def cm_bound(args) -> tuple[float, str, dict]:
    """The least time the card could take for the CM inner integral on these
    operands, the larger of two: bytes over the HBM rate, or f64 operations
    over the FP64 rate. Bytes: the operands the variant reads (w, s, yk, the
    channel payload; e_knots, mu_knots and mu_pdf for tabular angles;
    nbody_emax and c_norm for N-body energies) read once, the (T, NW, L+1)
    result written once. Operations count the GL nodes of the live inner
    panels (width > 0, inside a non-empty window; the plain version's own
    edges on these operands): per node 8 (y, its weight, x, mu_lab and its
    clip), p_E (2 tabular, 5 N-body), p_mu (Kalbach 28: mu_cm, r, a, exp,
    expm1 and the two-exp form; tabular 24: mu_cm and the bilinear table;
    isotropic 0), 3 for the weight and the P_0 sum, 2 for P_1 and 6 for each
    Bonnet step after it (an FMA is 2, a min, max, square root, exp, pow or
    division 1). Panel set-up, lookups, making and merging the roots are left
    out, which can only lower the bound."""
    import torch

    from ndpp_tpu_torch.ops import continuum as cont_ops

    w, s, yk, e_knots, payload, mu_knots, mu_pdf, emax, c_norm, _, order, nq_y, angular, energy, ksel = args
    t, nw = w.shape
    ke = yk.shape[1]
    nsel = ksel if 0 < ksel < ke else ke
    live = 0
    for c0 in range(0, nw, 1024):
        edges, ok_w, _, _ = cont_ops.cm_inner_edges(w[:, c0 : c0 + 1024], s, yk, mu_knots, nsel)
        live += int(((edges[..., 1:] > edges[..., :-1]) & ok_w[..., None]).sum())
    read = [w, s, yk, payload, emax, c_norm] + ([e_knots, mu_knots, mu_pdf] if angular == "tabular" else [])
    nbytes = sum(x.numel() * 8 for x in read if x is not None) + t * nw * (order + 1) * 8
    per_node = (8 + (5 if energy == "nbody" else 2) + {"kalbach": 28, "tabular": 24, "isotropic": 0}[angular] + 3
                + (2 if order >= 1 else 0) + 6 * max(order - 1, 0))
    flops = live * nq_y * per_node
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS_PER_S
    info = {"bytes": nbytes, "flops": flops, "live_inner_panels": live, "outer_nodes": t * nw,
            "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3}
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", info


def cm_check_tile(device, t: int, nw: int, ke: int, kmu: int, seed: int):
    """Synthetic tabular-energy, tabular-angle operands of cm_inner_moments
    beyond what the fixtures reach: a light nucleus (A = 1, so s = sqrt(E)/2
    and the outer nodes w fall on both sides of s: the crossing roots' runs
    with and without a turning point), KMU mu knots with 0 among them, KE
    knots. Returns the operand tuple."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ek = np.sort(rng.uniform(0.05, 0.9, size=(t, ke)), axis=1)  # E'_cm knots, E = 1
    pdf = rng.uniform(0.2, 1.0, size=(t, ke))
    slope = np.diff(pdf, axis=1) / np.diff(ek, axis=1)
    payload = np.stack([pdf[:, :-1] - slope * ek[:, :-1], slope], axis=-1)  # p_E = a + b x per knot panel
    muk = np.unique(np.concatenate([[-1.0, 0.0, 1.0], rng.uniform(-1.0, 1.0, size=kmu - 3)]))
    assert muk.size == kmu
    s = np.full(t, 0.5)
    w = np.sort(rng.uniform(0.01, np.sqrt(0.9) + 0.5, size=(t, nw)), axis=1)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)  # noqa: E731
    return (put(w), put(s), put(np.sqrt(ek)), put(ek), put(payload), put(muk),
            put(rng.uniform(0.2, 1.0, size=(t, ke, kmu))), None, None, 0.0, KERNEL_SHAPE["order"], 8,
            "tabular", "tabular", 0)


def cm_kernel_phase(smi: str, built: dict) -> dict:
    """The CM inner kernel against its plain version on one captured tile of
    each CM preparation at CM_ROWS rows (timings and bound summed over these
    three tiles, as for the first kernel) and at the decks' CM_DECK_ROWS rows, each with
    its lanes, registers, bound and instruction floor; and, untimed, on two
    synthetic tiles beyond the fixtures (cm_check_tile)."""
    import torch

    from ndpp_tpu_torch.ops import continuum as cont_ops

    dev = torch.device("cuda", 0)

    def check(name, args, chunk, want_path=None):
        """One launch against the plain version; returns (kernel result, plain
        result, error, path, lanes, ptxas entry, library path)."""
        reset_counts()
        got = cont_ops.cm_inner_moments(*args)
        torch.cuda.synchronize()
        launches = cont_ops.cm_inner_moments.launches
        where = next(iter(cont_ops.cm_inner_moments.row_tables))
        g = next(iter(cont_ops.cm_inner_moments.lane_groups))
        ref = cont_ops.cm_inner_moments_ref(*args, chunk=chunk)
        err = row_rel_err(got, ref)
        w, yk, mu_knots = args[0], args[2], args[5]
        kmu = 0 if mu_knots is None else mu_knots.shape[0]
        order, angular, energy, ksel = args[10], args[12], args[13], args[14]
        targs = [cont_ops.ANGULAR.index(angular), int(energy == "nbody"), int(0 < ksel < yk.shape[1]),
                 cont_ops.cm_order_bucket(order), g]
        path, ptx = instance(built, "cm_inner_moments", targs)
        phase("cmk", f"cm_inner_moments {name} [{angular}, {energy}, ksel {ksel}] T,NW={tuple(w.shape)} "
              f"KE={yk.shape[1]} KMU={kmu} L={order} nq_y={args[11]}: one launch of grid ({w.shape[0]}, "
              f"{-(-w.shape[1] * g // 128)}) x 128 threads, G = {g} lanes per outer node, instance <"
              f"{','.join(map(str, targs))}> {ptx['registers']} registers ({resident_warps(ptx['registers'])} warps "
              f"per SM by registers), row tables read from {where} (the launch's report); "
              f"max |k-p| / max_row|p| = {err:.3e} (limit {HAND_RTOL:g}); launches {launches}")
        if launches != 1 or err > HAND_RTOL or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{name}: the CM kernel disagrees with its plain version ({err:.3e}) "
                               f"or did not launch ({launches})")
        if want_path is not None and where != want_path:
            raise RuntimeError(f"{name}: the row tables were read from {where}, not {want_path}")
        return got, ref, err, where, g, ptx, path, targs

    # beyond the fixtures, checked and not timed: 200 mu knots, with outer
    # nodes on both sides of s; row tables over 227 KB (KE 512 x KMU 64), read through L2
    check("kmu200", cm_check_tile(dev, 64, 512, 32, 200, seed=7), 64, "shared")
    check("l2_tables", cm_check_tile(dev, 16, 256, 512, 64, seed=8), 64, "l2")

    total = {"max_abs_err": 0.0, "max_rel_row_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
             "tiles": {}, "lanes": {}}
    bytes_ms = ops_ms = 0.0
    for n_rows in (CM_ROWS, CM_DECK_ROWS):
        for fixture, (args, chunk) in cm_tiles(dev, n_rows).items():
            name = f"{fixture}@{n_rows}"
            got, ref, err, where, g, ptx, path, targs = check(name, args, chunk)
            w = args[0]
            ms = time_turns({
                "kernel": lambda a=args: cont_ops.cm_inner_moments(*a),
                "plain": lambda a=args, c=chunk: cont_ops.cm_inner_moments_ref(*a, chunk=c),
            }, n=5, reps=3)
            bound_ms, bound_by, info = cm_bound(args)
            floor = node_floor(path, "cm_inner_kernel",
                               targs[:-1] + [1], {"node": info["live_inner_panels"] * args[11]})
            phase("cmk", f"{name}: device time per call, median of 2 x 3 graph replays of 5 calls, in turns: kernel "
                  f"{ms['kernel']:.5f} ms, plain torch "
                  f"{ms['plain']:.5f} ms (chunk {chunk} outer nodes); bound {bound_ms:.5f} ms ({bound_by}: "
                  f"{json.dumps(info)}); instruction floor {json.dumps(floor)} on {smi}")
            total["max_abs_err"] = max(total["max_abs_err"], float((got - ref).abs().max()))
            total["max_rel_row_err"] = max(total["max_rel_row_err"], err)
            if n_rows == CM_ROWS:
                total["ms"] += ms["kernel"]
                total["plain_ms"] += ms["plain"]
                total["bound_ms"] += bound_ms
                bytes_ms += info["bytes_ms"]
                ops_ms += info["ops_ms"]
            total["tiles"][name] = {"shape": list(w.shape), "ms": ms["kernel"], "plain_ms": ms["plain"],
                                    "bound_ms": bound_ms, "bound_by": bound_by, "row_tables": where, "lanes": g,
                                    "registers": ptx["registers"], "warps_per_sm": resident_warps(ptx["registers"]),
                                    "floor": floor}
            total["lanes"][name] = g
    # what bounds the three 256-row tiles together: their byte times summed against their operation times summed
    total["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return total


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


def kernel_wrappers() -> dict:
    """The wrapper of each hand-written kernel, by the name the kernels line
    gives it; each counts its own launches (`launches`, `launches_by_stream`)."""
    from ndpp_tpu_torch.ops.continuum import cm_inner_moments
    from ndpp_tpu_torch.ops.freegas import sab_density
    from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments

    return {"twobody_group_moments": twobody_group_moments, "sab_density": sab_density,
            "cm_inner_moments": cm_inner_moments}


def reset_counts() -> None:
    """Every kernel's launch counts to 0 (launches of the compare phases and
    of other decks do not count)."""
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
        fn.launches_by_stream.clear()
    wrappers["cm_inner_moments"].row_tables.clear()
    for name in ("sab_density", "cm_inner_moments"):
        wrappers[name].lane_groups.clear()


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def run_on_card(tag: str, cfg, n_nuclides: int, device="cuda"):
    """driver.run on the card (`device`: what driver.run takes) with every
    kernel's count set to 0 just before and read just after; raises on a
    quarantine or on a run that never launched the two-body kernel. Returns
    (metrics, launches by kernel, wall seconds)."""
    import torch

    from ndpp_tpu_torch import driver

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = driver.run(cfg, device=device)
    wall = time.perf_counter() - t0
    launches = read_counts()
    phase(
        tag,
        f"cuda: wall {wall:.3f} s, {metrics.moments_computed} moments, "
        f"{metrics.moments_computed / wall:.4e} moments/s, done {metrics.nuclides_done}, "
        f"quarantined {metrics.nuclides_quarantined}, kernel launches {json.dumps(launches)}, "
        f"max_memory_allocated {metrics.device_mem_highwater_bytes} B",
    )
    phase(tag, "cuda phase seconds: " + json.dumps({k: round(v, 4) for k, v in metrics.phase_seconds.items()}))
    if metrics.nuclides_quarantined or metrics.nuclides_done != n_nuclides:
        raise RuntimeError(f"{metrics.nuclides_quarantined} nuclide(s) quarantined on the card")
    if launches["twobody_group_moments"] <= 0:
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


def selfcheck_phase() -> dict:
    """The port's accuracy gate at the production shape, as a user runs it;
    returns each kernel's launches in its run."""
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
    launches = {"twobody_group_moments": report["twobody_kernel_launches"],
                "sab_density": report["sab_density_launches"], "cm_inner_moments": report["cm_inner_launches"]}
    phase("selfcheck", f"exit 0, ok={report['ok']}, process wall {wall:.2f} s, kernel launches {json.dumps(launches)}")
    if not (report["ok"] and report["twobody_route"] == "cuda" and report["twobody_kernel_launches"] >= 1
            and report["twobody_max_rel"] <= 1e-8):
        raise RuntimeError(f"selfcheck failed: {report['failed']}")
    return launches


def twobody_deck(work: Path) -> dict:
    names = write_fixtures(work / "lib")
    cfg = deck(work / "lib", names, work / "cuda.txt")
    phase("e2e", f"{len(names)} nuclides (h1, fe56, o16, stress {STRESS}), P{cfg.legendre_order}, {cfg.groups}, "
          f"e_tile {cfg.device.e_tile}, quad_points {cfg.device.quad_points}")
    _, launches, _ = run_on_card("e2e", cfg, len(names))
    check_library("e2e", cfg.output.path, work / "lib", names)
    compare_with_cpu("e2e", cfg, deck(work / "lib", names, work / "cpu.txt"))
    cli_phase(Path(cfg.output.path), names, cfg.groups)
    return launches


def continuum_deck(work: Path) -> dict:
    lib = work / "contlib"
    names = write_fixtures(lib, CONTINUUM_FIXTURES, ())
    cfg = deck(lib, names, work / "cont_cuda.txt")
    phase("cont", f"{len(names)} nuclides ({', '.join(CONTINUUM_FIXTURES)}), P{cfg.legendre_order}, {cfg.groups}, "
          f"e_tile {cfg.device.e_tile}, quad_points {cfg.device.quad_points}")
    metrics, launches, _ = run_on_card("cont", cfg, len(names))
    phase("cont", "chunk of the plain path (outer panels at a time) -> cm_moments_pointwise tiles: "
          + json.dumps({str(k): v for k, v in sorted(metrics.continuum_chunks.items())})
          + "; cm_inner_moments launches by where the row tables were read: "
          + json.dumps(dict(kernel_wrappers()["cm_inner_moments"].row_tables)))
    check_library("cont", cfg.output.path, lib, names)
    compare_with_cpu("cont", cfg, deck(lib, names, work / "cont_cpu.txt"))
    return launches


def thermal_deck(work: Path) -> dict:
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


def shards_phase(work: Path) -> dict:
    """The mixed deck (every family) through driver.run on one shard and on
    two; the libraries agree at SHARD_RTOL / SHARD_ATOL and the two-body
    kernel runs on both shards. Returns each kernel's launches of both runs."""
    from ndpp_tpu_torch.io.library import compare
    from ndpp_tpu_torch.parallel.rows import Placement

    lib = work / "shardlib"
    names = write_fixtures(lib, SHARD_FIXTURES, (), ("lwtr",))
    devices, where = shard_devices()
    place = Placement(devices)
    phase("shards", f"{len(names)} nuclides ({', '.join(SHARD_FIXTURES)}) at {SHARD_RUN['temperatures']} K, free-gas "
          f"on, sab {json.dumps(SHARD_RUN['sab'])}, P{KERNEL_SHAPE['order']}, {KERNEL_SHAPE['groups']} groups; "
          f"two shards on {where}: {devices}")
    paths, total = {}, {}
    for tag, device in (("one shard", "cuda:0"), ("two shards", place)):
        cfg = deck(lib, names, work / f"shards_{len(paths) + 1}.txt", **SHARD_RUN)
        _, launches, wall = run_on_card("shards", cfg, len(names), device)
        by_stream = {name: dict(fn.launches_by_stream) for name, fn in kernel_wrappers().items()}
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        paths[tag] = cfg.output.path
        phase("shards", f"{tag}: wall {wall:.3f} s, kernel launches {json.dumps(launches)}")
    per_shard = {name: [st.get(s.cuda_stream, 0) for s in place.streams] for name, st in by_stream.items()}
    phase("shards", f"two shards: kernel launches per shard {json.dumps(per_shard)} (streams of {devices})")
    if min(per_shard["twobody_group_moments"]) <= 0:
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


def mesh_phase() -> dict:
    """sharded_twobody_moments on a 1 x 2 mesh at the bench shape (every fe56
    two-body reaction a block of 512 rows: 2048 rows, P5, 361 groups, nq 16)
    against one-device twobody_moments at SHARD_RTOL / SHARD_ATOL. Returns
    the kernel's launches of the sharded call."""
    import numpy as np
    import torch

    from ndpp_tpu_torch import groups
    from ndpp_tpu_torch.host import unionize
    from ndpp_tpu_torch.ops.twobody import twobody_moments
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
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sharded_twobody_moments(mesh, placed["e"], placed["knots"], placed["pdf"], bounds, placed["c1"],
                                  placed["c2"], placed["awr"], order, nq)
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["twobody_group_moments"]
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
    return counts


def scale_phase(work: Path, smi: str) -> dict:
    """scripts/torch_scale_demo.py at SCALE_NUCLIDES nuclides as a user runs
    it: exit 0, both passes' SCALE lines, nothing quarantined. Returns each
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
              f"{r['moments_per_sec']:.4e} moments/s, quarantined {r['quarantined']}, kernel launches: two-body "
              f"{r['kernel_launches']}, free-gas {r['sab_density_launches']}, continuum {r['cm_inner_launches']}, "
              f"write {r['phase_seconds'].get('write', 0.0):.3f} s on {smi}")
    if [r["pass"] for r in rows] != ["cold", "warm"] or any(r["quarantined"] or r["kernel_launches"] <= 0 for r in rows):
        raise RuntimeError(f"torch_scale_demo.py: passes {rows}")
    phase("scale", f"exit 0 in {wall:.2f} s (the library build and both passes)")
    return {"twobody_group_moments": sum(r["kernel_launches"] for r in rows),
            "sab_density": sum(r["sab_density_launches"] for r in rows),
            "cm_inner_moments": sum(r["cm_inner_launches"] for r in rows)}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    smi = environment()
    build_s = build()
    kern = kernel_vs_plain(smi)
    fgk = freegas_kernel_phase(smi, build_s)
    cmk = cm_kernel_phase(smi, build_s)
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
    # launches by kernel, then by deck (each deck, and selfcheck's process, counted from 0)
    launches = {name: {d: counts[name] for d, counts in by_deck.items()} for name in kernel_wrappers()}
    for name, decks in NEEDS.items():
        idle = [d for d in decks if launches[name][d] <= 0]
        if idle:
            raise RuntimeError(f"{name} never launched on {idle}: {launches[name]}")
    phase("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s; launches by deck {json.dumps(launches)}")
    print(json.dumps({"kernels": [{
        "name": "twobody_group_moments",
        "route": "cuda",
        "source": "ndpp_tpu_torch/csrc/twobody_inner.cu",
        "replaces": "ndpp_tpu/ops/twobody_pallas_dd.py:120",
        "launches": sum(launches["twobody_group_moments"].values()),
        "launches_by_deck": launches["twobody_group_moments"],
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
        "build_s": build_s["twobody_group_moments"],
        "shape": kern["shape"],
    }, {
        "name": "sab_density",
        "route": "cuda",
        "source": "ndpp_tpu_torch/csrc/freegas_sab.cu",
        "replaces": "ndpp_tpu/ops/freegas.py:580",  # _sab_dens, an XLA-level function (no Pallas body)
        "launches": sum(launches["sab_density"].values()),
        "launches_by_deck": launches["sab_density"],
        "max_abs_err": fgk["max_abs_err"],
        "max_rel_row_err": fgk["max_rel_row_err"],
        "ms": fgk["ms"],
        "timing": "cuda_graph_replay_x5_l2_warm",
        "plain_ms": fgk["plain_ms"],
        "bound_ms": fgk["bound_ms"],
        "bound_by": fgk["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the free-gas density
        "build_s": build_s["sab_density"],
        "shape": fgk["shape"],
        "lanes": fgk["lanes"],  # G by tile
        "tiles": fgk["tiles"],
    }, {
        "name": "cm_inner_moments",
        "route": "cuda",
        "source": "ndpp_tpu_torch/csrc/cm_pointwise.cu",
        "replaces": "ndpp_tpu/ops/continuum.py:343",  # cm_moments_pointwise's chunk body (XLA-level, no Pallas body)
        "launches": sum(launches["cm_inner_moments"].values()),
        "launches_by_deck": launches["cm_inner_moments"],
        "max_abs_err": cmk["max_abs_err"],
        "max_rel_row_err": cmk["max_rel_row_err"],
        "ms": cmk["ms"],  # ms, plain_ms, bound_ms: sums over the kalbach, law61cm and nbody tiles
        "timing": "cuda_graph_replay_x5_l2_warm",
        "plain_ms": cmk["plain_ms"],
        "bound_ms": cmk["bound_ms"],
        "bound_by": cmk["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the CM inner integral
        "build_s": build_s["cm_inner_moments"],
        "tiles": cmk["tiles"],
        "lanes": cmk["lanes"],  # G by tile
    }], "build_wall_s": build_s["wall_s"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
