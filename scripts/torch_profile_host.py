#!/usr/bin/env python
"""Where the host's time goes in the port's dispatch (counterpart of scripts/profile_host.py).

    python3 scripts/torch_profile_host.py {twobody,continuum,thermal} [--device cuda] [--top 25] [--out FILE]
    python3 scripts/torch_profile_host.py --workdir build/torch_scale [--nuclides NAME ...]

Runs one of chip_smoke.py's decks (P5 / uniform-lethargy-361; thermal: h1,
o16, fe56, u235 and h1_iso at 293.6 K and 600 K with free-gas on, lwtr on h1
and grph on o16), or nuclides of a library that scripts/torch_scale_demo.py
built, four times in one process:

  cold:   the first pass, which pays each torch op's first use and the CUDA
          kernel's load;
  warm:   the same deck again, each family's device ops wrapped by a host
          clock (the time to enqueue them);
  ops:    again, each op call under a cProfile of its family's own;
  whole:  again, the whole pass under one cProfile for the top functions, as
          the reference's script prints them (Python runs one profiler at a
          time, hence two profiled passes).

It prints, per pass, the driver's phase seconds and how many memory
segments the caching allocator asked the card for (cudaMalloc; 0 in a warm
pass means the allocator no longer grows); per family, the warm host time of
its dispatch span, of its op calls and their count, the cold-minus-warm
difference (first use), and the split of the op calls' own time in the ops
pass between torch's C calls (launches and host-side tensor work) and
Python frames. It ends with one JSON line of those numbers (also written to
--out) with the card's name and power limit. cProfile slows Python frames
more than C calls, so the profiled split overstates Python.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (fixtures and decks)

# family -> (driver module, op names the module calls)
OPS = {
    "twobody": ("driver", ("twobody_moments",)),
    "continuum": ("continuum_driver", ("cm_moments_pointwise", "lab_tabular_moments", "analytic_group_fractions",
                                       "discrete_lines_moments")),
    "chi": ("chi_driver", ("tabular_group_fractions", "analytic_group_fractions")),
    "freegas": ("freegas_driver", ("freegas_moments_sab",)),
    "sab": ("thermal_driver", ("thermal_continuous_moments", "thermal_discrete_moments", "coherent_elastic_moments",
                               "incoherent_elastic_placement")),
}


def make_deck(args, work: Path):
    """A RunConfig factory (by pass name) for the chosen deck."""
    if args.workdir:
        from ndpp_tpu_torch.config import RunConfig

        xsdir = Path(args.workdir) / "xsdir"
        if not xsdir.exists():
            raise SystemExit(f"{xsdir} missing: run scripts/torch_scale_demo.py first to build the library")
        names = args.nuclides or ["1001.80c", "26056.80c", "92235.80c"]

        def cfg_for(tag):
            cfg = RunConfig(nuclides=list(names), library=str(xsdir), groups="uniform-lethargy-361", legendre_order=5,
                            temperatures=[293.6, 600.0], sab={"1001.80c": ["lwtr.20t"]})
            cfg.output.path = str(work / f"profile_{tag}.txt")
            cfg.output.format = "ascii"
            cfg.validate()
            return cfg

        return cfg_for
    lib = work / "lib"
    if args.deck == "twobody":
        names, run = chip_smoke.write_fixtures(lib), {}
    elif args.deck == "continuum":
        names, run = chip_smoke.write_fixtures(lib, chip_smoke.CONTINUUM_FIXTURES, ()), {}
    else:
        names = chip_smoke.write_fixtures(lib, chip_smoke.THERMAL_FIXTURES, (), chip_smoke.THERMAL_TABLES)
        run = chip_smoke.THERMAL_RUN
    return lambda tag: chip_smoke.deck(lib, names, work / f"{tag}.txt", **run)


class OpClock:
    """Wraps every family's ops where its driver calls them: counts calls and
    sums their host time; with `profile`, runs each call under a cProfile of
    the family's own."""

    def __init__(self):
        import importlib

        self.mods = {fam: importlib.import_module(f"ndpp_tpu_torch.{mod}") for fam, (mod, _) in OPS.items()}
        self.saved = []
        self.calls: dict[str, int] = defaultdict(int)
        self.seconds: dict[str, float] = defaultdict(float)
        self.profiles: dict[str, cProfile.Profile] = {}

    def install(self, profile: bool) -> None:
        self.calls.clear()
        self.seconds.clear()
        self.profiles = {fam: cProfile.Profile() for fam in OPS} if profile else {}
        for fam, (_, names) in OPS.items():
            mod = self.mods[fam]
            for name in names:
                fn = getattr(mod, name)
                self.saved.append((mod, name, fn))
                setattr(mod, name, self._wrap(fam, fn))

    def remove(self) -> None:
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.saved.clear()

    def _wrap(self, fam, fn):
        def timed(*a, **kw):
            prof = self.profiles.get(fam)
            t0 = time.perf_counter()
            if prof is not None:
                prof.enable()
            try:
                return fn(*a, **kw)
            finally:
                if prof is not None:
                    prof.disable()
                self.seconds[fam] += time.perf_counter() - t0
                self.calls[fam] += 1

        return timed


def split_self_time(prof: cProfile.Profile) -> dict:
    """Own time of the profiled calls: C functions (torch's ops and launches,
    filename '~' in pstats) against Python frames."""
    st = pstats.Stats(prof)
    c_s = py_s = 0.0
    for (filename, _, _), (_, _, tottime, _, _) in st.stats.items():
        if filename == "~":
            c_s += tottime
        else:
            py_s += tottime
    return {"c_calls_s": c_s, "python_s": py_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("deck", nargs="?", default="thermal", choices=["twobody", "continuum", "thermal"])
    ap.add_argument("--workdir", default=None, help="a torch_scale_demo.py library instead of a chip_smoke deck")
    ap.add_argument("--nuclides", nargs="+", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from ndpp_tpu_torch import driver
    from ndpp_tpu_torch.utils import log as log_mod

    cuda = args.device.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        raise SystemExit("torch_profile_host: no CUDA device (use --device cpu)")
    smi = "cpu"
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log_mod.setup(level=30)
    clock = OpClock()
    passes = {}
    whole = cProfile.Profile()
    with tempfile.TemporaryDirectory(prefix="ndpp_profile_host_") as tmp:
        cfg_for = make_deck(args, Path(tmp))
        for which in ("cold", "warm", "ops", "whole"):
            if which in ("warm", "ops"):
                clock.install(profile=which == "ops")
            segs = torch.cuda.memory_stats().get("segment.all.allocated", 0) if cuda else 0
            t0 = time.perf_counter()
            if which == "whole":
                whole.enable()
            m = driver.run(cfg_for(which), device=args.device)
            if which == "whole":
                whole.disable()
            wall = time.perf_counter() - t0
            clock.remove()
            row = {
                "wall_s": wall,
                "done": m.nuclides_done,
                "quarantined": m.nuclides_quarantined,
                "moments": m.moments_computed,
                "new_segments": (torch.cuda.memory_stats().get("segment.all.allocated", 0) - segs) if cuda else None,
                "phase_seconds": m.phase_seconds,
                "op_calls": dict(clock.calls),
                "op_host_s": dict(clock.seconds),
                "op_self": {fam: split_self_time(p) for fam, p in clock.profiles.items() if clock.calls.get(fam)},
            }
            passes[which] = row
            print(f"[{which}] wall {wall:.3f} s, done {m.nuclides_done}, quarantined {m.nuclides_quarantined}, "
                  f"new allocator segments {row['new_segments']}", flush=True)
            print(f"[{which}] phase seconds " + json.dumps({k: round(v, 4) for k, v in m.phase_seconds.items()}),
                  flush=True)
            if m.nuclides_quarantined:
                raise SystemExit(f"{m.nuclides_quarantined} nuclide(s) quarantined")

    families = {}
    cold, warm, prof = passes["cold"], passes["warm"], passes["ops"]
    for fam in OPS:
        span = f"dispatch.{fam}"
        if span not in warm["phase_seconds"]:
            continue
        fam_row = {
            "dispatch_cold_s": cold["phase_seconds"].get(span, 0.0),
            "dispatch_warm_s": warm["phase_seconds"][span],
            "first_use_s": cold["phase_seconds"].get(span, 0.0) - warm["phase_seconds"][span],
            "op_calls": warm["op_calls"].get(fam, 0),
            "op_host_warm_s": warm["op_host_s"].get(fam, 0.0),
            "driver_host_warm_s": warm["phase_seconds"][span] - warm["op_host_s"].get(fam, 0.0),
            **{f"ops_pass_{k}": v for k, v in prof["op_self"].get(fam, {}).items()},
        }
        families[fam] = fam_row
        print(f"[{fam}] " + json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in fam_row.items()}),
              flush=True)

    for sort in ("cumulative", "tottime"):
        buf = io.StringIO()
        pstats.Stats(whole, stream=buf).sort_stats(sort).print_stats(args.top)
        print(f"\n===== whole pass: top by {sort} =====")
        for line in buf.getvalue().splitlines():
            if "ndpp" in line or "{" in line or "ncalls" in line or "torch" in line:
                print(line)
    result = {"deck": args.workdir or args.deck, "device": args.device, "gpu": smi, "passes": passes,
              "families": families}
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
