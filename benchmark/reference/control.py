"""The control of the output check: the reference, put in the program's
place and computed in float32 (the precision below the configuration's
float64), read by the same numbers and limits as a run (check.limits).
It has to come out as not correct. It needs no decoding of the program: at
the rows a run samples (every nuclide of the deck), float32 against
float64.

    python3 -m benchmark.reference.control --workload <cell> --seeds <n> [<n> ...] [--device cuda]

prints one JSON line a seed with each number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import check
from . import chi as ref_chi
from . import nuclide as ref_nuc


def readings(config: dict, traffic: dict, seed: int, device: str = "cpu", dtype=np.float32) -> dict:
    from benchmark.gen import deck as deck_mod

    run = config["run"]
    deck = deck_mod.build(config, traffic, seed)
    choose = check.row_chooser(seed, run, deck, int(traffic["check"]["rows"]))
    nt, lp1, ng = len(run["temperatures"]), run["legendre_order"] + 1, int(run["groups"].rsplit("-", 1)[1])
    # The reference writes the headers the configuration states and quarantines nothing.
    numbers = {"header_faults": 0, "quarantined": 0, "energy_gap": 0.0, "sigma_gap": 0.0, "moment_gap": 0.0,
               "rows_checked": 0, "chi_gap": 0.0, "chi_rows_checked": 0, "unreferenced": 0}
    bounds = check.group_bounds(run["groups"])
    for name, nuc in deck.nuclides.items():
        block = type("Block", (), {"name": name})()
        rows = choose(block, nuc.energy, (nt, nuc.energy.size, lp1, ng))
        ref = check.reference_rows(nuc, run, rows, np.float64, device)
        low = check.reference_rows(nuc, run, rows, dtype, device)
        e_low = nuc.energy.astype(dtype).astype(np.float64)
        numbers["energy_gap"] = max(numbers["energy_gap"], float(np.max(np.abs(e_low - nuc.energy) / nuc.energy)))
        _, sigma_s = ref_nuc.cross_sections(nuc)
        numbers["sigma_gap"] = max(numbers["sigma_gap"], check.rel_gap(sigma_s.astype(dtype), sigma_s))
        for key, r in ref.items():
            numbers["moment_gap"] = max(numbers["moment_gap"], check.row_gap(low[key].astype(np.float64), r))
        numbers["rows_checked"] += len(ref)
        numbers["unreferenced"] += ref_nuc.unreferenced(nuc) + ref_chi.unreferenced(nuc)
        chi_ref = ref_chi.rows(nuc, rows, bounds, run["clamp_outside"], np.float64)
        chi_low = ref_chi.rows(nuc, rows, bounds, run["clamp_outside"], dtype)
        for key, r in chi_ref.items():
            numbers["chi_gap"] = max(numbers["chi_gap"], check.row_gap(chi_low[key].astype(np.float64), r))
        for r in ref_chi.nu(nuc, nuc.energy).values() if chi_ref else ():
            numbers["chi_gap"] = max(numbers["chi_gap"], check.rel_gap(np.asarray(r, dtype).astype(np.float64), r))
        numbers["chi_rows_checked"] += len(chi_ref)
    return numbers


def main(argv=None) -> int:
    from benchmark import run as run_mod

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, cell, config, traffic = run_mod.load_cell(args.workload)
    lims = check.limits(config)
    for seed in args.seeds:
        t0 = time.perf_counter()
        n = readings(config, traffic, seed, args.device)
        missed = check.failed(n, lims)
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0,
                          "control_correct": not missed, "failed": missed,
                          "numbers": {k: {"value": n[k], "limit": lims[k]} for k in lims}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
