"""Whether what the timed passes wrote is correct: the sampled nuclides'
library blocks against the reference, number by number, each beside its
limit.

Numbers compared (limits from `limits`, readings in PERF.md):
  header_faults      fields of the file and nuclide headers that differ
                     from what the configuration and the records state
                     (order, temperatures, group structure and its bounds,
                     name, zaid, awr, kT, array shapes), and lines that do
                     not parse as the format says; exact
  quarantined        nuclides the program quarantined in the window; exact
  energy_gap         largest relative gap of the incident grid; exact
  sigma_gap          largest relative gap of sigma_scatter, |p - r| / |r|
  moment_gap         largest gap of a sampled scatter row (one temperature,
                     one incident energy: (L+1) x G moments), measured
                     against that row's scale: max |p - r| / max |r|
  rows_checked       sampled rows compared; at least one
The configuration states the limit of sigma_gap and moment_gap (its
`tolerance`: the 1e-8 of BASELINE.json, at the row's scale as the project's
kernel and selfcheck comparisons measure it).
"""

from __future__ import annotations

import zlib

import numpy as np

from . import nuclide as ref_nuc
from . import thermal as ref_thermal

BOLTZMANN_EV_PER_K = 8.617333262e-5  # eV/K (CODATA)
FORMAT_VERSION_PREFIX = "NDPP-TPU ASCII LIBRARY "


def group_bounds(name: str) -> np.ndarray:
    """The synthetic uniform-lethargy stand-ins: ng groups log-uniform in E
    between 1e-5 eV and 20 MeV, ends pinned."""
    ng = int(name.rsplit("-", 1)[1])
    b = np.exp(np.linspace(np.log(1.0e-5), np.log(2.0e7), ng + 1))
    b[0], b[-1] = 1.0e-5, 2.0e7
    return b


def _rng(seed: int, *keys: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63)] + [zlib.crc32(k.encode()) for k in keys])


def strata_edges(run: dict, nuc) -> list[float]:
    """Energies that split a nuclide's rows into regions of different
    physics: the free-gas cutoffs, the first level."""
    edges = []
    if ref_thermal.freegas_on(nuc, run):
        edges += [run["thermal_cutoff_kt"] * BOLTZMANN_EV_PER_K * t for t in run["temperatures"]]
    thresholds = [abs(r.q) * (nuc.awr + 1.0) / nuc.awr for r in nuc.reactions.values() if r.mt != 102]
    if thresholds:
        edges.append(min(thresholds))
    return sorted(edges)


def row_chooser(seed: int, run: dict, deck, n_rows: int):
    """choose_rows(block, energy, shape) for the stream parser: the last row
    (every reaction open) and n_rows - 1 more, spread over the regions of
    strata_edges, uniform inside each, drawn from the seed and the name."""

    def choose(block, energy, shape):
        ne = shape[1]
        nuc = deck.nuclides.get(block.name)
        if nuc is None or energy is None:
            return [ne - 1]
        cuts = np.searchsorted(energy, strata_edges(run, nuc))
        regions = [r for r in np.split(np.arange(ne - 1), cuts) if r.size]
        rng = _rng(seed, block.name)
        picked = {ne - 1}
        for k in range(n_rows - 1):
            region = regions[k % len(regions)]
            picked.add(int(rng.choice(region)))
        return sorted(picked)

    return choose


def row_gap(p: np.ndarray, r: np.ndarray) -> float:
    """max |p - r| over the row, in units of the row's largest |r|."""
    scale = float(np.max(np.abs(r)))
    d = float(np.max(np.abs(p - r)))
    return d / scale if scale > 0 else (0.0 if d == 0 else float("inf"))


def rel_gap(p: np.ndarray, r: np.ndarray) -> float:
    r = np.asarray(r)
    d = np.abs(np.asarray(p) - r)
    return float(np.max(np.where(r != 0, d / np.where(r != 0, np.abs(r), 1.0), np.where(d > 0, np.inf, 0.0))))


def limits(config: dict) -> dict:
    """Each number compared and its limit: exact comparisons 0, the
    configuration's `tolerance` for the continuous gaps, at least one row."""
    rtol = float(config["tolerance"]["rtol"])
    return {"header_faults": 0, "quarantined": 0, "energy_gap": 0.0, "sigma_gap": rtol, "moment_gap": rtol,
            "rows_checked": 1}


def failed(numbers: dict, lims: dict) -> list[str]:
    """The numbers that miss their limits (rows_checked is a floor, the rest
    ceilings)."""
    return [k for k, lim in lims.items() if (numbers[k] < lim if k == "rows_checked" else numbers[k] > lim)]


def header_faults(header, run: dict) -> int:
    lines = {ln.split()[0]: ln.split()[1:] for ln in header.lines}
    temps = [float(t) for t in run["temperatures"]]
    faults = 0
    faults += not any(ln.startswith(FORMAT_VERSION_PREFIX) for ln in header.lines)
    faults += lines.get("legendre_order") != [str(run["legendre_order"])]
    t = lines.get("temperatures", [])
    faults += not (t and int(t[0]) == len(temps) and [float(x) for x in t[1:]] == temps)
    ng = int(run["groups"].rsplit("-", 1)[1])
    faults += lines.get("group_structure") != [run["groups"], str(ng)]
    faults += header.bounds is None or not np.array_equal(header.bounds, group_bounds(run["groups"]))
    return int(faults)


def block_header_faults(block, nuc, run: dict) -> int:
    h = block.header
    faults = 0
    try:
        faults += h[1] != nuc.name or int(h[3]) != nuc.zaid or float(h[5]) != nuc.awr
        faults += float(h[7]) != nuc.kT
    except (IndexError, ValueError):
        return 1
    nt, lp1 = len(run["temperatures"]), run["legendre_order"] + 1
    ng = int(run["groups"].rsplit("-", 1)[1])
    faults += block.shapes.get("scatter") != (nt, nuc.energy.size, lp1, ng)
    faults += block.shapes.get("energy") != (nuc.energy.size,)
    faults += not np.array_equal(block.arrays.get("temperatures"), np.asarray(run["temperatures"], float))
    faults += not block.complete
    return int(faults)


def reference_rows(nuc, run: dict, rows: list[int], dtype=np.float64, device="cpu") -> dict:
    """(t, i) -> (L+1, G) reference moments at the given rows."""
    bounds = group_bounds(run["groups"])
    order, clamp = run["legendre_order"], run["clamp_outside"]
    sig, sigma_s = ref_nuc.cross_sections(nuc)
    out = {}
    for i in rows:
        base = ref_nuc.zero_kelvin_row(nuc, i, bounds, order, clamp, sig, sigma_s, dtype)
        for t, temp in enumerate(run["temperatures"]):
            out[(t, i)] = ref_thermal.replace_row(nuc, run, i, temp, base, sig, sigma_s, bounds, dtype, device)
    return out


def verify(run: dict, deck, passes, gate_failed: int, seed: int, n_nuclides: int,
           dtype=np.float64, device="cpu") -> dict:
    """The numbers compared, over the nuclides sampled from those the
    window's passes wrote (the one with the largest grid always in). The
    nuclide in progress at the close counts with the sampled rows that
    reached the library whole; its header and sigma_scatter are judged once
    complete."""
    blocks = [b for p in passes for b in p.blocks]
    blocks += [p.current for p in passes if p.current is not None and p.current.rows]
    numbers = {
        "header_faults": sum(header_faults(p.header, run) + len(p.faults) for p in passes if p.header.lines),
        "quarantined": int(gate_failed),
        "energy_gap": 0.0,
        "sigma_gap": 0.0,
        "moment_gap": 0.0,
        "nuclides_checked": 0,
        "rows_checked": 0,
    }
    if not blocks:
        return numbers
    worst = [""]
    rng = _rng(seed, "sample")
    largest = max(range(len(blocks)), key=lambda k: blocks[k].shapes.get("energy", (0,))[0])
    rest = [k for k in range(len(blocks)) if k != largest]
    take = [largest] + list(rng.permutation(rest)[: max(n_nuclides - 1, 0)])
    for k in take:
        blk = blocks[k]
        nuc = deck.nuclides[blk.name]
        e_ref = nuc.energy.astype(dtype)
        e_p = blk.arrays.get("energy")
        if e_p is None or e_p.shape != e_ref.shape:
            numbers["header_faults"] += 1
            continue
        numbers["energy_gap"] = max(numbers["energy_gap"], float(np.max(np.abs(e_p - e_ref) / e_ref)))
        sig, sigma_s = ref_nuc.cross_sections(nuc)
        if blk.complete or "sigma_scatter" in blk.arrays:
            numbers["header_faults"] += block_header_faults(blk, nuc, run)
            numbers["sigma_gap"] = max(numbers["sigma_gap"], rel_gap(blk.arrays["sigma_scatter"], sigma_s.astype(dtype)))
        rows = sorted({i for _, i in blk.rows})
        ref = reference_rows(nuc, run, rows, dtype, device)
        for key, r in ref.items():
            if key not in blk.rows:
                continue
            g = row_gap(blk.rows[key], r)
            if g > numbers["moment_gap"]:
                t, i = key
                worst[0] = (f"worst row {blk.name} T={run['temperatures'][t]} E={float(nuc.energy[i])!r} eV "
                            f"({ref_thermal.region(nuc, run, i, run['temperatures'][t])}) gap {g!r}")
            numbers["moment_gap"] = max(numbers["moment_gap"], g)
            numbers["rows_checked"] += 1
        numbers["nuclides_checked"] += 1
    numbers["worst"] = worst[0]
    return numbers
