"""The port's CM continuum path on nuclides of the fast deployment
(BASELINE.json milestone 4 at 361 groups: U-238's and H-2's continuum
reactions at the widths of ENDF/B-VII.1 ACE files), made by the
benchmark's generator from a seed and held to the benchmark's plain
reference (benchmark/reference/continuum.py) at 1e-8 of each row's scale:
max over the row's (L+1) x G moments of |port - reference| over its largest
|moment|.

  - Kalbach (law 44, CM) on a heavy target, U-238's (n,2n) and (n,3n), at
    the top incident rows up to 20 MeV, 47 groups, P3. A heavy target's
    inner window is narrower than one outgoing-knot spacing, so one inner
    panel carries the whole Kalbach factor and P_L(mu_lab); the inner rule
    the port had (7 nodes) missed 1e-8 there (2.0e-8 and 1.5e-8 on these
    seeds).
  - N-body phase space (law 66, CM), H-2's (n,2n), at rows near 5.1 MeV,
    where the lab spectrum's P5 structure near E'_lab = 0 lay inside a wide
    outer panel whose group values the port took from an interpolant
    (6.3e-8). At 47 groups and P3 that split reads 7.2e-10 at worst over
    200 rows, so this case runs at 361 groups and P5, on three rows.

The reference integrates outer over y = sqrt(E'_cm) and inner over the
cosine with every edge exact and graded towards E'_lab = 0 (its own tests
hold it to the JAX oracles); the port integrates outer over sqrt(E'_lab).
Both are float64; they agree to about 1e-13 of the row's scale.
"""

import numpy as np
import pytest
import torch

from benchmark.gen import deck as deck_mod
from benchmark.reference import check
from benchmark.reference import continuum as ref_cont
from ndpp_tpu_torch import continuum_driver, groups
from ndpp_tpu_torch.config import RunConfig
from ndpp_tpu_torch.host.ace import parse
from ndpp_tpu_torch.utils.metrics import RunMetrics

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

RTOL = 1e-8
# catalog entries in the generator's keys (benchmark/gen/laws.py); the seed
# draws every value, never a size
CATALOG = {
    "u238": {
        "zaid": 92238, "awr": 236.006, "n_base": 1600, "resonances": 16, "levels": 30, "level_mev": [0.04491, 1.5],
        "sigma_el_base": 10.0, "angular_tables": 6,
        "continuum": [
            {"mt": 16, "law": 44, "frame": "cm", "multiplicity": 2, "threshold_mev": 6.18, "incident": 24,
             "outgoing": 96},
            {"mt": 17, "law": 44, "frame": "cm", "multiplicity": 3, "threshold_mev": 11.3, "incident": 20,
             "outgoing": 64},
            {"mt": 91, "law": 44, "frame": "cm", "multiplicity": 1, "threshold_mev": 1.55, "incident": 30,
             "outgoing": 128},
        ],
        "fission": {"laws": [9, 11], "incident": 24, "restriction_mev": -20.0, "threshold_mev": 1.0,
                    "fast_barns": 0.55, "nu": 30, "precursors": 6, "delayed_incident": 2, "delayed_outgoing": 200},
    },
    "h2": {
        "zaid": 1002, "awr": 1.9968, "n_base": 1200, "resonances": 0, "levels": 0, "sigma_el_base": 3.4,
        "angular_tables": 6,
        "continuum": [{"mt": 16, "law": 66, "frame": "cm", "multiplicity": 2, "threshold_mev": 3.339, "npsx": 3,
                       "ap": 2.9968}],
    },
}
# (key, seed, MT, group structure, order, rows: None for the top 8 incident rows)
KALBACH_CASES = [("u238", 26, 16, "uniform-lethargy-47", 3, None), ("u238", 27, 17, "uniform-lethargy-47", 3, None)]
NBODY_CASE = ("h2", 26, 16, "uniform-lethargy-361", 5, (5.06e6, 5.0814e6, 5.1e6))


def nuclide(key: str, seed: int, tmp_path):
    """(generator records, the port's parse of their ACE file) of one
    catalog entry at its full size."""
    deck = deck_mod.build({"catalog": CATALOG}, {"deck": [key]}, seed, [key])
    deck_mod.write(deck, tmp_path)
    name, nuc = next(iter(deck.nuclides.items()))
    return nuc, parse.read_ace(tmp_path / f"{name}.ace", name_hint=name)


def port_rows(case, tmp_path, device="cpu"):
    """(records, rows, the port's batched_continuum_moments at those rows,
    the run's metrics) of one case."""
    key, seed, mt, group_name, order, rows = case
    nuc, pn = nuclide(key, seed, tmp_path)
    e = nuc.energy[-8:] if rows is None else np.asarray(rows)
    cfg = RunConfig(freegas_for=["none"], legendre_order=order)
    metrics = RunMetrics()
    got = continuum_driver.batched_continuum_moments(
        pn, [(pn.reactions[mt], e)], groups.get(group_name), order, cfg, torch.device(device), metrics)[0]
    return nuc, e, got, metrics


def _gaps(case, tmp_path):
    key, seed, mt, group_name, order, _ = case
    nuc, e, got, metrics = port_rows(case, tmp_path)
    bounds = check.group_bounds(group_name)
    refs = [ref_cont.moments(nuc, nuc.reactions[mt], float(x), bounds, order, True) for x in e]
    return e, [check.row_gap(g, r) for g, r in zip(got, refs)], metrics


@pytest.mark.parametrize("case", KALBACH_CASES, ids=lambda c: f"{c[0]}-seed{c[1]}-mt{c[2]}")
def test_heavy_target_kalbach_rows_match_the_reference(case, tmp_path):
    e, gaps, metrics = _gaps(case, tmp_path)
    assert e[-1] == 2.0e7
    assert max(gaps) <= RTOL, [f"{x:.6g} eV: {g:.3e}" for x, g in zip(e, gaps)]
    # the counters: every row once, under its law and frame, with its outer panels
    assert metrics.continuum_rows == {(44, "cm"): e.size}
    assert metrics.continuum_outer_panels[(44, "cm")] > e.size * 47
    assert metrics.timers.report().keys() >= {"continuum.kernel", "dispatch.continuum", "wait.continuum"}


def test_nbody_rows_near_zero_lab_energy_match_the_reference(tmp_path):
    e, gaps, metrics = _gaps(NBODY_CASE, tmp_path)
    assert max(gaps) <= RTOL, [f"{x:.6g} eV: {g:.3e}" for x, g in zip(e, gaps)]
    assert metrics.continuum_rows == {(66, "cm"): e.size}
