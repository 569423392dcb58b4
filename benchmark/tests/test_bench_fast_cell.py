"""The fast cell (shem361-fast) on the CPU: its deck's sizes, the CM work
count against a direct loop over the outer nodes, its readers on a traced
run at a small size, and those readers reading nothing where the program
has no such counters."""

from __future__ import annotations

import math
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.gen import deck as deck_mod
from benchmark.harness import work_cm
from benchmark.reference import check

torch = pytest.importorskip("torch")

SEED = 2**31 + 4171
READERS = ("kernel.cm_inner.roofline", "continuum.us_per_moment", "continuum.panels_per_row")


def _cell():
    from benchmark import run as run_mod

    return run_mod.load_cell("shem361-fast")


def test_deck_sizes_and_laws():
    _, cell, config, traffic = _cell()
    assert cell["chips"] == 1 and config["run"]["groups"] == "uniform-lethargy-361"
    assert config["run"]["legendre_order"] == 5 and config["tolerance"]["rtol"] == 1e-8
    deck = deck_mod.build(config, traffic, SEED)
    assert [deck.stand_in[n] for n in deck.order] == traffic["deck"]
    sizes = [nuc.energy.size for nuc in deck.nuclides.values()]
    assert min(sizes) >= 1199 and max(sizes) <= 2127
    laws = {(ed.law, r.frame) for nuc in deck.nuclides.values() for mt, r in nuc.reactions.items()
            if mt not in (2, 18) and mt < 51 or mt == 91 for ed in r.energy_dists}
    assert {(44, "cm"), (61, "cm"), (61, "lab"), (66, "cm"), (4, "lab")} <= laws
    fissile = {deck.stand_in[n]: nuc for n, nuc in deck.nuclides.items() if 18 in nuc.reactions}
    assert set(fissile) == {"u235", "u238"} and all(len(n.precursors) == 6 for n in fissile.values())


def _direct(nuc, rxn, e_rows, bounds, order):
    """Flops of one Kalbach reaction's rows by a loop over every outer node:
    the inner panels at each node from the knots inside its window."""
    ed = rxn.energy_dists[0]
    data = ed.data
    wb = np.sqrt(bounds[1:-1])
    per = work_cm.per_node("tabular", "kalbach", order)
    xg = np.polynomial.legendre.leggauss(work_cm.OUTER_NODES)[0]
    total = 0
    for x in e_rows:
        p = int(np.clip(np.searchsorted(data.energies, x, side="right") - 1, 0, data.energies.size - 2))
        t = float(np.clip((x - data.energies[p]) / (data.energies[p + 1] - data.energies[p]), 0, 1))
        t0, t1 = data.tables[p], data.tables[p + 1]
        unit = lambda tb: (tb.e_out - tb.e_out[0]) / (tb.e_out[-1] - tb.e_out[0])  # noqa: E731
        u = np.unique(np.concatenate([unit(t0), unit(t1)]))
        lo = t0.e_out[0] + t * (t1.e_out[0] - t0.e_out[0])
        hi = t0.e_out[-1] + t * (t1.e_out[-1] - t0.e_out[-1])
        y = np.sqrt(lo + u * (hi - lo))
        s = math.sqrt(x) / (nuc.awr + 1.0)
        ends = sorted({abs(v - s) for v in y} | {v + s for v in y} | ({0.0} if y[0] < s < y[-1] else set()))
        ends = sorted(set(ends) | {b for b in wb if ends[0] < b < ends[-1]})
        ends = [v for i, v in enumerate(ends) if i == 0 or v - ends[i - 1] > work_cm.EDGE_RTOL * ends[-1]]
        for a, b in zip(ends[:-1], ends[1:]):
            for node in 0.5 * (a + b) + 0.5 * (b - a) * xg:
                w0, w1 = max(abs(node - s), y[0]), min(node + s, y[-1])
                total += (1 + sum(1 for v in y[1:-1] if w0 < v < w1)) * work_cm.inner_nodes("kalbach", order) * per
    return float(total)


def test_cm_work_against_a_loop_over_the_outer_nodes():
    _, _, config, traffic = _cell()
    spec = dict(config["catalog"]["u238"], n_base=200, resonances=0)
    deck = deck_mod.build({"catalog": {"u238": spec}}, {"deck": ["u238"]}, SEED)
    nuc = next(iter(deck.nuclides.values()))
    bounds = check.group_bounds("uniform-lethargy-47")
    rxn = nuc.reactions[16]
    e_rows = nuc.energy[rxn.threshold_idx:][-6:]
    flops, nbytes = work_cm.continuum_call_work(nuc, [(rxn, e_rows)], bounds, 3, True)
    assert flops == _direct(nuc, rxn, e_rows, bounds, 3)
    assert nbytes > 8 * e_rows.size * 4  # tables read, and at least one group of P0-P3 a row written


def _traced_small(seconds=6.0):
    """A traced run of the fast cell on the CPU: every nuclide of the deck,
    its laws and reactions on short grids and short tables, 47 groups, P3."""
    from benchmark import run as run_mod

    torch.set_num_threads(2)
    manifest, cell, config, traffic = _cell()
    config["run"].update(groups="uniform-lethargy-47", legendre_order=3)
    small = {"incident": 4, "outgoing": 12, "cosines": 5, "nu": 4, "delayed_outgoing": 10}
    for spec in config["catalog"].values():
        spec.update(n_base=120, resonances=min(spec.get("resonances", 0), 1), levels=min(spec.get("levels", 0), 2))
        for part in spec.get("continuum", []) + [spec.get("fission", {})]:
            part.update({k: v for k, v in small.items() if k in part})
    traffic["warmup"]["n_base"] = 60
    traffic["check"]["rows"] = 4
    with tempfile.TemporaryDirectory() as d:
        return run_mod.run_cell(manifest, cell, config, traffic, SEED, seconds, True, "cpu", Path(d), join=True)


def test_traced_run_reads_the_continuum_metrics():
    res = _traced_small()
    assert res["correct"], res["check"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # no device trace on the CPU, so no roofline; the span and the counters read
    assert "kernel.cm_inner.roofline" not in m
    assert m["continuum.us_per_moment"] > 0
    assert m["continuum.panels_per_row"] > 47


def test_readers_without_the_counters_read_nothing():
    from benchmark.run import metric_module

    run = SimpleNamespace(window_s=1.0, moments=0, spans=[], device_events=[], kernel_calls={},
                          spans_named=lambda *n: [], device_name="cpu", notes=[])
    for name in READERS:
        assert metric_module(name).read(run) is None
    # a continuum call whose metrics carry no continuum counters (a program before them)
    mod = metric_module("continuum.panels_per_row")
    span = SimpleNamespace(name="family.continuum", t0=0.1, t1=0.2)
    mod.on_call(span, (None, [], None, 5, None, None, SimpleNamespace()), None, run)
    mod.on_call(span, (None, [], None, 5, None, None, None), None, run)
    assert mod.read(run) is None


def test_panels_per_row_counts_each_call_once():
    """Each call adds what the counters grew by in it, pass after pass."""
    from collections import Counter

    from benchmark.run import metric_module

    mod = metric_module("continuum.panels_per_row")
    run = SimpleNamespace(window_s=10.0, kernel_calls={})
    span = SimpleNamespace(name="family.continuum", t0=1.0, t1=2.0)
    for _ in range(2):  # two passes, a RunMetrics each
        m = SimpleNamespace(continuum_rows=Counter(), continuum_outer_panels=Counter())
        for rows, panels in ((10, 1000), (5, 200)):
            m.continuum_rows[(44, "cm")] += rows
            m.continuum_rows[(4, "lab")] += 7  # a lab law: rows, no outer panels
            m.continuum_outer_panels[(44, "cm")] += panels
            mod.on_call(span, (None, [], None, 5, None, None, m), None, run)
    assert mod.read(run) == 2 * 1200 / 30
