"""The harness's arithmetic on the CPU: the moment count of a streamed
library, the union of device intervals and the idle gaps, the two-body
work count against a direct sum, and the manifest's names and units."""

from __future__ import annotations

import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.harness import trace, work
from benchmark.harness.stream import LINE, StreamParser, array_bytes, value_offset

ROOT = Path(__file__).resolve().parents[2]


def _array(vals) -> str:
    flat = np.asarray(vals, dtype=np.float64).ravel()
    return "".join("".join(f"{v:26.17E}" for v in flat[i : i + 4]) + "\n" for i in range(0, flat.size, 4))


def _library(shapes, rng) -> tuple[str, list[np.ndarray]]:
    """A library in the writer's format with the given scatter shapes."""
    text = ["NDPP-TPU ASCII LIBRARY 1.2\n", "generator test\n", "legendre_order 1\n",
            "temperatures 1 2.93600000000000023E+02\n", "group_structure uniform-lethargy-3 3\n",
            _array([1e-5, 1.0, 1e3, 2e7])]
    scatters = []
    for k, (nt, ne, lp1, ng) in enumerate(shapes):
        s = rng.standard_normal((nt, ne, lp1, ng))
        scatters.append(s)
        text += [f"nuclide n{k} zaid {k} awr 1.0E+00 kT_eV 2.53E-02\n", f"energy {ne}\n",
                 _array(np.geomspace(1e-5, 2e7, ne)), f"temperatures {nt}\n", _array(np.full(nt, 293.6)),
                 f"scatter {nt} {ne} {lp1} {ng}\n", _array(s), f"sigma_scatter {ne}\n", _array(np.ones(ne)),
                 f"end_nuclide n{k}\n"]
    return "".join(text) + "end_library\n", scatters


def test_fixed_width_offsets():
    assert LINE == 105
    for n in (1, 3, 4, 5, 8, 11):
        assert array_bytes(n) == len(_array(np.arange(n)))
        text = _array(np.arange(n) + 0.5)
        for k in range(n):
            assert float(text[value_offset(k) : value_offset(k) + 26]) == k + 0.5


@pytest.mark.parametrize("chunk", [1, 7, 105, 4096, 10**7])
def test_moment_count_whole_and_cut_mid_scatter(chunk):
    rng = np.random.default_rng(0)
    shapes = [(1, 7, 2, 3), (2, 5, 2, 3), (1, 9, 2, 3)]
    text, scatters = _library(shapes, rng)
    raw = text.encode()
    picked = {}

    def choose(block, energy, shape):
        picked[block.name] = [0, shape[1] - 1]
        return picked[block.name]

    # cut inside the last nuclide's scatter, after 10 of its lines
    start = raw.index(b"scatter 1 9 2 3\n") + len(b"scatter 1 9 2 3\n")
    cut = start + 10 * LINE + 3
    sp = StreamParser(choose)
    fetch = lambda a, b: raw[a:b]  # noqa: E731
    for end in list(range(chunk, cut, chunk)) + [cut]:
        sp.advance(fetch, end)
    whole = sum(int(np.prod(s)) for s in shapes[:2])
    assert sp.values() == whole + 10 * 4
    assert [b.name for b in sp.blocks] == ["n0", "n1"] and all(b.complete for b in sp.blocks)
    for blk, s in zip(sp.blocks, scatters):
        for (t, e), row in blk.rows.items():
            assert np.array_equal(row, s[t, e])
    sp.advance(fetch, len(raw))
    assert sp.values() == sum(int(np.prod(s)) for s in shapes) and sp.ended and not sp.faults


def test_union_and_gaps():
    busy = trace.union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.0)])
    assert busy == [(0.0, 2.0), (3.0, 4.0)]
    assert trace.gaps(busy, -1.0, 6.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 6.0)]
    assert trace.clipped_total(busy, 1.0, 3.5) == pytest.approx(1.5)


def test_twobody_work_against_a_direct_sum():
    """Panels and band counted by a loop over each row's knots and the
    group boundaries its lab energies cross."""
    rng = np.random.default_rng(3)
    bounds = np.geomspace(1e-5, 2e7, 9)
    order, nq = 3, 4
    e = np.array([1e-3, 1.0, 5e5, 2e6, 1.5e7])
    knots = np.array([[-1, -0.5, -0.5, 0.2, 1, 1, 1]] * 5, dtype=float)
    pdf = np.array([[0.4, 0.5, 0.6, 0.5, 0.5, 0.5, 0.5]] * 5)
    awr, q = 20.0, -1.0e6
    c1, c2 = abs(q) * (awr + 1) / awr, (awr / (awr + 1)) ** 2
    flops, nbytes = work.twobody_row_work(e, knots, pdf, c1, c2, awr, bounds, order, nq, True)
    f_ref = b_ref = 0.0
    per_node = 15 + 2 + 6 * (order - 1)
    for i in range(e.size):
        b_ref += 8 * 4
        ecm = c2 * (e[i] - c1)
        if ecm <= 0:
            continue
        base, slope = ecm + e[i] / (awr + 1) ** 2, 2 * np.sqrt(e[i] * ecm) / (awr + 1)
        inner_knots = {k for k in knots[i] if -1 < k < 1}
        crossed = [b for b in bounds[1:-1] if base - slope < b < base + slope]
        panels = 1 + len(inner_knots) + len(crossed)
        f_ref += panels * (nq * per_node + 2 * (order + 1) + 2)
        real = 1 + sum(1 for j in range(1, knots.shape[1])
                       if (knots[i, j], pdf[i, j]) != (knots[i, j - 1], pdf[i, j - 1]))
        b_ref += 8 * (2 * real + (order + 1) * (len(crossed) + 1))
    assert (flops, nbytes) == (f_ref, b_ref)
    assert f_ref > 0 and rng is not None


def test_bound_side():
    peaks = {"hbm_bytes_per_s": 1.0, "fp64_flops_per_s": 10.0}
    assert work.bound_seconds(100.0, 5.0, peaks) == (10.0, "fp64")
    assert work.bound_seconds(10.0, 5.0, peaks) == (5.0, "bytes")


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_manifest_names_units_and_files():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (ROOT / "benchmark" / "workloads" / f"{w['traffic']}.json").is_file()
    for c in m["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and (ROOT / c["file"]).is_file()
        assert len(c["source"]) <= 200
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{x['name']}.py").is_file()
    metric_names = {x["name"] for x in m["end_to_end"]}
    assert all(x["moves"] in metric_names for x in m["per_layer"])
    assert len(json.dumps(m)) < 64 * 1024


def test_a_reader_that_finds_nothing_returns_nothing():
    run = SimpleNamespace(window_s=1.0, moments=0, spans=[], device_events=[], kernel_calls={},
                          spans_named=lambda *n: [], device_name="cpu", notes=[])
    from benchmark.run import metric_module

    for name in ("ops.launches_per_kmoment", "device.idle_share", "kernel.twobody_group.roofline",
                 "writer.us_per_moment", "host.us_per_moment", "families.us_per_moment"):
        assert metric_module(name).read(run) is None
