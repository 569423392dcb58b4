"""The output check catches a broken timed path. Each test skips the
harness's look for a card and drives the rest of a run on the CPU at a
small size (run_cell with device="cpu"), with the port broken underneath,
and sees `correct` come out false; the unbroken run comes out true. The
control (the reference in float32 in the program's place) fails too.

Faults, as this system can have them on one card:
  half of the batch left out   the two-body rows of each pool's second half
                               come back as zeros
  an answer altered            every two-body P0 moment scaled by 1 + 1e-7
                               where the kernel's result lands
  a step returns its state     the sum over reactions keeps the elastic
  unchanged                    channel alone (every level's step adds
                               nothing); and, for a deck with free gas, the
                               free-gas replacement returns the 0 K rows
On the small continuum-and-fission deck (benchmark/tests/small_decks.py):
  a reaction left out          each nuclide's first continuum reaction
                               adds nothing to the sum
  an answer altered            the CM op's moments scaled by 1 + 1e-7
                               where they come back
  a step left out              the delayed spectra left out of chi_total
(No exchange between chips: every cell runs on one card.)
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("ndpp_tpu_torch.driver")

from benchmark import run as run_mod  # noqa: E402
from benchmark.reference import control  # noqa: E402
from benchmark.tests.small_decks import continuum_fission  # noqa: E402

SEED = 2**31 + 4242


def _small(cell: str, freegas: bool = False):
    """The cell at a size the CPU holds: three nuclides, short grids, three
    levels. freegas: at two temperatures with free gas on every nuclide,
    on 47 groups."""
    manifest, c, config, traffic = run_mod.load_cell(cell)
    for spec in config["catalog"].values():
        spec["n_base"] = 120
        spec["levels"] = min(spec.get("levels", 0), 3)
        spec["resonances"] = min(spec.get("resonances", 0), 1)
    if freegas:
        config["run"].update(groups="uniform-lethargy-47", temperatures=[293.6, 600.0], freegas_for=[])
    traffic["deck"] = traffic["deck"][:3]
    traffic["check"] = {"nuclides": 3, "rows": 6}
    return manifest, c, config, traffic


def _run(cell, freegas=False, seconds=2.0):
    torch.set_num_threads(2)
    manifest, c, config, traffic = _small(cell, freegas)
    with tempfile.TemporaryDirectory() as d:
        return run_mod.run_cell(manifest, c, config, traffic, SEED, seconds, False, "cpu", Path(d), join=True)


def _broken_twobody(monkeypatch, fault):
    from ndpp_tpu_torch import driver

    inner = driver.twobody_moments

    def broken(*args, **kwargs):
        res = inner(*args, **kwargs).clone()
        if fault == "half":
            res[res.shape[0] // 2 :] = 0.0
        else:
            res[:, 0, :] *= 1.0 + 1e-7
        return res

    monkeypatch.setattr(driver, "twobody_moments", broken)


def _levels_unsummed(monkeypatch):
    from ndpp_tpu_torch import driver

    inner = driver._tiled_twobody_multi

    def broken(preps, *args, **kwargs):
        outs = inner(preps, *args, **kwargs)
        return outs[:1] + [(np.zeros_like(mom), g0) for mom, g0 in outs[1:]]

    monkeypatch.setattr(driver, "_tiled_twobody_multi", broken)


def test_sound_run_is_correct():
    res = _run("xmas172-structural")
    assert res["correct"], res["check"]
    assert res["check"]["moment_gap"]["value"] < 1e-10


@pytest.mark.parametrize("fault", ["half", "altered", "unsummed"])
def test_broken_twobody_is_not_correct(monkeypatch, fault):
    if fault == "unsummed":
        _levels_unsummed(monkeypatch)
    else:
        _broken_twobody(monkeypatch, fault)
    res = _run("xmas172-structural")
    assert not res["correct"]
    assert res["check"]["moment_gap"]["value"] > res["check"]["moment_gap"]["limit"]


def test_freegas_left_unchanged_is_not_correct(monkeypatch):
    """The port's own free-gas misses the limit at the lowest energies (a
    fault of the program, which keeps free-gas out of every cell), so the
    check has to set the step left unchanged far apart from it."""
    from ndpp_tpu_torch import driver

    sound = _run("xmas172-structural", freegas=True, seconds=30.0)["check"]
    assert sound["rows_checked"]["value"] >= 1
    monkeypatch.setattr(driver, "apply_freegas", lambda scatter, *a, **k: scatter)
    res = _run("xmas172-structural", freegas=True, seconds=3.0)
    assert not res["correct"]
    gap = res["check"]["moment_gap"]
    assert gap["value"] > gap["limit"] and gap["value"] > 1e3 * sound["moment_gap"]["value"]


@pytest.mark.parametrize("freegas", [False, True])
def test_control_is_not_correct(freegas):
    _, _, config, traffic = _small("xmas172-structural", freegas)
    n = control.readings(config, traffic, SEED)
    from benchmark.reference import check

    assert {"moment_gap", "sigma_gap", "energy_gap"} <= set(check.failed(n, check.limits(config)))
    assert np.isfinite(n["moment_gap"])


def _run_continuum(seconds=3.0):
    torch.set_num_threads(2)
    manifest = json.loads((run_mod.ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic = continuum_fission()
    with tempfile.TemporaryDirectory() as d:
        return run_mod.run_cell(manifest, cell, config, traffic, SEED, seconds, False, "cpu", Path(d), join=True)


def test_continuum_and_fission_sound_run_is_correct():
    res = _run_continuum()
    assert res["correct"], res["check"]
    check = {k: v["value"] for k, v in res["check"].items()}
    assert check["chi_rows_checked"] > 0 and check["unreferenced"] == 0
    assert check["moment_gap"] < 1e-9 and check["chi_gap"] < 1e-13


def _continuum_fault(monkeypatch, fault):
    from ndpp_tpu_torch import continuum_driver, driver

    if fault == "reaction_left_out":
        inner = driver.batched_continuum_moments

        def broken(nuc, rxn_rows, *args, **kwargs):
            outs = inner(nuc, rxn_rows, *args, **kwargs)
            return [np.zeros_like(outs[0])] + outs[1:]

        monkeypatch.setattr(driver, "batched_continuum_moments", broken)
    elif fault == "cm_scaled":
        inner = continuum_driver.cm_moments_pointwise
        monkeypatch.setattr(continuum_driver, "cm_moments_pointwise", lambda *a, **k: inner(*a, **k) * (1.0 + 1e-7))
    else:
        inner = driver.chi_collapse

        def broken(res, *args, **kwargs):
            inner(res, *args, **kwargs)
            res.chi_total = res.chi_prompt.copy()

        monkeypatch.setattr(driver, "chi_collapse", broken)


@pytest.mark.parametrize("fault,number", [("reaction_left_out", "moment_gap"), ("cm_scaled", "moment_gap"),
                                          ("delayed_left_out", "chi_gap")])
def test_broken_continuum_or_chi_is_not_correct(monkeypatch, fault, number):
    _continuum_fault(monkeypatch, fault)
    res = _run_continuum()
    assert not res["correct"]
    assert res["check"][number]["value"] > res["check"][number]["limit"]


def test_control_fails_on_continuum_and_chi():
    _, config, traffic = continuum_fission()
    n = control.readings(config, traffic, SEED)
    from benchmark.reference import check

    assert {"moment_gap", "chi_gap"} <= set(check.failed(n, check.limits(config)))
