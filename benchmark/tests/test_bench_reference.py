"""The continuum and chi reference on the CPU: against the JAX package's
adaptive oracles at a few groups, against itself with every panel's node
count doubled, and against what follows from the definitions (P0 sums to
the yield, Kalbach with a -> 0 is isotropic, the Maxwell fractions' closed
form)."""

from __future__ import annotations

import math
import tempfile
import warnings
from pathlib import Path

import numpy as np
import pytest

from benchmark.gen import deck as deck_mod
from benchmark.gen.records import ContinuousTable, EnergyDistribution, LawData, Reaction, Tab1
from benchmark.reference import check, chi as ref_chi, continuum as ref_cont, nuclide as ref_nuc
from benchmark.tests.small_decks import continuum_fission

SEED = 2**31 + 99
FOUR = np.array([1e-5, 1e5, 1e6, 3e6, 2e7])  # four groups across the outgoing spectra


@pytest.fixture(scope="module")
def deck():
    cell, config, traffic = continuum_fission()
    return deck_mod.build(config, traffic, SEED)


@pytest.fixture(scope="module")
def ace_dir(deck):
    with tempfile.TemporaryDirectory() as d:
        deck_mod.write(deck, Path(d))
        yield Path(d)


def _jax_prep(ace_dir, name, mt, ed_index, e, order, delayed=False):
    from ndpp_tpu.host.ace import read_ace
    from ndpp_tpu.host.prep_continuum import prepare_continuum

    jn = read_ace(ace_dir / f"{name}.ace")
    rxn = jn.reactions[mt]
    ed = jn.delayed_spectra[ed_index] if delayed else rxn.energy_dists[ed_index]
    return jn, prepare_continuum(jn, rxn, ed, np.array([e]), order)


# Tolerances, at the row's scale (max |r|):
#   CM laws 1e-9: the oracle's nested scipy quad stops at epsrel 1e-10 and
#     epsabs 1e-11 (outer) / 1e-12 (inner) per group and order;
#   lab laws and tabulated spectra 1e-13: the oracle's quad runs to epsrel
#     1e-12 / 1e-13 on integrands both sides take as exact piecewise
#     polynomials;
#   analytic spectra 1e-12: the oracle's quad runs to epsrel 1e-13 on the
#     raw spectrum and on its norm, which the fraction divides.
CM_CASES = [("92235.80c", 16, 1.2e7, 1e-9), ("4009.80c", 16, 2.5e6, 1e-9), ("1002.80c", 16, 8e6, 1e-9)]


@pytest.mark.parametrize("name,mt,e,tol", CM_CASES, ids=["kalbach44", "law61cm", "nbody66"])
def test_cm_laws_match_the_oracle(deck, ace_dir, name, mt, e, tol):
    oracle = pytest.importorskip("ndpp_tpu.oracle.continuum")
    jn, prep = _jax_prep(ace_dir, name, mt, 0, e, 1)
    bounds = FOUR if name != "4009.80c" else FOUR[[0, 2, 3, 4]]  # law 61: three groups keep the oracle under a minute
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        o = oracle.cm_moments_oracle(prep, 0, e, jn.awr, bounds, 1, True)
    nuc = deck.nuclides[name]
    rxn = nuc.reactions[mt]
    r = ref_cont.law_moments(nuc, rxn, rxn.energy_dists[0], e, bounds, 1, True)
    assert check.row_gap(r, o) < tol


@pytest.mark.parametrize("name,mt", [("92235.80c", 91), ("4009.80c", 22)], ids=["law4lab", "law61lab"])
def test_lab_laws_match_the_oracle(deck, ace_dir, name, mt):
    oracle = pytest.importorskip("ndpp_tpu.oracle.continuum")
    bounds = check.group_bounds("uniform-lethargy-47")[::4]
    nuc = deck.nuclides[name]
    rxn = nuc.reactions[mt]
    for e in (float(nuc.energy[-1]), 1.1e7):
        _, prep = _jax_prep(ace_dir, name, mt, 0, e, 3)
        o = oracle.lab_tabular_moments_oracle(prep, 0, bounds, 3, True)
        r = ref_cont.law_moments(nuc, rxn, rxn.energy_dists[0], e, bounds, 3, True)
        assert check.row_gap(r, o) < 1e-13


@pytest.mark.parametrize("name,k,delayed", [("92235.80c", 0, False), ("92235.80c", 1, True), ("92238.80c", 0, False),
                                            ("92238.80c", 1, False)], ids=["law4", "delayed4", "law9", "law11"])
def test_spectra_match_the_oracle(deck, ace_dir, name, k, delayed):
    oracle = pytest.importorskip("ndpp_tpu.oracle.chi")
    bounds = check.group_bounds("uniform-lethargy-47")[::2]
    nuc = deck.nuclides[name]
    ed = nuc.delayed_spectra[k] if delayed else ref_chi.fission(nuc).energy_dists[k]
    for e in (1e-5, 2.5e6, 2e7):
        _, prep = _jax_prep(ace_dir, name, 18, k, e, 0, delayed)
        if prep.kind == "lab-analytic":
            o = oracle.analytic_group_fractions_oracle(e, float(prep.extra["theta"][0]), float(prep.extra["b"][0]),
                                                       prep.extra["u"], bounds, ed.law, True)
            tol = 1e-12
        else:
            o = oracle.tabular_group_fractions_oracle(prep.e_knots[0], prep.pdf[0], bounds, True)
            tol = 1e-13
        assert check.row_gap(ref_chi.law_fractions(ed, e, bounds, True), o) < tol


@pytest.mark.parametrize("bounds", [FOUR, check.group_bounds("uniform-lethargy-47")], ids=["G4", "G47"])
def test_doubling_the_nodes_moves_no_row(deck, bounds):
    """Every panel's rule doubled, outer and inner: no row moves by more
    than 1e-11 of its scale."""
    for nuc in deck.nuclides.values():
        for rxn in ref_nuc.scattering_reactions(nuc):
            if ref_nuc.is_twobody(rxn):
                continue
            thresh = float(rxn.energy_dists[0].applicability.x[0])
            for e in (thresh * 1.05, 0.5 * (thresh + 2e7), 2e7):
                a = ref_cont.moments(nuc, rxn, e, bounds, 3, True)
                b = ref_cont.moments(nuc, rxn, e, bounds, 3, True,
                                     nq=(2 * ref_cont.NQ_OUTER, 2 * ref_cont.NQ_INNER))
                assert check.row_gap(a, b) < 1e-11, (nuc.name, rxn.mt, e)


def test_p0_sums_to_the_yield(deck):
    """With clamping every neutron lands in some group: a continuum law's P0
    sums to its pdf's norm (1 to the tables' rounding), and a row's P0 to the
    yield-weighted sum of the reactions' shares."""
    bounds = check.group_bounds("uniform-lethargy-47")
    for nuc in deck.nuclides.values():
        sig, sigma_s = ref_nuc.cross_sections(nuc)
        i = nuc.energy.size - 1
        e = float(nuc.energy[i])
        want = 0.0
        for rxn in ref_nuc.scattering_reactions(nuc):
            w = sig[rxn.mt][i] / sigma_s[i]
            want += w * ref_nuc.reaction_yield(rxn, e, True)
            if not ref_nuc.is_twobody(rxn):
                assert abs(ref_cont.moments(nuc, rxn, e, bounds, 1, True)[0].sum() - 1.0) < 1e-11
        row = ref_nuc.zero_kelvin_row(nuc, i, bounds, 1, True, sig, sigma_s)
        assert want > 1.0 and abs(row[0].sum() - want) < 1e-11 * want


def _flat_law(law: int, frame: str, a: float = 0.0):
    """One tabulated E' spectrum, twice, as law 44 with slope a or law 61
    with isotropic angles."""
    eo = np.linspace(0.0, 2e6, 21)
    pdf = eo * np.exp(-eo / 4e5)
    pdf /= np.trapezoid(pdf, eo)
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(eo))])
    extra = {"r": np.full(eo.size, 0.4), "a": np.full(eo.size, a)} if law == 44 else {"angular": [None] * eo.size}
    tables = [ContinuousTable(intt=2, nd=0, e_out=eo, pdf=pdf, cdf=cdf, **extra) for _ in range(2)]
    data = LawData(law=law, energies=np.array([1e6, 2e7]), tables=tables)
    ed = EnergyDistribution(law=law, applicability=Tab1(np.array([1e6, 2e7]), np.ones(2)), data=data)
    return Reaction(mt=91, q=-1e6, frame=frame, multiplicity=1, energy_dists=[ed], angular_in_dlw=True)


def test_kalbach_with_no_slope_is_isotropic():
    nuc = type("N", (), {"awr": 55.454})()
    bounds = check.group_bounds("uniform-lethargy-47")
    iso = _flat_law(61, "cm")
    for a, tol in ((1e-12, 1e-12), (1e-6, 1e-6)):
        kal = _flat_law(44, "cm", a)
        for e in (2e6, 1.4e7):
            r_iso = ref_cont.law_moments(nuc, iso, iso.energy_dists[0], e, bounds, 3, True)
            r_kal = ref_cont.law_moments(nuc, kal, kal.energy_dists[0], e, bounds, 3, True)
            assert check.row_gap(r_kal, r_iso) < tol


def _maxwell_cumulative(x, theta):
    """int_0^x sqrt(t) exp(-t/theta) dt."""
    z = math.sqrt(x / theta)
    return theta**1.5 * (0.5 * math.sqrt(math.pi) * math.erf(z) - z * math.exp(-z * z))


@pytest.mark.parametrize("u", [-2e7, 0.0, 3e6])
def test_maxwell_fractions_match_the_closed_form(u):
    bounds = check.group_bounds("uniform-lethargy-47")
    theta = 1.3e6
    for e in (1e-5, 5e6, 2e7):
        got = ref_chi.analytic_fractions(7, e, theta, 0.0, u, bounds, True)
        emax = e - u
        if emax <= 0:
            assert not got.any()
            continue
        cut = np.clip(np.concatenate([[0.0], bounds[1:-1], [emax]]), 0.0, emax)
        cum = np.array([_maxwell_cumulative(x, theta) for x in cut])
        want = np.diff(cum) / cum[-1]
        assert check.row_gap(got, want) < 1e-13
