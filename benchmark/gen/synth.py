"""Seeded synthetic nuclides for the benchmark's decks.

The helpers below are a frozen copy of the port's fixture generator
(ndpp_tpu_torch/host/ace/synth.py: the grid, cross-section and angular
helpers). The nuclide builder is the
generator's `stress_nuclide` pattern made general: every size (awr, base
grid points, resonance count, level count, angular tables) comes from a
catalog entry of the configuration, and the seed draws only the values
(resonance energies and widths, level energies and cross sections,
anisotropy). So every seed gives the same set of sizes.

The nuclides are NOT evaluations of real nuclides: names say what they
stand for.
"""

from __future__ import annotations

import numpy as np

from . import interp as interp_mod
from .records import (
    AngularDistribution,
    AngularTable,
    EnergyDistribution,
    LawData,
    Nuclide,
    Reaction,
    Tab1,
)

_ROOM_KT_EV = 2.53e-2  # ~293.6 K
E_MIN_EV, E_MAX_EV = 1e-5, 2e7


def _loggrid(emin: float, emax: float, n: int) -> np.ndarray:
    return np.exp(np.linspace(np.log(emin), np.log(emax), n))


def _norm_linlin(mu: np.ndarray, pdf: np.ndarray) -> np.ndarray:
    return pdf / np.trapezoid(pdf, mu)


def _legendre_pdf(mu: np.ndarray, coeffs: list[float]) -> np.ndarray:
    """p(mu) = 1/2 * (1 + sum_l (2l+1) c_l P_l(mu)), clipped positive, normalized."""
    p = np.polynomial.legendre.legval(mu, [1.0] + [(2 * (l + 1) + 1) * c for l, c in enumerate(coeffs)]) * 0.5
    p = np.clip(p, 1e-12, None)
    return _norm_linlin(mu, p)


def _angular_vs_energy(
    energies: np.ndarray, coeff_fn, n_mu: int = 41, encodings: str = "tabular"
) -> AngularDistribution:
    mu = np.linspace(-1.0, 1.0, n_mu)
    tables, encs = [], []
    for e in energies:
        pdf = _legendre_pdf(mu, coeff_fn(e))
        if encodings == "equiprobable":
            cdf = interp_mod.trapz_pdf_to_cdf(mu, pdf)
            cdf /= cdf[-1]
            bounds = np.interp(np.linspace(0.0, 1.0, 33), cdf, mu)
            bounds[0], bounds[-1] = -1.0, 1.0
            tables.append(AngularTable.from_equiprobable(bounds))
            encs.append("equiprobable")
        else:
            tables.append(AngularTable.from_tabulated(2, mu, pdf))
            encs.append("tabular")
    return AngularDistribution(energies=energies, tables=tables, encodings=encs)


def _full_applicability(emin: float, emax: float) -> Tab1:
    return Tab1(np.array([emin, emax]), np.array([1.0, 1.0]))


def _resonant_sigma(e: np.ndarray, base: float, resonances: list[tuple[float, float, float]]) -> np.ndarray:
    """base + sum of Lorentzian peaks (E0 eV, Gamma eV, peak barns)."""
    s = np.full_like(e, base)
    for e0, gamma, peak in resonances:
        s = s + peak * (gamma / 2) ** 2 / ((e - e0) ** 2 + (gamma / 2) ** 2)
    return s


def _grid_with_resonances(emin, emax, n_base, resonances) -> np.ndarray:
    g = [_loggrid(emin, emax, n_base)]
    for e0, gamma, _ in resonances:
        g.append(e0 + gamma * np.linspace(-8, 8, 33))
    grid = np.unique(np.concatenate(g))
    return grid[(grid >= emin) & (grid <= emax)]


def twobody_nuclide(name: str, spec: dict, rng: np.random.Generator) -> Nuclide:
    """Elastic plus `spec["levels"]` discrete inelastic levels (law 3, CM
    frame), and 1/v capture. Sizes from `spec`, values from `rng`:

      awr, zaid            the nuclide it stands for
      n_base               log-grid points from 1e-5 eV to 20 MeV
      resonances           Lorentzian peaks, 33 grid points each
      levels               discrete levels (MT 51, 52, ...)
      level_mev            [first, last] level excitation (MeV): the seed
                           draws the levels' energies between them
      angular_tables       elastic angular tables (41 cosines each)
      sigma_el_base        smooth elastic base (barns)
      isotropic_elastic    LAND = 0 (isotropic in the CM frame)

    Every fourth level uses the 32-equiprobable-bin angular encoding and
    every third is isotropic, so both encodings and LAND = 0 stay on the path.
    """
    a = float(spec["awr"])
    n_res = int(spec.get("resonances", 0))
    centres = np.sort(np.exp(rng.uniform(np.log(1.0), np.log(1e5), n_res)))
    # widths under a sixteenth of the centre keep every grid point above 0.5 eV
    resonances = [
        (float(e0), float(min(np.exp(rng.uniform(0.0, 5.0)), e0 / 16.0)), float(rng.uniform(10, 400)))
        for e0 in centres
    ]
    # keep resonances apart, so the grid has the same size on every seed
    for i in range(1, len(resonances)):
        e0, g0, p0 = resonances[i]
        lo = resonances[i - 1][0] + 16.0 * (resonances[i - 1][1] + g0)
        resonances[i] = (max(e0, lo), g0, p0)
    e = _grid_with_resonances(E_MIN_EV, E_MAX_EV, int(spec["n_base"]), resonances)
    sig_el = _resonant_sigma(e, float(spec.get("sigma_el_base", 10.0)) * rng.uniform(0.8, 1.25), resonances)
    sig_a = float(rng.uniform(0.01, 5.0)) / np.sqrt(e / _ROOM_KT_EV)
    n_ang = int(spec.get("angular_tables", 6))
    ang_e = np.exp(np.linspace(np.log(E_MIN_EV), np.log(E_MAX_EV), n_ang))
    aniso = float(rng.uniform(0.1, 0.6))
    ang = None
    if not spec.get("isotropic_elastic", False):
        ang = _angular_vs_energy(
            ang_e, lambda ev: [aniso * min(ev / E_MAX_EV, 1.0), 0.3 * aniso * min(ev / E_MAX_EV, 1.0)]
        )
    zaid = int(spec["zaid"])
    nuc = Nuclide(
        name=name,
        zaid=zaid,
        awr=a,
        kT=_ROOM_KT_EV,
        energy=e,
        sigma_t=sig_el + sig_a,
        sigma_a=sig_a,
        sigma_el=sig_el,
        heating=np.zeros_like(e),
        elastic_angular=ang,
    )
    n_lev = int(spec.get("levels", 0))
    if n_lev:
        lo, hi = (float(x) * 1e6 for x in spec["level_mev"])
        # the first level where the evaluation has it, the rest drawn above it
        excit = np.concatenate([[lo], np.sort(rng.uniform(lo, hi, n_lev - 1))])
        for il, ex in enumerate(excit):
            q = -float(ex)
            thresh = abs(q) * (a + 1.0) / a
            mask = e > thresh
            idx = int(np.argmax(mask))
            erel = (e[mask] - thresh) / (E_MAX_EV - thresh)
            lev_aniso = float(rng.uniform(0.0, 0.4))
            angular = None
            if il % 3 != 2:
                angular = _angular_vs_energy(
                    np.array([thresh, thresh * 2, E_MAX_EV]), lambda ev, s=lev_aniso: [s * min(ev / E_MAX_EV, 1.0)],
                    encodings="equiprobable" if il % 4 == 3 else "tabular",
                )
            mt = 51 + il
            nuc.reactions[mt] = Reaction(
                mt=mt, q=q, frame="cm", multiplicity=1, threshold_idx=idx,
                sigma=float(rng.uniform(0.05, 1.2)) * np.sqrt(np.clip(erel, 0, None)) * np.exp(-2.0 * erel),
                angular=angular,
                energy_dists=[EnergyDistribution(
                    law=3, applicability=_full_applicability(thresh, E_MAX_EV),
                    data=LawData(law=3, c1=abs(q) * (a + 1.0) / a, c2=(a / (a + 1.0)) ** 2),
                )],
            )
    nuc.reactions[102] = Reaction(mt=102, q=7.0e6, frame="lab", multiplicity=0, threshold_idx=0, sigma=sig_a)
    sig_sum = nuc.sigma_a + nuc.sigma_el
    for mt, r in nuc.reactions.items():
        if mt != 102:
            sig_sum = sig_sum + nuc.sigma_on_grid(r)
    nuc.sigma_t = sig_sum
    return nuc
