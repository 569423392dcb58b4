"""Continuum and fission reactions of a catalog entry, on top of the
elastic channel and the discrete levels that synth.twobody_nuclide builds.

The shapes follow the port's fixtures (ndpp_tpu_torch/host/ace/synth.py:
`kalbach_like`, `law61_like`, `law61cm_like`, `nbody_like`, `u235_like`,
`_analytic_chi_like`), written again here as frozen copies, with every size
taken from the entry and every value drawn from the entry's stream, after
the two-body draws. An entry without the keys below draws nothing more, so
its nuclide is the one twobody_nuclide made.

  continuum   a list of reactions, each:
      mt, law          44 (Kalbach-Mann), 61 (tabulated angle per outgoing
                       energy), 66 (N-body phase space) or 4 (outgoing
                       energy only; angles from the AND block)
      frame            "cm" or "lab"
      multiplicity     neutrons out (the yield)
      threshold_mev    where the cross section starts
      incident         tabulated incident energies, threshold to 20 MeV
      outgoing         outgoing-energy points a table (laws 4, 44, 61)
      cosines          cosines a table: law 61's angular tables (every
                       third outgoing point isotropic), law 4's AND
                       tables (0: isotropic)
      npsx, ap         law 66: particles and their total mass ratio
  fission     MT 18 and its neutrons:
      laws             prompt spectrum laws: [4] tabulated, or analytic 7
                       (Maxwell), 9 (evaporation), 11 (Watt); two laws
                       share the incident range by linear applicabilities
      incident         tabulated incident energies of the spectrum
      outgoing         outgoing points a law-4 table
      restriction_mev  U of the analytic laws (E' <= E - U)
      thermal_barns, fast_barns, threshold_mev   the cross section's shape
      nu               points of the prompt, delayed and total nu tables
      precursors       delayed groups, each with a law-4 spectrum of
      delayed_incident incident energies and
      delayed_outgoing outgoing points
"""

from __future__ import annotations

import numpy as np

from . import interp as interp_mod
from .records import (
    AngularTable,
    ContinuousTable,
    EnergyDistribution,
    LawData,
    NuBar,
    Precursor,
    Reaction,
    Tab1,
)
from .synth import E_MAX_EV, E_MIN_EV, _ROOM_KT_EV, _angular_vs_energy, _full_applicability, _legendre_pdf

FISSION_Q_EV = 193.7e6
# decay constants (1/s) of the six delayed groups of U-235 (Keepin)
DECAY_CONSTANTS = [0.0124, 0.0305, 0.111, 0.301, 1.14, 3.01]


def _table(eo: np.ndarray, pdf: np.ndarray, **extra) -> ContinuousTable:
    pdf = pdf / np.trapezoid(pdf, eo)
    return ContinuousTable(intt=2, nd=0, e_out=eo, pdf=pdf, cdf=interp_mod.trapz_pdf_to_cdf(eo, pdf), **extra)


def _outgoing(emax: float, n: int) -> np.ndarray:
    """n outgoing energies from 0 to emax, denser at the low end."""
    return emax * np.linspace(0.0, 1.0, n) ** 2


def continuum_reaction(nuc, spec: dict, rng: np.random.Generator) -> Reaction:
    """One continuum reaction of the entry (sizes from spec, values from rng)."""
    a = float(nuc.awr)
    law, frame = int(spec["law"]), spec["frame"]
    thresh = float(spec["threshold_mev"]) * 1e6
    e = nuc.energy
    mask = e > thresh
    idx = int(np.argmax(mask))
    erel = (e[mask] - thresh) / (E_MAX_EV - thresh)
    sigma = float(rng.uniform(0.05, 1.5)) * erel * np.exp(-erel)
    rxn = Reaction(mt=int(spec["mt"]), q=-thresh * a / (a + 1.0), frame=frame,
                   multiplicity=int(spec["multiplicity"]), threshold_idx=idx, sigma=sigma)
    applicability = _full_applicability(thresh, E_MAX_EV)
    if law == 66:
        rxn.angular_in_dlw = True
        data = LawData(law=66, npsx=int(spec["npsx"]), ap=float(spec["ap"]))
        rxn.energy_dists = [EnergyDistribution(law=66, applicability=applicability, data=data)]
        return rxn
    inc = np.exp(np.linspace(np.log(thresh), np.log(E_MAX_EV), int(spec["incident"])))
    n_out, n_mu = int(spec["outgoing"]), int(spec.get("cosines", 0))
    temp = float(rng.uniform(0.15, 0.35))  # evaporation temperature, a share of emax
    r0, r1 = float(rng.uniform(0.0, 0.2)), float(rng.uniform(0.2, 0.6))
    a0, a1 = float(rng.uniform(0.1, 0.5)), float(rng.uniform(1.0, 3.0))
    c1, c2 = float(rng.uniform(0.1, 0.5)), float(rng.uniform(0.0, 0.2))
    mu = np.linspace(-1.0, 1.0, max(n_mu, 2))
    tables = []
    for einc in inc:
        emax = max((einc - thresh) * a / (a + 1.0), 5e4)
        eo = _outgoing(emax, n_out)
        xi = eo / emax
        pdf = eo * np.exp(-eo / (temp * emax))
        if law == 44:
            tables.append(_table(eo, pdf, r=r0 + r1 * xi, a=a0 + a1 * xi))
        elif law == 61:
            ang: list[AngularTable | None] = [
                None if j % 3 == 0 else AngularTable.from_tabulated(2, mu, _legendre_pdf(mu, [c1 * x, c2 * x]))
                for j, x in enumerate(xi)
            ]
            tables.append(_table(eo, pdf, angular=ang))
        elif law == 4:
            tables.append(_table(eo, pdf))
        else:
            raise ValueError(f"MT={spec['mt']}: no generator for law {law}")
    if law == 4:
        if n_mu:
            rxn.angular = _angular_vs_energy(inc, lambda ev: [c1 * min(ev / E_MAX_EV, 1.0)], n_mu=n_mu)
    else:
        rxn.angular_in_dlw = True
    rxn.energy_dists = [EnergyDistribution(law=law, applicability=applicability,
                                           data=LawData(law=law, energies=inc, tables=tables))]
    return rxn


def _watt(eo: np.ndarray, a_ev: float, b_per_ev: float) -> np.ndarray:
    return np.exp(-eo / a_ev) * np.sinh(np.sqrt(np.clip(b_per_ev * eo, 0, None)))


def _prompt_law(law: int, spec: dict, rng: np.random.Generator) -> LawData:
    inc = np.exp(np.linspace(np.log(E_MIN_EV), np.log(E_MAX_EV), int(spec["incident"])))
    u = float(spec.get("restriction_mev", 0.0)) * 1e6
    if law == 4:
        a_ev, hard, b = float(rng.uniform(0.95e6, 1.03e6)), float(rng.uniform(0.01, 0.03)), 2.249e-6
        eo = np.exp(np.linspace(np.log(1e2), np.log(3e7), int(spec["outgoing"])))
        return LawData(law=4, energies=inc, tables=[_table(eo, _watt(eo, a_ev + hard * e, b)) for e in inc])
    if law in (7, 9):
        t0 = float(rng.uniform(1.2e6, 1.4e6)) if law == 7 else float(rng.uniform(0.9e6, 1.0e6))
        theta = t0 * (1.0 + 0.05 * inc / E_MAX_EV)
        return LawData(law=law, theta=Tab1(inc, theta), restriction_u=u)
    if law == 11:
        a_ev = float(rng.uniform(0.95e6, 1.0e6)) * (1.0 + 0.1 * inc / E_MAX_EV)
        b = float(rng.uniform(2.6e-6, 2.9e-6)) * (1.0 - 0.08 * inc / E_MAX_EV)
        return LawData(law=11, a_tab=Tab1(inc, a_ev), b_tab=Tab1(inc, b), restriction_u=u)
    raise ValueError(f"no fission spectrum generator for law {law}")


def add_fission(nuc, spec: dict, rng: np.random.Generator) -> None:
    """MT 18 with its prompt spectrum, the nu tables, the delayed groups."""
    e = nuc.energy
    thresh = float(spec.get("threshold_mev", 0.0)) * 1e6
    idx = int(np.argmax(e > thresh)) if thresh > 0 else 0
    ef = e[idx:]
    sig_f = (float(spec["fast_barns"]) * float(rng.uniform(0.8, 1.25)) * (1.0 - np.exp(-(ef - thresh) / 1e6))
             if thresh > 0 else np.full_like(ef, float(spec["fast_barns"]) * float(rng.uniform(0.8, 1.25))))
    sig_f = sig_f + float(spec.get("thermal_barns", 0.0)) * float(rng.uniform(0.8, 1.25)) / np.sqrt(
        ef / _ROOM_KT_EV) * np.exp(-ef / 1e3)
    laws = [int(x) for x in spec["laws"]]
    if len(laws) == 1:
        apps = [_full_applicability(E_MIN_EV, E_MAX_EV)]
    else:  # two laws share the range: one fades out as the other fades in
        ends = np.array([E_MIN_EV, E_MAX_EV])
        apps = [Tab1(ends, np.array([1.0, 0.0])), Tab1(ends, np.array([0.0, 1.0]))]
    dists = [EnergyDistribution(law=law, applicability=app, data=_prompt_law(law, spec, rng))
             for law, app in zip(laws, apps)]
    nuc.reactions[18] = Reaction(mt=18, q=FISSION_Q_EV, frame="lab", multiplicity=19, threshold_idx=idx,
                                 sigma=sig_f, angular=None, energy_dists=dists)
    nu_e = np.exp(np.linspace(np.log(E_MIN_EV), np.log(E_MAX_EV), int(spec["nu"])))
    nu_p = float(rng.uniform(2.40, 2.90)) + float(rng.uniform(0.10, 0.16)) * nu_e / 1e6
    nu_d = float(rng.uniform(0.015, 0.045)) * np.where(nu_e < 4e6, 1.0, 1.0 - 0.5 * (nu_e - 4e6) / (E_MAX_EV - 4e6))
    nuc.nu_prompt = NuBar(form="tabular", tab=Tab1(nu_e, nu_p))
    nuc.nu_delayed = NuBar(form="tabular", tab=Tab1(nu_e, nu_d))
    nuc.nu_total = NuBar(form="tabular", tab=Tab1(nu_e, nu_p + nu_d))
    n_prec = int(spec["precursors"])
    ends = np.array([E_MIN_EV, E_MAX_EV])
    fr = rng.uniform(0.5, 1.5, (2, n_prec))
    fr /= fr.sum(axis=1, keepdims=True)
    d_inc = np.exp(np.linspace(np.log(E_MIN_EV), np.log(E_MAX_EV), int(spec["delayed_incident"])))
    eo = np.exp(np.linspace(np.log(1e2), np.log(2e6), int(spec["delayed_outgoing"])))
    for k in range(n_prec):
        lam = DECAY_CONSTANTS[k % len(DECAY_CONSTANTS)]
        nuc.precursors.append(Precursor(decay_const=lam, probability=Tab1(ends, fr[:, k].copy())))
        t0 = float(rng.uniform(0.3e6, 0.5e6)) * (1.0 + lam)
        data = LawData(law=4, energies=d_inc,
                       tables=[_table(eo, eo * np.exp(-eo / (t0 * (1.0 + 0.02 * j)))) for j in range(d_inc.size)])
        nuc.delayed_spectra.append(EnergyDistribution(law=4, applicability=_full_applicability(E_MIN_EV, E_MAX_EV),
                                                      data=data))
    full = np.zeros_like(e)
    full[idx:] = sig_f
    nuc.sigma_a = nuc.sigma_a + full
    nuc.sigma_t = nuc.sigma_t + full


def add_families(nuc, spec: dict, rng: np.random.Generator) -> None:
    """The entry's continuum reactions and fission block, if it has them."""
    for rs in spec.get("continuum", []):
        rxn = continuum_reaction(nuc, rs, rng)
        if rxn.mt in nuc.reactions or rxn.mt == 2:
            raise ValueError(f"{nuc.name}: MT={rxn.mt} given twice")
        nuc.reactions[rxn.mt] = rxn
        nuc.sigma_t = nuc.sigma_t + nuc.sigma_on_grid(rxn)
    if "fission" in spec:
        add_fission(nuc, spec["fission"], rng)
