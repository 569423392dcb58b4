"""Fission spectra collapsed to groups, and the nu arrays, at the incident
energies of a nuclide's grid (the chi incident grid is the nuclide's own),
from the records.

Definitions (those of the JAX package's `ndpp_tpu/chi_driver.py`, which
the port keeps):

    chi_prompt_g(E)  = sum over the fission reaction's laws of
                       p_law(E) frac_law,g(E)
    chi_delayed_g(E) = sum_k P_k(E) p_k(E) frac_k,g(E) / sum_k P_k(E)
                       (P_k, clipped at 0, the precursor group's
                       probability; p_k its spectrum's applicability; 0
                       where the P_k sum to 0)
    chi_total_g(E)   = [nu_p chi_prompt_g + nu_d chi_delayed_g] / nu_t
                       where the delayed spectra and all three nu exist,
                       chi_prompt otherwise
    nu_p, nu_d, nu_t the tables at E; a missing nu_p is nu_t - nu_d, a
                       missing nu_t is nu_p + nu_d

with frac_law,g(E) the integral over group g of the law's outgoing pdf:

  - law 4 (tabulated): the unit-base row of `continuum.Row` integrated
    exactly over each group (not renormalised);
  - laws 7 (Maxwell, sqrt(E') e^(-E'/T)), 9 (evaporation, E' e^(-E'/T))
    and 11 (Watt, e^(-E'/a) sinh(sqrt(b E'))), T, a, b tabulated in E:
    the spectrum restricted to E' <= E - U and normalised there (zero
    where E <= U). Integrated in y = sqrt(E'), where each is smooth, by
    Gauss-Legendre on panels cut at the group boundaries and no wider
    than a quarter of sqrt(T).

The group ends follow the scattering moments' convention: with clamping on,
everything below the second boundary falls in the first group and
everything above the last but one in the last. Plain NumPy in the
precision it is given.
"""

from __future__ import annotations

import numpy as np

from .continuum import Row, lab_group_integrals
from .data import gauss_legendre

FISSION_MTS = (18, 19, 20, 21, 38)
NQ = 16
TABULAR, ANALYTIC = {4}, {7, 9, 11}


def fission(nuc):
    for mt in FISSION_MTS:
        if mt in nuc.reactions:
            return nuc.reactions[mt]
    return None


def spectra(nuc) -> list:
    """Every spectrum the collapse reads: the prompt laws, then the delayed."""
    rxn = fission(nuc)
    if rxn is None or not rxn.energy_dists:
        return []
    return list(rxn.energy_dists) + (list(nuc.delayed_spectra) if nuc.precursors else [])


def unreferenced(nuc) -> int:
    """Spectra whose law this module does not collapse."""
    return sum(1 for ed in spectra(nuc)
               if ed.law not in TABULAR | ANALYTIC or (ed.law in TABULAR and any(t.nd for t in ed.data.tables)))


def _raw(law: int, y: np.ndarray, theta: float, b: float) -> np.ndarray:
    """The spectrum's density in y = sqrt(E'), 2 y f(y^2), unnormalised."""
    x = y * y
    if law == 7:
        return 2.0 * y * y * np.exp(-x / theta)
    if law == 9:
        return 2.0 * y * x * np.exp(-x / theta)
    return 2.0 * y * np.exp(-x / theta) * np.sinh(np.sqrt(b) * y)


def analytic_fractions(law: int, e: float, theta: float, b: float, u: float, bounds, clamp: bool,
                       dtype=np.float64, nq: int = NQ) -> np.ndarray:
    """(G,) group fractions of an analytic spectrum at incident energy e."""
    ng = bounds.size - 1
    out = np.zeros(ng, dtype=dtype)
    emax = max(e - u, 0.0)
    if emax <= 0:
        return out
    eff = bounds.astype(np.float64).copy()
    if clamp:
        eff[0], eff[-1] = -np.inf, np.inf
    ymax = np.sqrt(emax)
    cuts = np.sqrt(np.clip(eff, 0.0, emax))
    # the partition of [0, ymax]: below the first boundary, each group, above the last
    edges = np.concatenate([[0.0], cuts, [ymax]])
    owner = np.concatenate([[-1], np.arange(ng), [-1]])
    width = 0.25 * np.sqrt(theta)
    lo, hi, grp = [], [], []
    for a, c, g in zip(edges[:-1], edges[1:], owner):
        if c > a:
            n = int(np.ceil((c - a) / width))
            pts = np.linspace(a, c, n + 1)
            lo.append(pts[:-1])
            hi.append(pts[1:])
            grp.append(np.full(n, g))
    lo, hi, grp = (np.concatenate(v).astype(dt) for v, dt in ((lo, dtype), (hi, dtype), (grp, np.int64)))
    xg, wg = gauss_legendre(nq, dtype)
    half = dtype(0.5) * (hi - lo)
    y = (dtype(0.5) * (lo + hi))[:, None] + half[:, None] * xg[None, :]
    seg = np.sum(half[:, None] * wg[None, :] * _raw(law, y, dtype(theta), dtype(b)), axis=1)
    total = seg.sum()
    if total <= 0:
        return out
    inside = grp >= 0
    np.add.at(out, grp[inside], seg[inside] / total)
    return out


def law_fractions(ed, e: float, bounds, clamp: bool, dtype=np.float64) -> np.ndarray:
    """(G,) frac_law,g(E) of one spectrum, unweighted by its applicability."""
    d = ed.data
    if ed.law in ANALYTIC:
        theta = float((d.theta if d.theta is not None else d.a_tab)(e))
        b = float(d.b_tab(e)) if d.b_tab is not None else 0.0
        return analytic_fractions(ed.law, e, theta, b, float(d.restriction_u or 0.0), bounds, clamp, dtype)
    return lab_group_integrals(Row(d, e, 4), bounds, clamp, dtype)


def nu(nuc, energy: np.ndarray) -> dict:
    """The nu arrays on the grid, as the collapse completes them."""
    nu_t = nuc.nu_total(energy) if nuc.nu_total is not None else None
    nu_d = nuc.nu_delayed(energy) if nuc.nu_delayed is not None else None
    nu_p = nuc.nu_prompt(energy) if nuc.nu_prompt is not None else None
    if nu_p is None and nu_t is not None and nu_d is not None:
        nu_p = nu_t - nu_d
    if nu_t is None and nu_p is not None:
        nu_t = nu_p + (nu_d if nu_d is not None else 0.0)
    return {k: v for k, v in (("nu_prompt", nu_p), ("nu_delayed", nu_d), ("nu_total", nu_t)) if v is not None}


def rows(nuc, rows_idx, bounds, clamp: bool, dtype=np.float64) -> dict:
    """{(key, i): (G,)} for chi_prompt, chi_delayed and chi_total at the
    given rows of the nuclide's grid."""
    rxn = fission(nuc)
    out = {}
    if rxn is None or not rxn.energy_dists:
        return out
    nus = nu(nuc, nuc.energy)
    delayed_on = bool(nuc.precursors and nuc.delayed_spectra)
    for i in rows_idx:
        e = float(nuc.energy[i])
        prompt = np.zeros(bounds.size - 1, dtype=dtype)
        for ed in rxn.energy_dists:
            p = float(np.clip(ed.applicability(e), 0.0, 1.0))
            if p > 0:
                prompt += dtype(p) * law_fractions(ed, e, bounds, clamp, dtype)
        out[("chi_prompt", i)] = prompt
        delayed = None
        if delayed_on:
            delayed = np.zeros_like(prompt)
            pk = [max(float(prec.probability(e)), 0.0) for prec in nuc.precursors]
            for w, ed in zip(pk, nuc.delayed_spectra):
                p = w * float(np.clip(ed.applicability(e), 0.0, 1.0))
                if p > 0:
                    delayed += dtype(p) * law_fractions(ed, e, bounds, clamp, dtype)
            psum = sum(pk)
            delayed = delayed / dtype(psum) if psum > 0 else np.zeros_like(prompt)
            out[("chi_delayed", i)] = delayed
        if delayed is not None and {"nu_prompt", "nu_delayed", "nu_total"} <= set(nus):
            out[("chi_total", i)] = ((dtype(nus["nu_prompt"][i]) * prompt + dtype(nus["nu_delayed"][i]) * delayed)
                                     / dtype(nus["nu_total"][i]))
        else:
            out[("chi_total", i)] = prompt
    return out
