"""The reference's rows of one nuclide's library block, from the generator's
records: the incident grid, the total scattering cross section and, at the
sampled incident rows, the scattering moments of every temperature.

    scatter[T, E] = sum over scattering MTs of
                    sigma_MT(E) / sigma_s(E) y_MT(E) f_MT(E)

(y_MT the reaction's neutron yield where the configuration's
`include_yield` is on, 1 otherwise), with the free-gas replacement below
the cutoff where the configuration asks for them
(benchmark/reference/thermal.py). Each reaction goes to the reference of
its law: elastic and law 3 to twobody.py, the continuum laws to
continuum.py; a reaction with a law neither covers is left out of the sum
and counted (`unreferenced`). Plain NumPy and PyTorch; imports nothing of
the program.
"""

from __future__ import annotations

import numpy as np

from . import continuum, twobody


def scattering_reactions(nuc) -> list:
    """Elastic and every non-fission reaction with secondary neutrons."""
    out = [nuc.elastic]
    for mt in sorted(nuc.reactions):
        r = nuc.reactions[mt]
        if r.multiplicity != 0 and not r.is_fission:
            out.append(r)
    return out


def is_twobody(rxn) -> bool:
    return rxn.mt == 2 or (len(rxn.energy_dists) == 1 and rxn.energy_dists[0].law == 3)


def reaction_yield(rxn, e: float, include_yield: bool) -> float:
    """Neutrons out per reaction: the yield table, else the multiplicity."""
    if not include_yield:
        return 1.0
    if rxn.yield_tab is not None:
        return float(rxn.yield_tab(e))
    return float(rxn.multiplicity if rxn.multiplicity not in (0, 19) else 1)


def unreferenced(nuc) -> int:
    """Scattering reactions whose law no reference here covers."""
    return sum(1 for rxn in scattering_reactions(nuc) if not (is_twobody(rxn) or continuum.covered(rxn)))


def cross_sections(nuc) -> tuple[dict[int, np.ndarray], np.ndarray]:
    """sigma_MT on the nuclide's grid (zero below threshold), and their sum."""
    sig = {}
    for rxn in scattering_reactions(nuc):
        if rxn.mt == 2:
            sig[2] = nuc.sigma_el.astype(np.float64)
        else:
            full = np.zeros_like(nuc.energy)
            full[rxn.threshold_idx : rxn.threshold_idx + rxn.sigma.size] = rxn.sigma
            sig[rxn.mt] = full
    return sig, np.sum(list(sig.values()), axis=0)


def zero_kelvin_row(nuc, i: int, bounds, order, clamp, sig, sigma_s, dtype=np.float64, include_yield=True,
                    device="cpu") -> np.ndarray:
    """sum_MT w_MT y_MT f_MT at row i (the continuum laws' double integrals
    on `device`)."""
    e = float(nuc.energy[i])
    span = (float(nuc.energy[0]), float(nuc.energy[-1]))
    out = np.zeros((order + 1, bounds.size - 1), dtype=dtype)
    if sigma_s[i] <= 0:
        return out
    for rxn in scattering_reactions(nuc):
        w = sig[rxn.mt][i] / sigma_s[i]
        if w == 0:
            continue
        if not is_twobody(rxn):
            if continuum.covered(rxn):
                wy = w * reaction_yield(rxn, e, include_yield)
                out += dtype(wy) * continuum.moments(nuc, rxn, e, bounds, order, clamp, dtype, device)
            continue
        dist = nuc.elastic_angular if rxn.mt == 2 else rxn.angular
        q = 0.0 if rxn.mt == 2 else rxn.q
        out += dtype(w) * twobody.moments(e, nuc.awr, q, dist, bounds, order, clamp, span, dtype)
    return out


def elastic_row(nuc, i: int, bounds, order, clamp, dtype=np.float64) -> np.ndarray:
    """The unweighted 0 K elastic moments at row i."""
    span = (float(nuc.energy[0]), float(nuc.energy[-1]))
    return twobody.moments(float(nuc.energy[i]), nuc.awr, 0.0, nuc.elastic_angular, bounds, order, clamp,
                           span, dtype)
