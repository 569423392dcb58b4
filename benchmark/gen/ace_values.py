"""Records rounded to the values their ACE files hold.

ACE stores 13 significant digits, energies in MeV. The port parses the
files; the reference reads the records. Rounding every written array of
the records as the writer and a parser would (value -> text -> value) gives
both sides the same numbers, bit for bit, so a difference between them
comes from the computation and never from the file.
"""

from __future__ import annotations

import numpy as np

from .records import AngularTable, MEV_TO_EV

_EV = 1.0 / MEV_TO_EV


def _round(v: np.ndarray, scale: float, digits: int = 12) -> np.ndarray:
    """v * scale written with `digits` decimals in E format, read, / scale."""
    a = np.asarray(v, dtype=np.float64)
    flat = [float(format(x * scale, f".{digits}E")) for x in a.ravel()]
    return (np.asarray(flat) / scale).reshape(a.shape)


def energy(v):  # eV in memory, MeV in the file: parse multiplies by 1e6
    a = np.asarray(v, dtype=np.float64)
    flat = [float(format(x * _EV, ".12E")) * MEV_TO_EV for x in a.ravel()]
    return np.asarray(flat).reshape(a.shape)


def value(v):
    return _round(v, 1.0)


def _angular(dist):
    if dist is None:
        return None
    dist.energies = energy(dist.energies)
    tables = []
    for t, enc in zip(dist.tables, dist.encodings):
        if enc == "equiprobable":
            tables.append(AngularTable.from_equiprobable(value(t.mu)))
        else:
            tables.append(AngularTable(interp=t.interp, mu=value(t.mu), pdf=value(t.pdf), cdf=value(t.cdf)))
    dist.tables = tables
    return dist


def nuclide(nuc):
    """Round a two-body nuclide's written arrays in place; returns it."""
    nuc.kT = float(format(nuc.kT * _EV, ".4E")) * MEV_TO_EV
    nuc.energy = energy(nuc.energy)
    for k in ("sigma_t", "sigma_a", "sigma_el", "heating"):
        setattr(nuc, k, value(getattr(nuc, k)))
    nuc.elastic_angular = _angular(nuc.elastic_angular)
    for r in nuc.reactions.values():
        r.q = float(energy(r.q))
        r.sigma = value(r.sigma)
        r.angular = _angular(r.angular)
        for ed in r.energy_dists:
            ed.applicability.x = energy(ed.applicability.x)
            ed.applicability.y = value(ed.applicability.y)
            if ed.law == 3:
                ed.data.c1 = float(energy(ed.data.c1))
                ed.data.c2 = float(value(ed.data.c2))
    return nuc
