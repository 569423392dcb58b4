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
from .write import SHAKE

_EV = 1.0 / MEV_TO_EV


def _through(v, to_file, from_file):
    """What a parser reads back of v written as to_file(v) in E format with
    12 decimals and read as from_file(text): the writer's and the parser's
    own operations."""
    a = np.asarray(v, dtype=np.float64)
    flat = [from_file(float(format(to_file(x), ".12E"))) for x in a.ravel()]
    return np.asarray(flat).reshape(a.shape)


def energy(v):  # eV in memory, MeV in the file: parse multiplies by 1e6
    return _through(v, lambda x: x * _EV, lambda x: x * MEV_TO_EV)


def value(v):
    return _through(v, lambda x: x, lambda x: x)


def density(v):  # 1/eV in memory, 1/MeV in the file
    return _through(v, lambda x: x / _EV, lambda x: x / MEV_TO_EV)


def _tab1(tab, yfile=value):
    if tab is not None:
        tab.x, tab.y = energy(tab.x), yfile(tab.y)
    return tab


def _angular_table(t):
    return None if t is None else AngularTable(interp=t.interp, mu=value(t.mu), pdf=value(t.pdf), cdf=value(t.cdf))


def _law_data(ed):
    """One law's payload, rounded as the writer writes it and the parser reads it."""
    d = ed.data
    if ed.law == 3:
        d.c1, d.c2 = float(energy(d.c1)), float(value(d.c2))
    elif ed.law in (4, 44, 61):
        d.energies = energy(d.energies)
        for t in d.tables:
            if t.nd:
                raise ValueError("discrete lines (ND > 0) are not generated")
            t.e_out, t.pdf, t.cdf = energy(t.e_out), density(t.pdf), value(t.cdf)
            if t.r is not None:
                t.r, t.a = value(t.r), value(t.a)
            if t.angular is not None:
                t.angular = [_angular_table(at) for at in t.angular]
    elif ed.law in (7, 9):
        d.theta = _tab1(d.theta, energy)
        d.restriction_u = float(energy(d.restriction_u or 0.0))
    elif ed.law == 11:
        d.a_tab = _tab1(d.a_tab, energy)
        d.b_tab = _tab1(d.b_tab, lambda y: _through(y, lambda x: x / _EV, lambda x: x * (1.0 / MEV_TO_EV)))
        d.restriction_u = float(energy(d.restriction_u or 0.0))
    elif ed.law == 66:
        d.ap = float(value(d.ap))
    else:
        raise ValueError(f"no rounding for law {ed.law}")


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
    """Round a nuclide's written arrays in place; returns it."""
    nuc.kT = float(format(nuc.kT * _EV, ".4E")) * MEV_TO_EV
    nuc.energy = energy(nuc.energy)
    for k in ("sigma_t", "sigma_a", "sigma_el", "heating"):
        setattr(nuc, k, value(getattr(nuc, k)))
    nuc.elastic_angular = _angular(nuc.elastic_angular)
    for r in nuc.reactions.values():
        r.q = float(energy(r.q))
        r.sigma = value(r.sigma)
        r.angular = _angular(r.angular)
        r.yield_tab = _tab1(r.yield_tab)
        for ed in r.energy_dists:
            _tab1(ed.applicability)
            _law_data(ed)
    for nu in (nuc.nu_prompt, nuc.nu_total, nuc.nu_delayed):
        if nu is not None:
            if nu.form != "tabular":
                raise ValueError("only tabular nu is generated")
            _tab1(nu.tab)
    for prec in nuc.precursors:
        prec.decay_const = float(_through(prec.decay_const, lambda x: x * SHAKE, lambda x: x / SHAKE))
        _tab1(prec.probability)
    for ed in nuc.delayed_spectra:
        _tab1(ed.applicability)
        _law_data(ed)
    return nuc
