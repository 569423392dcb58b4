"""The work of the CM continuum moments of one family.continuum call (the
inner integral that cm_inner_kernel computes), counted from the problem:
the rows, their outgoing-energy tables, the group structure and the
quadrature the 1e-8 bar needs at the call's order. Never from the kernel's
launch arguments nor from the program's counters, so a later
implementation that integrates fewer panels is held to the same work.

A CM row at incident energy E maps its outgoing speeds y = sqrt(E'_cm),
on [y_lo, y_hi], to lab speeds w = sqrt(E'_lab) around s = sqrt(E)/(A+1).
The outer integral over w ends a panel at each knot image |y_k - s| and
y_k + s (the support's ends among them), at w = 0 where s lies inside the
support, and at each group boundary its lab window crosses. At a lab
speed w the inner integral over y spans [|w - s|, w + s] within the
support, cut at the knots inside it (a panel's knot set is fixed, since
its ends are the knot images) and, for tabulated angles, where it crosses
a tabulated cosine (counted at the panel's middle).

Nodes: OUTER_NODES a panel, inner_nodes(...) an inner panel. Operations a
node of the inner integral, as `chip_smoke.cm_bound` counts them (an FMA
2; a min, max, square root, exp, pow or division 1): 8 for y, its weight,
x, mu_lab and its clip; the energy density (2 tabulated, 5 N-body); the
angular density (Kalbach 28, tabulated 24, isotropic 0); 3 for the weight
and the P_0 sum, 2 for P_1 and 6 for each Bonnet step after it. Bytes:
each table a call reads, read once; e; the (L+1) x band moments of each
row written once, the band being the groups its lab window reaches.
"""

from __future__ import annotations

import math

import numpy as np

OUTER_NODES = 10
EDGE_RTOL = 1e-12


def inner_nodes(angular: str, order: int) -> int:
    """GL nodes an inner panel: a heavy target's inner window is narrower
    than one knot spacing, so one panel carries the whole Kalbach factor and
    P_L(mu_lab); 12 nodes at P5 (more above), 8 for tabulated angles, whose
    panels end at the cosines."""
    return 8 if angular == "tabular" else max(12, order + 7)


def per_node(energy: str, angular: str, order: int) -> int:
    p_e = 5 if energy == "nbody" else 2
    p_mu = {"kalbach": 28, "tabular": 24, "isotropic": 0}[angular]
    return 8 + p_e + p_mu + 3 + (2 if order >= 1 else 0) + 6 * max(order - 1, 0)


def _bracket(data, e: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(p, t) of each incident energy: the lower table and the weight of the
    next (0 under histogram interpolation)."""
    es = np.asarray(data.energies, dtype=np.float64)
    if es.size == 1:
        return np.zeros(e.size, dtype=np.int64), np.zeros(e.size)
    p = np.clip(np.searchsorted(es, e, side="right") - 1, 0, es.size - 2)
    hist = np.isscalar(data.int_law) and int(data.int_law) == 1
    t = np.zeros(e.size) if hist else np.clip((e - es[p]) / (es[p + 1] - es[p]), 0.0, 1.0)
    return p, t


def _unit(tb) -> np.ndarray:
    x = np.asarray(tb.e_out, dtype=np.float64)
    return (x - x[0]) / (x[-1] - x[0])


def _table_bytes(tb) -> int:
    n = tb.e_out.size * (2 + (tb.r is not None) + (tb.a is not None))
    for at in tb.angular or []:
        if at is not None:
            n += 2 * at.mu.size
    return 8 * n


def _outer_panels(y: np.ndarray, s: float, wb: np.ndarray) -> tuple[np.ndarray, float, float]:
    """(panel ends (P + 1,), lab window's ends in w) of one row: y its knots'
    speeds, ascending, wb the boundaries' speeds."""
    images = [np.abs(y - s), y + s]
    if y[0] < s < y[-1]:
        images.append(np.zeros(1))
    img = np.concatenate(images)
    w_lo, w_hi = float(img.min()), float(img.max())
    inside = wb[(wb > w_lo) & (wb < w_hi)]
    edges = np.unique(np.concatenate([img, inside]))
    # edges that meet in exact arithmetic (two knot images, or an image and
    # a boundary) end one panel, not two with a few ulps between them
    keep = np.concatenate([[True], np.diff(edges) > EDGE_RTOL * w_hi])
    return edges[keep], w_lo, w_hi


def _inner_panels(y: np.ndarray, s: float, wm: np.ndarray, cosines: np.ndarray) -> np.ndarray:
    """Inner panels at each outer panel's middle wm."""
    lo = np.maximum(np.abs(wm - s), y[0])
    hi = np.minimum(wm + s, y[-1])
    interior = y[1:-1]
    n = 1 + np.searchsorted(interior, hi, side="left") - np.searchsorted(interior, lo, side="right")
    if cosines.size:
        # y where mu_cm = m on the inner window: y^2 + 2 m s y - (w^2 - s^2) = 0
        m = cosines[None, :]
        c = (wm * wm - s * s)[:, None]
        disc = m * m * s * s + c
        r = np.sqrt(np.clip(disc, 0.0, None))
        for root in (-m * s + r, -m * s - r):
            ok = (disc >= 0) & (root > lo[:, None]) & (root < hi[:, None])
            n = n + ok.sum(axis=1)
    return np.where(hi > lo, n, 0)


def law_work(nuc, rxn, ed, e_rows, bounds: np.ndarray, order: int, clamp: bool) -> tuple[float, float]:
    """(flops, bytes) of one CM law of a reaction at these incident energies."""
    awr = float(nuc.awr)
    e = np.asarray(e_rows, dtype=np.float64)
    e = e[np.asarray(ed.applicability(e), dtype=np.float64) > 0]
    if e.size == 0:
        return 0.0, 0.0
    inner = bounds[1:-1] if clamp else bounds
    wb = np.sqrt(inner)
    lp1 = order + 1
    if ed.law == 66:
        energy, angular = "nbody", "isotropic"
        ap = float(ed.data.ap)
        emax = (ap - 1.0) / ap * (awr / (awr + 1.0) * e + float(rxn.q))
        rows = [(x, np.array([0.0, math.sqrt(m)]), np.zeros(0)) for x, m in zip(e, emax) if m > 0]
        nbytes = 8.0 * 4
    else:
        energy, angular = "tabular", ("kalbach" if ed.law == 44 else "tabular")
        data = ed.data
        p, t = _bracket(data, e)
        rows, used = [], set()
        for k in np.unique(p):
            t0, t1 = data.tables[k], data.tables[k + 1] if data.energies.size > 1 else data.tables[k]
            used.update((int(k), int(k) + 1 if data.energies.size > 1 else int(k)))
            u = np.unique(np.concatenate([_unit(t0), _unit(t1)]))
            mus = [np.array([-1.0, 1.0])] + [at.mu for tb in (t0, t1) for at in (tb.angular or []) if at is not None]
            cos = np.unique(np.concatenate(mus))[1:-1] if angular == "tabular" else np.zeros(0)
            for x, tt in zip(e[p == k], t[p == k]):
                lo = t0.e_out[0] + tt * (t1.e_out[0] - t0.e_out[0])
                hi = t0.e_out[-1] + tt * (t1.e_out[-1] - t0.e_out[-1])
                rows.append((x, np.sqrt(np.maximum(lo + u * (hi - lo), 0.0)), cos))
        nbytes = float(sum(_table_bytes(data.tables[k]) for k in used))
    nq_y, per = inner_nodes(angular, order), per_node(energy, angular, order)
    flops = 0.0
    for x, y, cos in rows:
        s = math.sqrt(x) / (awr + 1.0)
        edges, w_lo, w_hi = _outer_panels(y, s, wb)
        lo, hi = edges[:-1], edges[1:]
        live = hi > lo
        n_in = _inner_panels(y, s, 0.5 * (lo[live] + hi[live]), cos)
        flops += float(OUTER_NODES * nq_y * per * n_in.sum())
        band = 1 + int(np.count_nonzero((wb > w_lo) & (wb < w_hi)))
        nbytes += 8.0 * (1 + lp1 * min(band, bounds.size - 1))
    return flops, nbytes


def continuum_call_work(nuc, rxn_rows, bounds, order: int, clamp: bool) -> tuple[float, float]:
    """Work of one batched_continuum_moments call: its CM laws, each row of
    each reaction once."""
    bounds = np.asarray(bounds, dtype=np.float64)
    flops = nbytes = 0.0
    for rxn, e_rows in rxn_rows:
        for ed in rxn.energy_dists:
            if rxn.frame == "cm" and ed.law in (44, 61, 66):
                f, b = law_work(nuc, rxn, ed, e_rows, bounds, order, clamp)
                flops += f
                nbytes += b
    return flops, nbytes
