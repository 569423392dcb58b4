"""Continuum secondary-energy laws: the (L+1) x G lab moments of one
reaction at one incident energy, from the records.

    f_{l,g}(E) = sum over the reaction's laws of p_law(E) times
                 integral over E', mu of p(E' | E) q(mu | E, E') P_l(mu_lab)
                 on the set whose lab energy lies in group g

The data definition (the JAX package's host preparation, which its oracle
and the port both read; written again here from the records):

  - between two tabulated incident energies E_p <= E <= E_p+1 the outgoing
    table is the unit-base interpolation: with t = (E - E_p)/(E_p+1 - E_p)
    (0 under histogram incident interpolation) and xi the unit-base
    variable of each table, E' = lo + xi span (ends interpolated linearly
    in t) and p(E') = [(1-t) span_p f_p(xi) + t span_p+1 f_p+1(xi)] / span;
    a histogram table's steps are kept as steps;
  - law 44 (Kalbach-Mann): r and a interpolate as (1-t) r_p(xi) + t
    r_p+1(xi), and q(mu) = a / (2 sinh a) [cosh(a mu) + r sinh(a mu)];
  - law 61: each outgoing knot's angular table, normalised, interpolates
    linearly in xi between the table's own knots, then in t; in the lab
    frame through its Legendre moments, in the CM frame as a pdf in mu;
  - law 66 (N-body phase space, CM): p(E') = C sqrt(E') (Emax - E')^(3n/2-4)
    with Emax = (Ap - 1)/Ap (A/(A+1) E + Q), isotropic;
  - law 4 in the lab: angles from the AND block (the two-body reference's
    `data.pdf_at`), separable from E'.

CM laws map to the lab with the neutron's mass 1 and the centre of mass
moving at s = sqrt(E)/(A+1) (energies in eV, speeds in sqrt(eV)): with
y = sqrt(E'_cm) and nu = 1 + mu_cm, E'_lab = (y - s)^2 + 2 s y nu and
mu_lab = (nu y - (y - s)) / sqrt(E'_lab). For fixed y the lab energy is
linear in nu, so every group is one nu interval, cut where a group
boundary falls. The double integral is outer over y and inner over nu,
every edge exact: the outer panels end at the outgoing-energy knots, at
y = s (where E'_lab reaches 0 and mu_lab at nu = 0 turns from +1 to -1),
and at each y where a group boundary meets nu = 0, nu = 2 or a tabulated
cosine (there the inner integral has a kink); the inner panels end at the
group boundaries and the tabulated cosines. Where y nears s, mu_lab has a
branch point at nu* = -(y - s)^2 / (2 s y), just below nu = 0: the inner
edges are graded towards it, nu* + (2 - nu*) 4^-k, and the outer edges
towards y = s, s (1 -+ 4^-k), k = 1..20. Each
panel takes a Gauss-Legendre rule of fixed order, on which its integrand
is smooth. The
N-body law's (Emax - E')^(1/2) end is taken out by y = sqrt(Emax) sin th.
Lab laws are one integral over E' of a product of two piecewise linear
functions: a rule of 4 points on each piece is exact.

Plain NumPy and PyTorch in the precision it is given, on the device it is
given (the CM integral runs in blocks of outer nodes); it imports nothing
of either package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .data import eval_limit, gauss_legendre, legendre, linlin, pdf_at
from .freegas import _legendre_t

NQ_OUTER, NQ_INNER = 16, 16
POINTS_PER_BLOCK = 1 << 22  # quadrature points of one block of the CM integral
GRADES = 20  # inner edges graded geometrically towards E'_lab = 0

COVERED = {(44, "cm"), (61, "cm"), (66, "cm"), (61, "lab"), (4, "lab")}


def covered(rxn) -> bool:
    """Whether every law of the reaction is one this module integrates
    (and carries no discrete lines, which no deck holds)."""
    for ed in rxn.energy_dists:
        if (ed.law, rxn.frame) not in COVERED:
            return False
        if ed.data.tables is not None and any(t.nd for t in ed.data.tables):
            return False
    return bool(rxn.energy_dists)


# --------------------------------------------------------------------------
# the outgoing-energy row at one incident energy


def _bracket(data, e: float) -> tuple[int, int, float]:
    """(p, p + 1, t): the two tables and the weight of the second."""
    es = data.energies
    if es.size == 1:
        return 0, 0, 0.0
    p = int(np.clip(np.searchsorted(es, e, side="right") - 1, 0, es.size - 2))
    hist = np.isscalar(data.int_law) and int(data.int_law) == 1
    t = 0.0 if hist else float(np.clip((e - es[p]) / (es[p + 1] - es[p]), 0.0, 1.0))
    return p, p + 1, t


def _steps(x: np.ndarray, v: np.ndarray, intt: int) -> tuple[np.ndarray, np.ndarray]:
    """A histogram's values as steps on duplicated knots (as `data.linlin`)."""
    if intt == 2:
        return x, v
    xs = np.repeat(x, 2)[1:-1]
    vs = np.repeat(v[:-1], 2)
    return xs, vs


class Row:
    """p(E' | E) and its angular payload on segments of E' (one incident
    energy): ends x0, x1 (S,), pdf at each end p0, p1 (S,), and per law
    the payload at each end."""

    def __init__(self, data, e: float, law: int):
        i1, i2, t = _bracket(data, e)
        tabs = [data.tables[i1], data.tables[i2]]
        w = [1.0 - t, t]
        reps = []
        for tb in tabs:
            x, y = _steps(tb.e_out, tb.pdf, tb.intt)
            span = tb.e_out[-1] - tb.e_out[0]
            reps.append((x, y, (x - x[0]) / span, span))
        u = np.unique(np.concatenate([r[2] for r in reps]))
        lo = tabs[0].e_out[0] + t * (tabs[1].e_out[0] - tabs[0].e_out[0])
        hi = tabs[0].e_out[-1] + t * (tabs[1].e_out[-1] - tabs[0].e_out[-1])
        span = hi - lo
        self.x0, self.x1 = lo + u[:-1] * span, lo + u[1:] * span
        ends = (u[:-1], "right"), (u[1:], "left")
        self.p0, self.p1 = (sum(wi * r[3] * eval_limit(r[2], r[1], q, side) for wi, r in zip(w, reps)) / span
                            for q, side in ends)
        self.law = law
        if law == 44:
            for name in ("r", "a"):
                vals = []
                for q, side in ends:
                    acc = 0.0
                    for wi, tb, r in zip(w, tabs, reps):
                        xs, vs = _steps(tb.e_out, getattr(tb, name), tb.intt)
                        acc = acc + wi * eval_limit((xs - xs[0]) / r[3], vs, q, side)
                    vals.append(acc)
                setattr(self, name + "0", vals[0])
                setattr(self, name + "1", vals[1])
            self.a0, self.a1 = np.maximum(self.a0, 1e-12), np.maximum(self.a1, 1e-12)
        elif law == 61:
            self._law61(tabs, w, (u[:-1], u[1:]))

    def _law61(self, tabs, w, ends) -> None:
        """Each original outgoing knot's normalised angular table, linear in
        xi between the table's own knots, as pdf values on the row's cosine
        knots at both ends of each segment (mu_knots; A0, A1: (S, KMU));
        `moments_of` gives the same as Legendre moments."""
        mus = [np.array([-1.0, 1.0])]
        for tb in tabs:
            for at in tb.angular or []:
                if at is not None:
                    mus.append(linlin(at)[0])
        self.mu_knots = np.unique(np.concatenate(mus))
        self._per_knot = []
        for tb in tabs:
            src = (tb.e_out - tb.e_out[0]) / (tb.e_out[-1] - tb.e_out[0])
            tables = []
            for at in tb.angular or [None] * tb.e_out.size:
                if at is None:
                    tables.append((np.array([-1.0, 1.0]), np.array([0.5, 0.5])))
                else:
                    x, y = linlin(at)
                    tables.append((x, y / np.sum(0.5 * (y[1:] + y[:-1]) * np.diff(x))))
            self._per_knot.append((src, tables))
        self._w, self._ends = w, ends
        pdfs = [np.stack([np.interp(self.mu_knots, x, y) for x, y in tables]) for _, tables in self._per_knot]
        self.A0, self.A1 = (sum(wi * np.stack([np.interp(q, src, pk[:, m]) for m in range(self.mu_knots.size)], -1)
                                for wi, (src, _), pk in zip(w, self._per_knot, pdfs)) for q in ends)

    def moments_of(self, order: int) -> tuple[np.ndarray, np.ndarray]:
        """Law 61 in the lab: the Legendre moments at both ends, (S, L+1)."""
        out = []
        for q in self._ends:
            acc = 0.0
            for wi, (src, tables) in zip(self._w, self._per_knot):
                m = np.stack([exact_moments(x, y, order) for x, y in tables])  # (K, L+1)
                acc = acc + wi * np.stack([np.interp(q, src, m[:, l]) for l in range(order + 1)], -1)
            out.append(acc)
        return out[0], out[1]


def exact_moments(x: np.ndarray, y: np.ndarray, order: int) -> np.ndarray:
    """integral of a piecewise linear (x, y) times P_l, l = 0..order."""
    xg, wg = gauss_legendre(max(order // 2 + 2, 2))
    lo, hi = x[:-1], x[1:]
    keep = hi > lo
    lo, hi, y0, y1 = lo[keep], hi[keep], y[:-1][keep], y[1:][keep]
    half, mid = 0.5 * (hi - lo), 0.5 * (hi + lo)
    pts = mid[:, None] + half[:, None] * xg[None, :]
    f = y0[:, None] + (pts - lo[:, None]) / (hi - lo)[:, None] * (y1 - y0)[:, None]
    return np.einsum("pq,pql->l", half[:, None] * wg[None, :] * f, legendre(pts, order))


# --------------------------------------------------------------------------
# lab laws: one integral over E'


def _lab(x0, x1, p0, p1, m0, m1, bounds, order, clamp, dtype) -> np.ndarray:
    """integral over each group of p(E') M_l(E'), both linear on each
    segment [x0, x1] (m0, m1: (S, L+1))."""
    ng = bounds.size - 1
    out = np.zeros((order + 1, ng), dtype=dtype)
    eff = bounds.astype(dtype).copy()
    if clamp:
        eff[0], eff[-1] = -np.inf, np.inf
    x0, x1, p0, p1, m0, m1 = (np.asarray(a, dtype=dtype) for a in (x0, x1, p0, p1, m0, m1))
    fin = eff[np.isfinite(eff)]
    edges = np.unique(np.concatenate([x0, x1, fin[(fin > x0.min()) & (fin < x1.max())]]))
    lo, hi = edges[:-1], edges[1:]
    mid = dtype(0.5) * (lo + hi)
    seg = np.searchsorted(x0, mid, side="right") - 1
    ok = (seg >= 0) & (mid < x1[np.clip(seg, 0, None)]) & (hi > lo)
    g = np.searchsorted(eff, mid, side="right") - 1
    ok &= (g >= 0) & (g < ng)
    lo, hi, seg, g = lo[ok], hi[ok], seg[ok], g[ok]
    xg, wg = gauss_legendre(4, dtype)
    half = dtype(0.5) * (hi - lo)
    pts = (dtype(0.5) * (lo + hi))[:, None] + half[:, None] * xg[None, :]
    frac = (pts - x0[seg][:, None]) / (x1[seg] - x0[seg])[:, None]
    p = p0[seg][:, None] + frac * (p1[seg] - p0[seg])[:, None]
    m = m0[seg][:, None, :] + frac[:, :, None] * (m1[seg] - m0[seg])[:, None, :]
    per = np.einsum("pq,pql->pl", half[:, None] * wg[None, :] * p, m)
    np.add.at(out.T, g, per)
    return out


def lab_group_integrals(row: Row, bounds, clamp, dtype=np.float64) -> np.ndarray:
    """(G,) group integrals of the row's pdf (the chi of a tabulated spectrum)."""
    one = np.ones((row.x0.size, 1))
    return _lab(row.x0, row.x1, row.p0, row.p1, one, one, bounds, 0, clamp, dtype)[0]


def and_moments(rxn, e: float, order: int) -> np.ndarray:
    """Legendre moments of the AND block's p(mu | E) (isotropic if none)."""
    if rxn.angular is None:
        out = np.zeros(order + 1)
        out[0] = 1.0
        return out
    x, y = pdf_at(rxn.angular, e, 0.0, 0.0)
    return exact_moments(x, y, order)


# --------------------------------------------------------------------------
# CM laws: outer over y = sqrt(E'_cm), inner over nu = 1 + mu_cm


def _roots(s: float, fb: np.ndarray, cosines: np.ndarray) -> np.ndarray:
    """y > 0 where E'_lab(y, mu) = b for each boundary b and cosine mu."""
    m = cosines[:, None]
    disc = fb[None, :] - s * s * (1.0 - m * m)
    r = np.sqrt(np.clip(disc, 0.0, None))
    ys = np.concatenate([(-m * s - r)[disc >= 0], (-m * s + r)[disc >= 0]])
    return ys[ys > 0]


def _cm(row, s: float, bounds, order: int, clamp: bool, dtype, device, nbody=None,
        nq=(NQ_OUTER, NQ_INNER)) -> np.ndarray:
    """The CM double integral of one row. nbody = (emax, expo) for law 66."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    dev = torch.device(device)
    ng = bounds.size - 1
    eff = bounds.astype(np.float64).copy()
    if clamp:
        eff[0], eff[-1] = -np.inf, np.inf
    fb = eff[np.isfinite(eff)]
    law = 66 if nbody is not None else row.law
    cos_knots = np.array([-1.0, 1.0]) if law != 61 else row.mu_knots
    # y = s (E'_lab reaches 0), graded towards from both sides, and the y
    # where a boundary meets a cosine
    ladder = 0.25 ** np.arange(1, GRADES + 1)
    roots = np.concatenate([[s], s * (1.0 - ladder), s * (1.0 + ladder), _roots(s, fb, cos_knots)])
    xo, wo = gauss_legendre(nq[0], np.float64)
    if nbody is not None:
        emax, expo = nbody
        ymax = math.sqrt(emax)
        th = np.unique(np.concatenate([[0.0, 0.5 * math.pi], np.arcsin(np.clip(roots[roots < ymax] / ymax, 0, 1))]))
        lo, hi = th[:-1], th[1:]
        keep = hi > lo
        lo, hi = lo[keep], hi[keep]
        half = 0.5 * (hi - lo)
        tht = (0.5 * (lo + hi))[:, None] + half[:, None] * xo[None, :]
        y = ymax * np.sin(tht)
        cnorm = 1.0 / (math.exp(math.lgamma(1.5) + math.lgamma(expo + 1.0) - math.lgamma(expo + 2.5))
                       * emax ** (expo + 1.5))
        wy = (half[:, None] * wo[None, :]) * 2.0 * cnorm * y * y * (ymax * np.cos(tht)) ** (2.0 * expo) \
            * ymax * np.cos(tht)
        y, wy = y.ravel(), wy.ravel()
        seg = np.zeros(y.size, dtype=np.int64)
    else:
        ok = row.x1 > row.x0
        x0, x1, p0, p1 = row.x0[ok], row.x1[ok], row.p0[ok], row.p1[ok]
        yk = np.sqrt(np.concatenate([x0, x1]))
        ylo, yhi = yk.min(), yk.max()
        edges = np.unique(np.concatenate([yk, roots[(roots > ylo) & (roots < yhi)]]))
        lo, hi = edges[:-1], edges[1:]
        mid = 0.5 * (lo + hi)
        sg = np.searchsorted(x0, mid * mid, side="right") - 1
        keep = (hi > lo) & (sg >= 0) & (mid * mid < x1[np.clip(sg, 0, None)])
        lo, hi, sg = lo[keep], hi[keep], sg[keep]
        half = 0.5 * (hi - lo)
        y = (0.5 * (lo + hi))[:, None] + half[:, None] * xo[None, :]
        x = y * y
        frac = (x - x0[sg][:, None]) / (x1[sg] - x0[sg])[:, None]
        p = p0[sg][:, None] + frac * (p1[sg] - p0[sg])[:, None]
        wy = (half[:, None] * wo[None, :]) * 2.0 * y * p
        seg = np.broadcast_to(sg[:, None], y.shape).ravel()
        frac = frac.ravel()
        y, wy = y.ravel(), wy.ravel()
        idx = np.flatnonzero(wy != 0)
        y, wy, seg, frac = y[idx], wy[idx], seg[idx], frac[idx]
        okidx = np.flatnonzero(ok)
        if law == 44:
            r = row.r0[okidx][seg] + frac * (row.r1[okidx][seg] - row.r0[okidx][seg])
            a = row.a0[okidx][seg] + frac * (row.a1[okidx][seg] - row.a0[okidx][seg])
        elif law == 61:
            amu = row.A0[okidx][seg] + frac[:, None] * (row.A1[okidx][seg] - row.A0[okidx][seg])
    out = torch.zeros((ng, order + 1), dtype=tdt, device=dev)
    if y.size == 0:
        return out.T.cpu().numpy().astype(dtype)
    # inner breakpoints a node: the boundaries strictly inside its lab range, the interior cosines, the ends
    a_lab, b_lab = (y - s) ** 2, (y + s) ** 2
    i0 = np.searchsorted(fb, a_lab, side="right")
    i1 = np.searchsorted(fb, b_lab, side="left")
    n_cos = cos_knots.size - 2
    per_node = (i1 - i0) + n_cos + GRADES + 1  # panels a node, at most
    cum = np.cumsum(per_node)
    budget = max(POINTS_PER_BLOCK // nq[1], 1)
    xi_, wi_ = (torch.as_tensor(v, dtype=tdt, device=dev) for v in gauss_legendre(nq[1], np.float64))
    t_eff = torch.as_tensor(eff, dtype=tdt, device=dev)
    t_fb = torch.as_tensor(fb, dtype=tdt, device=dev)
    t_cos = torch.as_tensor(1.0 + cos_knots[1:-1], dtype=tdt, device=dev)
    t_muk = torch.as_tensor(cos_knots, dtype=tdt, device=dev)
    t_grades = torch.as_tensor(0.25 ** np.arange(1, GRADES + 1), dtype=tdt, device=dev)
    start = 0
    while start < y.size:
        stop = int(np.searchsorted(cum, (cum[start - 1] if start else 0) + budget, side="right"))
        stop = min(max(stop, start + 1), y.size)
        sl = slice(start, stop)
        n = stop - start
        ty = torch.as_tensor(y[sl], dtype=tdt, device=dev)
        tw = torch.as_tensor(wy[sl], dtype=tdt, device=dev)
        c = torch.as_tensor(i1[sl] - i0[sl], device=dev)
        first = torch.as_tensor(i0[sl], device=dev)
        node_b = torch.repeat_interleave(torch.arange(n, device=dev), c)
        offs = torch.cumsum(c, 0) - c
        k = torch.arange(node_b.numel(), device=dev) - offs[node_b] + first[node_b]
        yb = ty[node_b]
        nu_b = (t_fb[k] - (yb - s) ** 2) / (2.0 * s * yb)
        nodes = [node_b, torch.arange(n, device=dev), torch.arange(n, device=dev)]
        vals = [nu_b, torch.zeros(n, dtype=tdt, device=dev), torch.full((n,), 2.0, dtype=tdt, device=dev)]
        if n_cos:
            nodes.append(torch.arange(n, device=dev).repeat_interleave(n_cos))
            vals.append(t_cos.repeat(n))
        star = -((ty - s) ** 2) / (2.0 * s * ty)
        nodes.append(torch.arange(n, device=dev).repeat_interleave(GRADES))
        vals.append((star[:, None] + (2.0 - star)[:, None] * t_grades[None, :]).reshape(-1))
        nid, nu = torch.cat(nodes), torch.cat(vals).clamp(0.0, 2.0)
        order_nu = torch.argsort(nu, stable=True)
        nid, nu = nid[order_nu], nu[order_nu]
        order_id = torch.argsort(nid, stable=True)
        nid, nu = nid[order_id], nu[order_id]
        same = nid[1:] == nid[:-1]
        lo_t, hi_t, pid = nu[:-1][same], nu[1:][same], nid[:-1][same]
        keep = hi_t > lo_t
        lo_t, hi_t, pid = lo_t[keep], hi_t[keep], pid[keep]
        yp = ty[pid]
        d2 = (yp - s) ** 2
        half_t = 0.5 * (hi_t - lo_t)
        mid_t = 0.5 * (hi_t + lo_t)
        g = torch.searchsorted(t_eff, (d2 + 2.0 * s * yp * mid_t).contiguous(), right=True) - 1
        inside = (g >= 0) & (g < ng)
        lo_t, hi_t, pid, yp, d2, half_t, mid_t, g = (v[inside] for v in (lo_t, hi_t, pid, yp, d2, half_t, mid_t, g))
        nu_q = mid_t[:, None] + half_t[:, None] * xi_[None, :]  # (P, Q)
        elab = d2[:, None] + 2.0 * s * yp[:, None] * nu_q
        mul = ((nu_q * yp[:, None] - (yp[:, None] - s)) / torch.sqrt(elab.clamp_min(1e-300))).clamp(-1.0, 1.0)
        mu = nu_q - 1.0
        if law == 44:
            ta = torch.as_tensor(a[sl], dtype=tdt, device=dev)[pid][:, None]
            tr = torch.as_tensor(r[sl], dtype=tdt, device=dev)[pid][:, None]
            q = ta / (2.0 * torch.sinh(ta)) * (torch.cosh(ta * mu) + tr * torch.sinh(ta * mu))
        elif law == 61:
            tam = torch.as_tensor(amu[sl], dtype=tdt, device=dev)  # (n, KMU)
            cell = (torch.searchsorted(t_muk, (mid_t - 1.0).contiguous(), right=True) - 1).clamp(0, t_muk.numel() - 2)
            m0, m1 = t_muk[cell][:, None], t_muk[cell + 1][:, None]
            v0, v1 = tam[pid, cell][:, None], tam[pid, cell + 1][:, None]
            q = v0 + (mu - m0) / (m1 - m0) * (v1 - v0)
        else:
            q = torch.full_like(mu, 0.5)
        wq = (tw[pid] * half_t)[:, None] * wi_[None, :] * q
        per = torch.einsum("pq,pql->pl", wq, _legendre_t(mul, order))
        out.index_add_(0, g, per)
        start = stop
    return out.T.cpu().numpy().astype(dtype)


# --------------------------------------------------------------------------
# one reaction


def law_moments(nuc, rxn, ed, e: float, bounds, order: int, clamp: bool, dtype=np.float64, device="cpu",
                nq=(NQ_OUTER, NQ_INNER)) -> np.ndarray:
    """(L+1, G) moments of one law of a reaction at incident energy e,
    unweighted by its applicability."""
    law, frame = ed.law, rxn.frame
    s = math.sqrt(e) / (nuc.awr + 1.0)
    if law == 66:
        a = nuc.awr
        ap = float(ed.data.ap)
        emax = (ap - 1.0) / ap * (a / (a + 1.0) * e + rxn.q)
        if emax <= 0:
            return np.zeros((order + 1, bounds.size - 1), dtype=dtype)
        return _cm(None, s, bounds, order, clamp, dtype, device, nbody=(emax, 1.5 * ed.data.npsx - 4.0), nq=nq)
    row = Row(ed.data, e, law)
    if frame == "cm":
        return _cm(row, s, bounds, order, clamp, dtype, device, nq=nq)
    if law == 61:
        m0, m1 = row.moments_of(order)
    else:  # law 4: the AND block's moments, the same at every E'
        m = and_moments(rxn, e, order)
        m0 = m1 = np.broadcast_to(m, (row.x0.size, order + 1))
    return _lab(row.x0, row.x1, row.p0, row.p1, m0, m1, bounds, order, clamp, dtype)


def moments(nuc, rxn, e: float, bounds, order: int, clamp: bool, dtype=np.float64, device="cpu",
            nq=(NQ_OUTER, NQ_INNER)) -> np.ndarray:
    """(L+1, G) moments of one continuum reaction at incident energy e: its
    laws weighted by their applicabilities."""
    out = np.zeros((order + 1, bounds.size - 1), dtype=dtype)
    for ed in rxn.energy_dists:
        p = float(np.clip(ed.applicability(e), 0.0, 1.0))
        if p > 0:
            out += dtype(p) * law_moments(nuc, rxn, ed, e, bounds, order, clamp, dtype, device, nq)
    return out
