"""Two-body (elastic and discrete-level) group transfer moments of one
incident energy, by exact-breakpoint Gauss-Legendre quadrature.

    f_{l,g}(E) = integral over mu_cm of p(mu_cm | E) P_l(mu_lab(mu_cm))
                 on the set of mu_cm whose lab energy lies in group g

E'_lab is linear in mu_cm (E'_lab = base + slope mu_cm), so each group is
one mu_cm interval. Its ends and the pdf's knots cut [-1, 1] into panels on
which the integrand is smooth, and a 32-point rule (the program uses 16)
integrates each to roundoff. Near mu_cm = -1 a light target's lab energy
goes to nearly 0 and mu_lab behaves as sqrt(1 + mu_cm) (exactly so at
A = 1), so the panel at -1 is graded geometrically towards it, down to
4^-16 of its width. Plain NumPy, in the precision it is given.
"""

from __future__ import annotations

import numpy as np

from .data import gauss_legendre, legendre, pdf_at

NQ = 32
GRADES = 16  # geometric sub-panels of the panel at mu_cm = -1


def constants(awr: float, q: float) -> tuple[float, float]:
    """(c1, c2) with E_cm' = c2 (E - c1): c1 the threshold, c2 the mass factor."""
    return abs(q) * (awr + 1.0) / awr, (awr / (awr + 1.0)) ** 2


def moments(
    e: float, awr: float, q: float, dist, bounds: np.ndarray, order: int, clamp: bool = True,
    e_span: tuple[float, float] = (1e-5, 2e7), dtype=np.float64,
) -> np.ndarray:
    """(L+1, G) moments of one two-body reaction at incident energy e."""
    ng = bounds.size - 1
    out = np.zeros((order + 1, ng), dtype=dtype)
    c1, c2 = constants(awr, q)
    e = dtype(e)
    ecm = dtype(c2) * (e - dtype(c1))
    if ecm <= 0:
        return out
    x, y = pdf_at(dist, float(e), *e_span)
    x, y = x.astype(dtype), y.astype(dtype)
    ap1 = dtype(awr + 1.0)
    base = ecm + e / ap1**2
    slope = dtype(2.0) * np.sqrt(e * ecm) / ap1
    b = bounds.astype(dtype)
    brk = np.clip((b - base) / slope, dtype(-1.0), dtype(1.0))
    edges = np.unique(np.concatenate([x[(x > -1) & (x < 1)], brk, np.array([-1.0, 1.0], dtype=dtype)]))
    graded = dtype(-1.0) + (edges[1] + dtype(1.0)) * dtype(0.25) ** np.arange(1, GRADES + 1, dtype=dtype)
    edges = np.unique(np.concatenate([edges, graded]))
    lo, hi = edges[:-1], edges[1:]
    keep = hi > lo
    lo, hi = lo[keep], hi[keep]
    mid = dtype(0.5) * (lo + hi)
    half = dtype(0.5) * (hi - lo)
    j = np.clip(np.searchsorted(x, mid, side="right") - 1, 0, x.size - 2)
    e_mid = base + slope * mid
    eff = b.copy()
    if clamp:
        eff[0], eff[-1] = -np.inf, np.inf
    g = np.searchsorted(eff, e_mid, side="right") - 1
    inside = (g >= 0) & (g < ng)
    xg, wg = gauss_legendre(NQ, dtype)
    mu = mid[:, None] + half[:, None] * xg[None, :]  # (P, NQ)
    x0, x1, y0, y1 = x[j][:, None], x[j + 1][:, None], y[j][:, None], y[j + 1][:, None]
    pdf = y0 + (mu - x0) / (x1 - x0) * (y1 - y0)
    elab = base + slope * mu
    mul = np.clip((mu * np.sqrt(ecm) + np.sqrt(e) / ap1) / np.sqrt(elab), dtype(-1.0), dtype(1.0))
    wpdf = (half[:, None] * wg[None, :]) * pdf
    per_panel = np.einsum("pq,pql->pl", wpdf, legendre(mul, order))  # (P, L+1)
    np.add.at(out.T, g[inside], per_panel[inside])
    return out
