"""The data definition the reference shares with ACE: how a tabulated
angular distribution defines p(mu | E) at any incident energy, and the
small numerical helpers (Gauss-Legendre rules, Legendre polynomials).

Rewritten from the JAX package's host preparation (`linlin_rep`,
`_eval_limit`, `merge_linlin`, `pdf_at_energy` of ndpp_tpu/host/prep.py),
which its oracle uses as the definition of the data: between two tabulated
incident energies the pdf is interpolated linearly in E on the union of
the two cosine grids, histogram steps kept as duplicated knots. Plain
NumPy; it imports nothing of either package.
"""

from __future__ import annotations

import numpy as np


def gauss_legendre(n: int, dtype=np.float64) -> tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(n)
    return x.astype(dtype), w.astype(dtype)


def legendre(x: np.ndarray, order: int) -> np.ndarray:
    """[P_0(x) .. P_order(x)] on a new last axis (Bonnet's recurrence)."""
    ps = [np.ones_like(x)]
    if order >= 1:
        ps.append(x)
    for l in range(1, order):
        ps.append(((2 * l + 1) * x * ps[l] - l * ps[l - 1]) / (l + 1))
    return np.stack(ps, axis=-1)


def linlin(table) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) piecewise linear; a histogram's steps become duplicated knots."""
    if table.interp == 2:
        return table.mu.copy(), table.pdf.copy()
    x, p = table.mu, table.pdf
    n = x.size
    xs = np.empty(2 * (n - 1))
    ys = np.empty(2 * (n - 1))
    xs[0::2], xs[1::2] = x[:-1], x[1:]
    ys[0::2], ys[1::2] = p[:-1], p[:-1]
    return xs, ys


def eval_limit(x: np.ndarray, y: np.ndarray, q: np.ndarray, side: str) -> np.ndarray:
    """A duplicated-knot piecewise-linear (x, y) at q; side picks the limit at
    a knot (it matters only at a step). Held constant outside the table."""
    q = np.asarray(q, dtype=np.float64)
    n = x.size
    if side == "left":
        i = np.searchsorted(x, q, side="left")
        exact = (i < n) & (x[np.clip(i, 0, n - 1)] == q)
        j = np.clip(i - 1, 0, n - 2)
    else:
        i = np.searchsorted(x, q, side="right") - 1
        exact = (i >= 0) & (x[np.clip(i, 0, n - 1)] == q)
        j = np.clip(i, 0, n - 2)
    dx = x[j + 1] - x[j]
    t = np.where(dx > 0, (q - x[j]) / np.where(dx > 0, dx, 1.0), 0.0)
    out = np.where(exact, y[np.clip(i, 0, n - 1)], y[j] + t * (y[j + 1] - y[j]))
    out = np.where(q < x[0], y[0], out)
    return np.where(q > x[-1], y[-1], out)


def _jumps(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    dup = (x[1:] == x[:-1]) & (y[1:] != y[:-1])
    return np.unique(x[:-1][dup])


def merge(x1, y1, x2, y2):
    """Two piecewise-linear pdfs on one knot set, steps kept as pairs of knots."""
    distinct = np.union1d(x1, x2)
    jumps = np.union1d(_jumps(x1, y1), _jumps(x2, y2))
    knots = np.repeat(distinct, np.where(np.isin(distinct, jumps), 2, 1))
    first = np.ones(knots.size, dtype=bool)
    first[1:] = knots[1:] != knots[:-1]
    v1 = np.where(first, eval_limit(x1, y1, knots, "left"), eval_limit(x1, y1, knots, "right"))
    v2 = np.where(first, eval_limit(x2, y2, knots, "left"), eval_limit(x2, y2, knots, "right"))
    return knots, v1, v2


def pdf_at(dist, e: float, e_lo: float, e_hi: float) -> tuple[np.ndarray, np.ndarray]:
    """p(mu | e) as knots and values, normalised by its trapezoid integral.
    dist None is isotropic."""
    if dist is None:
        x, y = np.array([-1.0, 1.0]), np.array([0.5, 0.5])
    else:
        es = dist.energies
        if es.size == 1 or e <= es[0]:
            x, y = linlin(dist.tables[0])
        elif e >= es[-1]:
            x, y = linlin(dist.tables[-1])
        else:
            k = min(int(np.searchsorted(es, e, side="right") - 1), es.size - 2)
            x1, y1 = linlin(dist.tables[k])
            x2, y2 = linlin(dist.tables[k + 1])
            x, v1, v2 = merge(x1, y1, x2, y2)
            t = (e - es[k]) / (es[k + 1] - es[k])
            y = v1 + t * (v2 - v1)
    norm = np.sum(0.5 * (y[1:] + y[:-1]) * np.diff(x))
    return x, (y / norm if norm > 0 else y)
