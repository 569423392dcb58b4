"""ENDF-102 interpolation laws (host-side, numpy).

The five schemes (ENDF-102 / SURVEY.md section 8.1):
  1 = histogram       y = y1
  2 = lin-lin         y linear in x
  3 = lin-log         y linear in ln(x)
  4 = log-lin         ln(y) linear in x
  5 = log-log         ln(y) linear in ln(x)

plus region-wise interpolation driven by (NBT, INT) breakpoint arrays as used
throughout ACE tables, and the unit-base transform for secondary-energy
distributions. Device kernels never interpolate tables directly: the host
bakes per-point interpolation results/coefficients into dense tensors
(SURVEY.md section 2, 'ENDF interpolation').
"""

from __future__ import annotations

import numpy as np

HISTOGRAM, LINLIN, LINLOG, LOGLIN, LOGLOG = 1, 2, 3, 4, 5


def interp_pair(x, x1, x2, y1, y2, law: int):
    """Interpolate between (x1,y1) and (x2,y2) at x under one ENDF law.

    Vectorized over x/x1/x2/y1/y2 (broadcastable). Degenerate panels
    (x2 == x1) return y1.
    """
    x = np.asarray(x, dtype=np.float64)
    x1 = np.asarray(x1, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    y1 = np.asarray(y1, dtype=np.float64)
    y2 = np.asarray(y2, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        if law == HISTOGRAM:
            return np.broadcast_arrays(y1, x)[0].copy()
        if law == LINLIN:
            t = (x - x1) / (x2 - x1)
        elif law == LINLOG:
            t = np.log(x / x1) / np.log(x2 / x1)
        elif law == LOGLIN:
            t = (x - x1) / (x2 - x1)
            out = y1 * np.exp(t * np.log(y2 / y1))
            return np.where(x2 == x1, y1, out)
        elif law == LOGLOG:
            t = np.log(x / x1) / np.log(x2 / x1)
            out = y1 * np.exp(t * np.log(y2 / y1))
            return np.where(x2 == x1, y1, out)
        else:
            raise ValueError(f"unknown ENDF interpolation law {law}")
        out = y1 + t * (y2 - y1)
        return np.where(x2 == x1, y1, out)


def interp_tab1(x, xs: np.ndarray, ys: np.ndarray, nbt: np.ndarray | None = None, law: np.ndarray | int = LINLIN):
    """Evaluate a TAB1-style table at x (vectorized), with region-wise laws.

    xs must be non-decreasing. Outside the table the value clamps to the end
    values (callers needing zero-extension mask separately). ``nbt``/``law``
    follow ENDF: region r covers points [nbt[r-1], nbt[r]) (1-based ends),
    or a single scalar law for the whole table.
    """
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = xs.size
    if n == 1:
        return np.full(np.shape(x), ys[0])
    scalar_input = x.ndim == 0
    x = np.atleast_1d(x)
    i = np.clip(np.searchsorted(xs, x, side="right") - 1, 0, n - 2)
    x1, x2 = xs[i], xs[i + 1]
    y1, y2 = ys[i], ys[i + 1]
    if nbt is None or np.isscalar(law) or np.asarray(law).size == 1:
        lw = int(law if np.isscalar(law) else np.asarray(law).flat[0])
        out = interp_pair(x, x1, x2, y1, y2, lw)
    else:
        nbt = np.asarray(nbt, dtype=np.int64)
        laws = np.asarray(law, dtype=np.int64)
        # Panel i (between points i and i+1, 0-based) belongs to ENDF region r
        # if its right endpoint's 1-based index (i+2) is <= nbt[r]:
        region = np.clip(np.searchsorted(nbt, i + 2, side="left"), 0, laws.size - 1)
        out = np.empty(x.shape, dtype=np.float64)
        for lw in np.unique(laws):
            mask = laws[region] == lw
            if np.any(mask):
                out[mask] = interp_pair(x[mask], x1[mask], x2[mask], y1[mask], y2[mask], int(lw))
    lo = x <= xs[0]
    hi = x >= xs[-1]
    out = np.where(lo, ys[0], out)
    out = np.where(hi, ys[-1], out)
    return out[0] if scalar_input else out


def trapz_pdf_to_cdf(xs: np.ndarray, pdf: np.ndarray) -> np.ndarray:
    """CDF of a piecewise-linear (lin-lin) pdf at its own knots."""
    xs = np.asarray(xs, dtype=np.float64)
    pdf = np.asarray(pdf, dtype=np.float64)
    seg = 0.5 * (pdf[1:] + pdf[:-1]) * np.diff(xs)
    return np.concatenate([[0.0], np.cumsum(seg)])


def hist_pdf_to_cdf(xs: np.ndarray, pdf: np.ndarray) -> np.ndarray:
    """CDF of a histogram pdf (value pdf[i] on [xs[i], xs[i+1]]) at its knots."""
    xs = np.asarray(xs, dtype=np.float64)
    pdf = np.asarray(pdf, dtype=np.float64)
    seg = pdf[:-1] * np.diff(xs)
    return np.concatenate([[0.0], np.cumsum(seg)])
