"""Exact Legendre moments of piecewise-linear angular pdfs (host, numpy).

For lab-frame separable reactions the angular factor decouples:
f_{l,g'}(E) = A_l(E) * integral_{g'} p(E'|E) dE', and A_l is an exact
closed-form integral of a piecewise-linear pdf against P_l:

  int (a + b*mu) P_l(mu) dmu  with
  int P_l dmu       = (P_{l+1} - P_{l-1}) / (2l+1)
  int mu P_l dmu    via mu P_l = ((l+1) P_{l+1} + l P_{l-1}) / (2l+1)

Used for AND-block angular factors and for per-knot law-61 lab moments —
no quadrature error anywhere on these paths.
"""

from __future__ import annotations

import numpy as np

from ndpp_tpu_torch.ops.legendre import legendre_all_np


def _legendre_antiderivatives(x: np.ndarray, order: int) -> tuple[np.ndarray, np.ndarray]:
    """(int P_l, int mu P_l) antiderivatives evaluated at points x: both (..., L+1)."""
    p = legendre_all_np(x, order + 2)  # need P up to order+2
    xcol = np.asarray(x, dtype=np.float64)[..., None]
    lp1 = order + 1
    ip = np.empty(p.shape[:-1] + (lp1,))
    imp = np.empty_like(ip)
    for l in range(lp1):
        if l == 0:
            ip[..., 0] = xcol[..., 0]
            imp[..., 0] = 0.5 * xcol[..., 0] ** 2
        else:
            ip[..., l] = (p[..., l + 1] - p[..., l - 1]) / (2 * l + 1)
            # antiderivative of mu P_l = ((l+1) P_{l+1} + l P_{l-1}) / (2l+1)
            t1 = (p[..., l + 2] - p[..., l]) / (2 * (l + 1) + 1)
            t0 = (p[..., l] - p[..., abs(l - 2)]) / (2 * (l - 1) + 1) if l >= 2 else xcol[..., 0]
            imp[..., l] = ((l + 1) * t1 + l * t0) / (2 * l + 1)
    return ip, imp


def linlin_moments(mu: np.ndarray, pdf: np.ndarray, order: int) -> np.ndarray:
    """Exact moments M_l = int p(mu) P_l(mu) dmu of a piecewise-linear pdf.

    mu/pdf: (..., K) rows (duplicated knots encode steps).
    Returns (..., L+1).
    """
    mu = np.asarray(mu, dtype=np.float64)
    pdf = np.asarray(pdf, dtype=np.float64)
    x0, x1 = mu[..., :-1], mu[..., 1:]
    y0, y1 = pdf[..., :-1], pdf[..., 1:]
    dx = x1 - x0
    with np.errstate(divide="ignore", invalid="ignore"):
        b = np.where(dx > 0, (y1 - y0) / np.where(dx > 0, dx, 1.0), 0.0)
    a = y0 - b * x0
    ip, imp = _legendre_antiderivatives(mu, order)  # (..., K, L+1)
    d_ip = ip[..., 1:, :] - ip[..., :-1, :]
    d_imp = imp[..., 1:, :] - imp[..., :-1, :]
    return np.sum(a[..., None] * d_ip + b[..., None] * d_imp, axis=-2)


def kalbach_moments(r: np.ndarray, a: np.ndarray, order: int) -> np.ndarray:
    """Exact Legendre moments of the Kalbach-Mann angular distribution.

    p(mu) = a/(2 sinh a) [cosh(a mu) + r sinh(a mu)]
    M_l   = a i_l(a)/sinh(a) * (1 if l even else r)
    with i_l the modified spherical Bessel function of the first kind
    (int_-1^1 e^{a mu} P_l dmu = 2 i_l(a)).
    """
    from scipy.special import spherical_in

    r = np.asarray(r, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    a_safe = np.where(np.abs(a) > 1e-12, a, 1e-12)
    out = np.empty(np.broadcast_shapes(r.shape, a.shape) + (order + 1,))
    for l in range(order + 1):
        il = spherical_in(l, a_safe)
        base = a_safe * il / np.sinh(a_safe)
        small = np.abs(a) <= 1e-12
        base = np.where(small, 1.0 if l == 0 else 0.0, base)
        out[..., l] = base if l % 2 == 0 else base * r
    return out
