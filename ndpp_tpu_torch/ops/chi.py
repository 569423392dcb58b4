"""Group collapse of secondary-energy spectra (fission chi; analytic laws).

Counterpart of ndpp_tpu/ops/chi.py.
chi_g'(E) = integral over group g' of p(E'|E) (SURVEY.md section 3.4).

Paths:
  - tabular pdfs (law 4-style, piecewise linear / histogram-by-duplication):
    boundary cumulants of the exact per-panel integrals — no quadrature
    error at all;
  - analytic spectra (law 7 Maxwell, 9 evaporation, 11 Watt): per-group
    Gauss-Legendre of the (entire) raw spectrum, with the ACE restriction
    E' <= E - U truncating the support and renormalizing.

The closed-form integrals of the analytic spectra and their tail
complements (_maxwell_*, _evap_*, _watt_*) are the reference's independent
check of the quadrature path; the production path does not call them.

Plain float64 torch functions over incident-energy rows, on the device of
their arguments; they share the edge-group clamping convention of
ops.twobody.
"""

from __future__ import annotations

import math

import torch

from ndpp_tpu_torch.ops.legendre import gl_nodes_weights
from ndpp_tpu_torch.ops.segment import effective_bounds

_SQRT_PI = math.sqrt(math.pi)


def tabular_group_fractions(e_knots, pdf, bounds, clamp: bool = True):
    """Exact group integrals of piecewise-linear pdfs.

    e_knots/pdf: (T, K) — outgoing-energy knots (duplicated knots encode
    histogram steps) and pdf values (1/eV). bounds: (G+1,) shared or
    (T, B+1) per-row windows. Returns (T, G|B) with row sums equal to the
    pdf norm (1 for normalized).

    Boundary cumulants: the per-knot-panel integral prefix is a cumsum, each
    boundary's partial panel is closed-form, and group values are
    differences of boundary cumulants — exact for piecewise-linear pdfs,
    with no sort and no scatter-add: the only lookup is a gather of the
    containing panel's (knot, pdf, slope, prefix) at the boundaries.
    """
    k = e_knots.shape[1]
    eff = effective_bounds(bounds, clamp)
    if eff.dim() == 1:
        eff = eff[None, :]
    dx = e_knots[:, 1:] - e_knots[:, :-1]
    ok = dx > 0
    dxs = torch.where(ok, dx, torch.ones_like(dx))
    zero = torch.zeros_like(dx)
    slope = torch.where(ok, (pdf[:, 1:] - pdf[:, :-1]) / dxs, zero)
    pint = torch.where(ok, 0.5 * (pdf[:, 1:] + pdf[:, :-1]) * dx, zero)  # exact panel integrals
    prefix = torch.cumsum(pint, dim=1) - pint  # exclusive: integral up to knot j
    b = torch.minimum(torch.maximum(eff, e_knots[:, :1]), e_knots[:, -1:])  # (T, G+1)
    # containing panel: the last knot <= boundary (side='right'), clipped
    idx = (torch.searchsorted(e_knots.contiguous(), b.contiguous(), right=True) - 1).clamp_(0, k - 2)
    x0 = torch.gather(e_knots, 1, idx)
    y0 = torch.gather(pdf, 1, idx)
    h = (b - x0).clamp_min(0.0)
    cum = torch.gather(prefix, 1, idx) + h * (y0 + 0.5 * torch.gather(slope, 1, idx) * h)  # (T, G+1)
    return cum[:, 1:] - cum[:, :-1]


def _maxwell_integral(x, theta):
    """I(x) = int_0^x sqrt(t) exp(-t/theta) dt (unnormalized)."""
    x = torch.clamp_min(x, 0.0)
    z = torch.sqrt(x / theta)
    return theta**1.5 * (_SQRT_PI / 2.0) * torch.special.erf(z) - theta * torch.sqrt(x) * torch.exp(-x / theta)


def _maxwell_comp(x, theta):
    """Ic(x) = int_x^inf sqrt(t) exp(-t/theta) dt (tail-accurate complement)."""
    x = torch.clamp_min(x, 0.0)
    z = torch.sqrt(x / theta)
    return theta**1.5 * (_SQRT_PI / 2.0) * torch.special.erfc(z) + theta * torch.sqrt(x) * torch.exp(-x / theta)


def _evap_integral(x, theta):
    """I(x) = int_0^x t exp(-t/theta) dt."""
    r = torch.clamp_min(x, 0.0) / theta
    # -expm1(-r) - r*exp(-r) is accurate for small r too
    return theta**2 * (-torch.expm1(-r) - r * torch.exp(-r))


def _evap_comp(x, theta):
    """Ic(x) = int_x^inf t exp(-t/theta) dt = theta^2 e^{-x/theta} (1 + x/theta)."""
    r = torch.clamp_min(x, 0.0) / theta
    return theta**2 * torch.exp(-r) * (1.0 + r)


def _watt_half(s, h, a):
    """int_0^s u exp(-(u-h)^2/a) du  (building block of the Watt integral)."""
    sq = torch.sqrt(a)
    term_exp = 0.5 * a * (torch.exp(-(h**2) / a) - torch.exp(-((s - h) ** 2) / a))
    term_erf = h * (_SQRT_PI * sq / 2.0) * (torch.special.erf((s - h) / sq) + torch.special.erf(h / sq))
    return term_exp + term_erf


def _watt_half_comp(s, h, a):
    """int_s^inf u exp(-(u-h)^2/a) du."""
    sq = torch.sqrt(a)
    return 0.5 * a * torch.exp(-((s - h) ** 2) / a) + h * (_SQRT_PI * sq / 2.0) * torch.special.erfc((s - h) / sq)


def _watt_integral(x, a, b):
    """I(x) = int_0^x exp(-t/a) sinh(sqrt(b t)) dt (unnormalized, exact).

    Derivation: t = u^2, sinh = (e^{+cu} - e^{-cu})/2 with c = sqrt(b);
    complete the square. The common factor exp(ab/4) is kept explicit.
    """
    s = torch.sqrt(torch.clamp_min(x, 0.0))
    h = a * torch.sqrt(b) / 2.0
    return torch.exp(a * b / 4.0) * (_watt_half(s, h, a) - _watt_half(s, -h, a))


def _watt_comp(x, a, b):
    """Ic(x) = int_x^inf exp(-t/a) sinh(sqrt(b t)) dt."""
    s = torch.sqrt(torch.clamp_min(x, 0.0))
    h = a * torch.sqrt(b) / 2.0
    return torch.exp(a * b / 4.0) * (_watt_half_comp(s, h, a) - _watt_half_comp(s, -h, a))


def _raw_spectrum(law: int, x, theta, b_param):
    """Unnormalized spectrum value (smooth; no cancellation anywhere)."""
    if law == 7:
        return torch.sqrt(x.clamp_min(0.0)) * torch.exp(-x / theta)
    if law == 9:
        return x.clamp_min(0.0) * torch.exp(-x / theta)
    if law == 11:
        return torch.exp(-x / theta) * torch.sinh(torch.sqrt((b_param * x).clamp_min(0.0)))
    raise ValueError(law)


def analytic_group_fractions(e, theta, b_param, u: float, bounds, law: int, clamp: bool = True, nq: int = 24):
    """Group fractions for laws 7/9/11 with restriction E' <= E - U.

    e/theta/b_param: (T,) rows (b_param used only for law 11, where theta
    plays the role of 'a'); bounds: (G+1,). Returns (T, G) rows summing to 1
    (0 below U).

    Per-group Gauss-Legendre of the raw spectrum. The spectrum is entire, so
    per-panel GL converges to machine precision and (unlike differencing a
    closed-form cumulative) suffers no tail cancellation. Normalization
    divides by the sum over the full [0, E-U] partition, so rows sum to
    exactly 1.
    """
    ng = bounds.shape[0] - 1
    emax = (e - u).clamp_min(0.0)  # (T,)
    th = theta[:, None, None]
    bp = b_param[:, None, None]

    eff = effective_bounds(bounds, clamp)
    cut = torch.minimum(eff[None, :].clamp_min(0.0), emax[:, None])  # (T, G+1)
    # full partition of [0, emax]: leading [0, cut_0] and trailing [cut_G, emax]
    part = torch.cat([torch.zeros_like(emax)[:, None], cut, emax[:, None]], dim=1)  # (T, G+3)

    xq, wq = gl_nodes_weights(nq)
    xq = torch.as_tensor(xq, dtype=e.dtype, device=e.device)
    wq = torch.as_tensor(wq, dtype=e.dtype, device=e.device)
    lo, hi = part[:, :-1], part[:, 1:]
    half = 0.5 * (hi - lo)  # (T, G+2)
    mid = 0.5 * (hi + lo)
    x = mid[:, :, None] + half[:, :, None] * xq[None, None, :]  # (T, G+2, Q)
    vals = _raw_spectrum(law, x, th, bp)
    seg = torch.sum(vals * wq[None, None, :], dim=-1) * half  # (T, G+2)

    total = torch.sum(seg, dim=1)  # integral over [0, emax]
    ok = total > 0.0
    total = torch.where(ok, total, torch.ones_like(total))
    frac = seg[:, 1 : ng + 1] / total[:, None]
    return torch.where(ok[:, None], frac, torch.zeros_like(frac))
