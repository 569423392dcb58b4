"""Lagrange panel-split machinery of the continuum ops.

Counterpart of ndpp_tpu/ops/panelsplit.py. An op integrates a SMOOTH
density over panels chosen at the integrand's own structure (cusps,
data-knot images, graded ladders) — NOT at group boundaries, across which
the density is analytic. Panel GL sums give the totals; each group
boundary's partial integral inside its panel comes from the GL-node
Lagrange interpolant, whose full-panel integral IS the GL sum (GL weights
are the integrals of the Lagrange basis), so cumulative sums telescope
exactly: C(first edge) = 0, C(last edge) = total, and group values are
differences of boundary cumulants. Per-row cost is then independent of the
group count.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=16)
def lagrange_antiderivative_coeffs(nq: int) -> np.ndarray:
    """(NQ, NQ+1) monomial coefficients of A_q(t) = int_{-1}^t L_q on GL nodes.

    L_q is the Lagrange basis on the nq-point Gauss-Legendre nodes; by the
    definition of GL weights, A_q(1) == w_q exactly, so partial-panel
    integrals built from these telescope consistently with GL panel sums.
    The cached array is shared: callers read it, never write it.
    """
    x, w = np.polynomial.legendre.leggauss(nq)
    out = np.zeros((nq, nq + 1))
    for q in range(nq):
        roots = np.delete(x, q)
        poly = np.polynomial.polynomial.Polynomial.fromroots(roots)
        poly = poly / poly(x[q])
        integ = poly.integ(lbnd=-1.0)
        out[q, : integ.coef.size] = integ.coef
    if not np.allclose(out.sum(axis=1), w, atol=1e-13):
        raise ArithmeticError(f"Lagrange antiderivatives on {nq} GL nodes do not integrate to the GL weights")
    return out


def lagrange_cumulants(edges, pmid_p, phalf_p, gvals, wg, boundaries, npan: int, nq: int):
    """Cumulative panel integrals C_l evaluated at arbitrary boundaries.

    edges: (T, NP+1) ascending panel edges; pmid_p/phalf_p: (T, P_pad)
    panel mids/halves (P_pad >= NP; pad halves = 0); gvals:
    (T, P_pad, NQ, L+1) density node values; wg: (NQ,) GL weights;
    boundaries: (NB,) shared or (T, NB) per-row. Returns (T, NB, L+1).
    Boundaries below the first edge give 0, above the last give the total
    (clip semantics of the panel lookup + t in [-1, 1]).

    Each boundary needs exactly ONE panel — its mid, half, NQ x (L+1) node
    block and exclusive prefix — so the lookup is a searchsorted over the
    sorted panel starts and one gather per piece.
    """
    dtype = gvals.dtype
    tt = edges.shape[0]
    nq_ = gvals.shape[2]
    l1 = gvals.shape[3]
    totals = phalf_p[..., None] * torch.sum(gvals * wg[None, None, :, None], dim=2)  # (T, P_pad, L+1)
    prefix = torch.cumsum(totals, dim=1) - totals  # exclusive

    b = boundaries if boundaries.dim() == 2 else boundaries[None, :].expand(tt, boundaries.shape[0])
    nb = b.shape[1]
    # the last panel whose start is <= the boundary (side='right'), clipped
    pidx = (
        torch.searchsorted(edges[:, :-1].contiguous(), b.contiguous(), right=True) - 1
    ).clamp_(0, npan - 1)  # (T, NB)
    mid_b = torch.gather(pmid_p, 1, pidx)
    half_b = torch.gather(phalf_p, 1, pidx)
    nodes_b = torch.gather(gvals, 1, pidx[:, :, None, None].expand(tt, nb, nq_, l1))
    prefix_b = torch.gather(prefix, 1, pidx[:, :, None].expand(tt, nb, l1))
    # the 1e-30 floor is the reference's, so both packages divide by the same number
    t_b = ((b - mid_b) / half_b.clamp_min(1e-30)).clamp_(-1.0, 1.0)
    acoef = torch.as_tensor(lagrange_antiderivative_coeffs(nq), dtype=dtype, device=gvals.device)  # (NQ, NQ+1)
    # powers by iterated multiplication: exact for the integer exponents and
    # the same operations as the reference
    pows = [torch.ones_like(t_b)]
    for _ in range(nq):
        pows.append(pows[-1] * t_b)
    tpow = torch.stack(pows, dim=-1)  # (T, NB, NQ+1)
    aq = torch.sum(tpow[:, :, None, :] * acoef[None, None, :, :], dim=3)  # A_q(t_b)
    partial = half_b[..., None] * torch.sum(aq[..., None] * nodes_b, dim=2)
    return prefix_b + partial
