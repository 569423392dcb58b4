"""Two-body (elastic + discrete-level inelastic) group-transfer moments.

Counterpart of ndpp_tpu/ops/twobody.py. For each incident energy E,
two-body kinematics with reaction constants (C1, C2):

    E_cm' = C2 * (E - C1)                 (C1 = |Q|(A+1)/A, C2 = (A/(A+1))^2;
                                           elastic: C1 = 0)
    E'_lab(mu_cm) = E_cm' + [E + 2 mu_cm (A+1) sqrt(E E_cm')] / (A+1)^2
    mu_lab = mu_cm sqrt(E_cm'/E'_lab) + sqrt(E/E'_lab) / (A+1)

E'_lab is affine and monotone-increasing in mu_cm, so outgoing-group
boundaries map to closed-form mu_cm breakpoints. No quadrature panel ever
crosses a p(mu) knot or a group boundary, which is what makes 1e-8
attainable:

  edges = sort( knots(E) ++ breakpoints(E) ++ graded -1 ladder )
  each subinterval integrates p(mu) P_l(mu_lab) with GL and is summed into
  its single outgoing group (ops/twobody_inner.py: one fused kernel on a
  CUDA device, the inner stage then ops/segment.py on the CPU).

All tensors are float64 on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments

# Graded refinement near mu_cm = -1: when E'_lab(-1) ~ 0 (elastic on A ~ 1,
# or near-threshold levels), mu_lab(mu_cm) has a sqrt-type endpoint
# singularity that defeats fixed-order GL on a wide panel. A geometric
# ladder of static split points restores fast convergence everywhere at the
# cost of a few extra (harmless) subintervals.
_GRADED = -1.0 + 2.0 * 0.25 ** np.arange(1, 11)  # (10,)


def _affine_coeffs_rows(knots: torch.Tensor, pdf: torch.Tensor, mid: torch.Tensor):
    """Per-point affine pdf coefficients (a, b) of the knot panel containing
    each query in `mid` (T, S).

    Panel j spans [x_j, x_{j+1}); duplicated (step) and padded knots make
    empty panels, so the containing panel is the LAST j with x_j <= mid,
    i.e. searchsorted(side="right") - 1, clamped into [0, K-2]: queries below
    the first knot take panel 0 and queries at or above the last knot take
    panel K-2 — the reference's first-panel rule (ndpp_tpu/ops/twobody.py
    _affine_coeffs_rows) exactly.
    """
    k = knots.shape[1]
    x0, x1 = knots[:, :-1], knots[:, 1:]
    y0, y1 = pdf[:, :-1], pdf[:, 1:]
    dx = x1 - x0
    pos = dx > 0
    slope = torch.where(pos, (y1 - y0) / torch.where(pos, dx, torch.ones_like(dx)), torch.zeros_like(dx))
    inter = y0 - slope * x0  # (T, K-1)
    j = torch.searchsorted(knots.contiguous(), mid.contiguous(), right=True) - 1
    j = j.clamp_(0, k - 2)
    return torch.gather(inter, 1, j), torch.gather(slope, 1, j)


def _per_row(x, like: torch.Tensor) -> torch.Tensor:
    """Scalar or (T,) kinematic constant -> (T,) tensor matching `like`."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).expand(like.shape)


def twobody_panels(e, knots, pdf, bounds, c1, c2, awr, clamp: bool):
    """Shared prologue: exact subinterval panels for the two-body inner stage.

    Builds the sorted edge set (pdf knots ++ group-boundary mu breakpoints ++
    graded -1 ladder) and per-subinterval affine pdf coefficients.

    Returns (mid, half, a_s, b_s, base, slope, ecm, e_safe, ap1, valid_e).
    """
    c1 = _per_row(c1, e)
    c2 = _per_row(c2, e)
    awr = _per_row(awr, e)
    ap1 = awr + 1.0  # (T,)

    ecm = c2 * (e - c1)  # (T,) outgoing CM energy
    valid_e = ecm > 0.0
    one = torch.ones_like(e)
    ecm = torch.where(valid_e, ecm, one)  # keep math finite on masked rows
    e_safe = torch.where(valid_e, e, one)

    base = ecm + e_safe / ap1**2  # E'_lab = base + slope * mu_cm
    slope = 2.0 * torch.sqrt(e_safe * ecm) / ap1

    # Group-boundary breakpoints in mu_cm, clipped into [-1, 1]. Under
    # clamping the outermost boundaries are pushed to +-inf so the edge
    # groups swallow out-of-range outgoing energies. `bounds` may be the
    # shared (G+1,) table or PER-ROW (T, B+1) windows (the banded path).
    t = e.shape[0]
    bounds2 = bounds.unsqueeze(0).expand(t, bounds.shape[0]) if bounds.dim() == 1 else bounds
    if clamp:
        inf = torch.full((t, 1), torch.inf, dtype=e.dtype, device=e.device)
        eff_bounds = torch.cat([-inf, bounds2[:, 1:-1], inf], dim=1)
    else:
        eff_bounds = bounds2
    brk = ((eff_bounds - base[:, None]) / slope[:, None]).clamp_(-1.0, 1.0)  # (T, G+1 | B+1)

    graded = torch.as_tensor(_GRADED, dtype=e.dtype, device=e.device).expand(t, _GRADED.size)
    edges = torch.sort(torch.cat([knots, brk, graded], dim=1), dim=1).values  # (T, M)
    lo = edges[:, :-1]
    hi = edges[:, 1:]
    half = 0.5 * (hi - lo)  # (T, S)
    mid = 0.5 * (hi + lo)
    # Every subinterval lies inside exactly ONE pdf panel (the edges include
    # all knots), so the pdf is a single affine a + b*mu per subinterval.
    a_s, b_s = _affine_coeffs_rows(knots, pdf, mid)
    return mid, half, a_s, b_s, base, slope, ecm, e_safe, ap1, valid_e


def twobody_moments(e, knots, pdf, bounds, c1, c2, awr, order: int, nq: int = 16, clamp: bool = True):
    """Group-transfer Legendre moments for one two-body reaction.

    Args:
      e:      (T,) incident energies (eV), float64.
      knots:  (T, K) mu_cm knots of the piecewise-linear p(mu|E) (padded by
              repeating the last knot).
      pdf:    (T, K) pdf values at the knots.
      bounds: (G+1,) ascending group boundaries (eV), or per-row (T, B+1)
              boundary WINDOWS covering each row's kinematic reach (the
              banded path — the result's group axis is then window-local
              and the caller owns the per-row offsets).
      c1, c2: reaction kinematic constants (eV, -); scalars or (T,) tensors.
      awr:    atomic weight ratio A; scalar or (T,) tensor.
      order:  max Legendre order L (<= 10).
      nq:     GL points per subinterval.
      clamp:  if True, outgoing energies outside the group range collapse
              into the edge groups; if False such transfer is dropped.

    Returns:
      (T, L+1, G) moments f_{l,g'}(E): the expected value, per scattering
      event, of P_l(mu_lab) joint with outgoing energy in group g'. Rows
      with E below threshold are all zero.

    After the prologue, a CUDA device runs one hand-written kernel that goes
    from the panels straight to group moments; the CPU runs its plain torch
    version (ops.twobody_inner.twobody_group_moments).
    """
    mid, half, a_s, b_s, base, slope, ecm, e_safe, ap1, valid_e = twobody_panels(
        e, knots, pdf, bounds, c1, c2, awr, clamp
    )
    kin = torch.stack([base, slope, torch.sqrt(ecm), torch.sqrt(e_safe) / ap1], dim=1)  # (T, 4)
    return twobody_group_moments(mid, half, a_s, b_s, kin, valid_e, bounds, order, nq, clamp)


def twobody_constants(awr: float, q_ev: float) -> tuple[float, float]:
    """(C1, C2) for a two-body reaction with Q-value q_ev (Q=0 -> elastic)."""
    c1 = abs(q_ev) * (awr + 1.0) / awr
    c2 = (awr / (awr + 1.0)) ** 2
    return c1, c2
