"""Sorted-segment group reduction (counterpart of ndpp_tpu/ops/segment.py).

Every group-collapse epilogue has the same shape: per-row quantities
attached to a SORTED ladder of subinterval midpoints are summed into the
outgoing group containing each midpoint. Because the classification values
are non-decreasing along the segment axis, group sums are CONTIGUOUS runs:
with C the running (cumulative) sum of m and p_j the count of values below
boundary j,

    out[g] = C[p_{g+1} - 1] - C[p_g - 1]        (C[-1] := 0)

Here p_j is a ``torch.searchsorted`` over each sorted row and C[p_j - 1] a
``torch.gather`` from a zero-led cumsum. (The reference builds a
(T, C, G+1, S) one-hot mask instead, because gathers are slow on a TPU; at
T=2048, C=6, G=361, S~400 that mask is ~14 GB of float64.)

Classification matches ``searchsorted(side="right")``: a midpoint exactly ON
boundary j belongs to group j.
"""

from __future__ import annotations

import torch


def effective_bounds(bounds: torch.Tensor, clamp: bool) -> torch.Tensor:
    """Integration bounds under the clamp convention: with clamp the outermost
    boundaries move to -+inf, so the edge groups absorb out-of-range mass.
    bounds: shared (G+1,) or per-row (T, B+1) band windows."""
    if not clamp:
        return bounds
    inf = torch.full(bounds.shape[:-1] + (1,), torch.inf, dtype=bounds.dtype, device=bounds.device)
    return torch.cat([-inf, bounds[..., 1:-1], inf], dim=-1)


def segment_group_sum(m: torch.Tensor, values: torch.Tensor, bounds: torch.Tensor, clamp: bool) -> torch.Tensor:
    """Sum sorted segments into groups: (T, C, S) -> (T, C, G).

    m:      (T, C, S) per-segment quantities (C = channels, e.g. L+1).
    values: (T, S) per-segment classification values, NON-DECREASING along
            S in every row. Dead segments must carry m == 0 and a value that
            preserves the ordering.
    bounds: (G+1,) ascending group boundaries, or PER-ROW (T, B+1) windows
            (the banded two-body path).
    clamp:  True  — outermost boundaries catch everything (below-range mass
                    lands in group 0, above-range in group G-1);
            False — segments outside [bounds[0], bounds[-1]) are dropped
                    (the prefix-difference structure excludes them with no
                    explicit mask).
    """
    t, c, s = m.shape
    if bounds.dim() == 1:
        bounds = bounds.unsqueeze(0).expand(t, bounds.shape[0])
    ng = bounds.shape[1] - 1
    eff = effective_bounds(bounds, clamp)
    # p[t, j] = #segments with value < boundary j (ties -> upper group)
    pj = torch.searchsorted(values.contiguous(), eff.contiguous(), right=False)  # (T, G+1)
    csum = torch.cat([m.new_zeros((t, c, 1)), torch.cumsum(m, dim=2)], dim=2)  # (T, C, S+1)
    sel = torch.gather(csum, 2, pj.unsqueeze(1).expand(t, c, ng + 1))  # C[p_j - 1]
    return sel[:, :, 1:] - sel[:, :, :-1]
