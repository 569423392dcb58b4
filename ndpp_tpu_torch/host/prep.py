"""Host-side batching: irregular ACE distributions -> padded device tensors.

This is the layout contract between the host layer and the device kernels
(SURVEY.md section 1, 'host layer'; section 7 hard part 2 'irregular ->
rectangular'). Everything here is numpy/f64; nothing device-side ever
interpolates an ACE table directly.

Angular distributions: all encodings are already normalized to tabular form
at parse time; here they become **piecewise-linear** pdfs (histogram steps
encoded by duplicated knots) evaluated on shared per-panel knot sets:

  - For incident E between two angular tables at E_k, E_{k+1}, ACE practice
    interpolates the pdf linearly in E on the union of the two mu-knot sets.
    All E in one panel therefore share one knot row — the panel trick that
    keeps host prep O(NE * K) instead of O(NE * K log K).
  - Discontinuities are preserved exactly by knot duplication (left/right
    limits), so the device kernel's subinterval quadrature never spans a
    jump — required for the 1e-8 target.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ndpp_tpu_torch.host.ace.records import AngularDistribution, AngularTable, Nuclide, Reaction
from ndpp_tpu_torch.ops.twobody import twobody_constants
from ndpp_tpu_torch.utils.errors import AceFormatError


def linlin_rep(table: AngularTable) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) piecewise-linear representation; histogram steps become duplicated knots."""
    if table.interp == 2:
        return table.mu.copy(), table.pdf.copy()
    if table.interp != 1:
        raise AceFormatError(f"angular table interpolation JJ={table.interp} unsupported")
    x, p = table.mu, table.pdf
    n = x.size
    xs = np.empty(2 * (n - 1))
    ys = np.empty(2 * (n - 1))
    xs[0::2] = x[:-1]
    xs[1::2] = x[1:]
    ys[0::2] = p[:-1]
    ys[1::2] = p[:-1]
    return xs, ys


def _eval_limit(x: np.ndarray, y: np.ndarray, q: np.ndarray, side: str) -> np.ndarray:
    """Evaluate a possibly-duplicated-knot piecewise-linear (x, y) at points q.

    side='left'/'right' selects the limit at exact knots (matters only at
    duplicated knots, i.e. steps).
    """
    q = np.asarray(q, dtype=np.float64)
    n = x.size
    if side == "left":
        i = np.searchsorted(x, q, side="left")  # first index with x[i] >= q
        exact = (i < n) & (x[np.clip(i, 0, n - 1)] == q)
        out = np.empty_like(q)
        out[exact] = y[np.clip(i[exact], 0, n - 1)]
        j = np.clip(i[~exact] - 1, 0, n - 2)
    else:
        i = np.searchsorted(x, q, side="right") - 1  # last index with x[i] <= q
        exact = (i >= 0) & (x[np.clip(i, 0, n - 1)] == q)
        out = np.empty_like(q)
        out[exact] = y[np.clip(i[exact], 0, n - 1)]
        j = np.clip(i[~exact], 0, n - 2)
    qq = q[~exact]
    x0, x1 = x[j], x[j + 1]
    y0, y1 = y[j], y[j + 1]
    dx = x1 - x0
    t = np.where(dx > 0, (qq - x0) / np.where(dx > 0, dx, 1.0), 0.0)
    out[~exact] = y0 + t * (y1 - y0)
    # clamp outside table
    out = np.where(q < x[0], y[0], out)
    out = np.where(q > x[-1], y[-1], out)
    return out


def _jump_points(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Distinct knot values where (x, y) has a step discontinuity."""
    dup = (x[1:] == x[:-1]) & (y[1:] != y[:-1])
    return np.unique(x[:-1][dup])


def merge_linlin(
    x1: np.ndarray, y1: np.ndarray, x2: np.ndarray, y2: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Put two piecewise-linear pdfs on one shared knot set, preserving jumps.

    Returns (knots, y1_on_knots, y2_on_knots); knots may contain duplicates
    where either input has a discontinuity.
    """
    distinct = np.union1d(x1, x2)
    jumps = np.union1d(_jump_points(x1, y1), _jump_points(x2, y2))
    is_jump = np.isin(distinct, jumps)
    counts = np.where(is_jump, 2, 1)
    knots = np.repeat(distinct, counts)
    # first copy of a duplicated knot takes left limits, second right limits
    first_copy = np.ones(knots.size, dtype=bool)
    first_copy[1:] = knots[1:] != knots[:-1]
    out1 = np.where(first_copy, _eval_limit(x1, y1, knots, "left"), _eval_limit(x1, y1, knots, "right"))
    out2 = np.where(first_copy, _eval_limit(x2, y2, knots, "left"), _eval_limit(x2, y2, knots, "right"))
    return knots, out1, out2


def angular_panel_blocks(dist: AngularDistribution, e_grid: np.ndarray):
    """Yield (row_idx, knots, v1, v2, t) per bracketing angular panel.

    All rows in one panel share the merged knot set; the row pdf is
    `(1-t) v1 + t v2` (UNNORMALIZED — callers divide by the trapezoid
    norm, itself linear in t). Single-table distributions yield one block
    with v2 == v1 and t == 0. This is the O(panels) vectorization spine
    shared by the continuum AND-block payload builders.
    """
    es = dist.energies
    panel_of = np.clip(np.searchsorted(es, e_grid, side="right") - 1, 0, max(es.size - 2, 0))
    for p in np.unique(panel_of):
        idx = np.where(panel_of == p)[0]
        if es.size == 1:
            x, y = linlin_rep(dist.tables[0])
            yield idx, x, y, y, np.zeros(idx.size)
            continue
        x1, y1 = linlin_rep(dist.tables[p])
        x2, y2 = linlin_rep(dist.tables[p + 1])
        knots, v1, v2 = merge_linlin(x1, y1, x2, y2)
        denom = es[p + 1] - es[p]
        t = (
            np.clip((e_grid[idx] - es[p]) / denom, 0.0, 1.0)
            if denom > 0
            else np.zeros(idx.size)
        )
        yield idx, knots, v1, v2, t


@dataclass
class TwoBodyPrepared:
    """Device-ready inputs for ops.twobody.twobody_moments for one reaction."""

    e: np.ndarray  # (NE,) eV
    knots: np.ndarray  # (NE, K)
    pdf: np.ndarray  # (NE, K)
    c1: float
    c2: float
    awr: float
    real_elements: int
    padded_elements: int


def prepare_twobody(
    nuc: Nuclide, rxn: Reaction, e_grid: np.ndarray, renormalize: bool = True
) -> TwoBodyPrepared:
    """Bake one two-body reaction's angular data onto the incident grid.

    Panel-vectorized (round 3): all rows bracketed by one angular panel
    share a merged knot set, so the whole panel's rows are one broadcast
    `(1-t) v1 + t v2` — host cost is O(panels) python iterations, not
    O(NE) (the per-row loop was the measured host bottleneck at library
    scale).
    """
    if rxn.frame != "cm":
        raise AceFormatError(f"MT={rxn.mt}: two-body law with lab-frame angular data is not physical ACE")
    dist = rxn.angular
    if dist is None:
        dist = AngularDistribution.isotropic(e_grid[0], e_grid[-1])

    es = dist.energies
    ne = e_grid.size
    # Group incident energies by bracketing angular panel so each panel's
    # merged knot set is built once.
    panel_of = np.clip(np.searchsorted(es, e_grid, side="right") - 1, 0, max(es.size - 2, 0))
    panels = np.unique(panel_of)
    blocks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []  # (row_idx, knots, pdf_rows)
    real = 0
    for p in panels:
        idx = np.where(panel_of == p)[0]
        if es.size == 1:
            x, y = linlin_rep(dist.tables[0])
            block = np.broadcast_to(y[None, :], (idx.size, y.size))
        else:
            x1, y1 = linlin_rep(dist.tables[p])
            x2, y2 = linlin_rep(dist.tables[p + 1])
            x, v1, v2 = merge_linlin(x1, y1, x2, y2)
            denom = es[p + 1] - es[p]
            if denom > 0:
                t = np.clip((e_grid[idx] - es[p]) / denom, 0.0, 1.0)
            else:  # degenerate panel (e.g. isotropic fallback on a 1-point grid)
                t = np.zeros(idx.size)
            block = v1[None, :] + t[:, None] * (v2 - v1)[None, :]
        blocks.append((idx, x, block))
        real += idx.size * x.size
    k_max = max(x.size for _, x, _ in blocks)
    knots = np.empty((ne, k_max))
    pdf = np.empty((ne, k_max))
    for idx, x, block in blocks:
        k = x.size
        knots[idx, :k] = x[None, :]
        pdf[idx, :k] = block
        knots[idx, k:] = x[-1]
        pdf[idx, k:] = block[:, -1:]
    if renormalize:
        widths = np.diff(knots, axis=1)
        norm = np.sum(0.5 * (pdf[:, 1:] + pdf[:, :-1]) * widths, axis=1, keepdims=True)
        pdf = np.where(norm > 0, pdf / np.where(norm > 0, norm, 1.0), pdf)
    q = rxn.q if rxn.mt != 2 else 0.0
    c1, c2 = twobody_constants(nuc.awr, q)
    return TwoBodyPrepared(
        e=np.asarray(e_grid, dtype=np.float64),
        knots=knots,
        pdf=pdf,
        c1=c1,
        c2=c2,
        awr=nuc.awr,
        real_elements=real,
        padded_elements=knots.size,
    )
