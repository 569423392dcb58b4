"""Per-row outgoing-group band windows (counterpart of ndpp_tpu/banding.py).

A dense (L+1, G) moment row is mostly zeros: its physical support is a
narrow window of the group structure (SURVEY.md section 7 hard part 2).
Every kernel family's outgoing-energy support is closed-form on the host:

- two-body: E'_lab(mu = -+1) = (sqrt(E'_cm) -+ s)^2 (driver._band_windows);
- CM continuum laws (Kalbach / tabular / n-body): the same kinematics
  with E'_cm spanning the row's knot table (support_cm below);
- lab-frame tabular laws and chi spectra: the knot range itself.

Rows are dispatched against per-row boundary windows (B+1 boundaries, B
from the same ladder as the reference so both packages split the same
rows), the ops emit (T, L+1, B), and the copied-back banded block is
densified host-side. Window coverage of the support plus the clamp
convention (edge groups absorb out-of-domain mass) make banded == dense
at roundoff (tests/test_torch_continuum_ops.py).
"""

from __future__ import annotations

import numpy as np

from ndpp_tpu_torch.host import unionize


def plan(lo: np.ndarray, hi: np.ndarray, bounds: np.ndarray, lo_bucket: int = 16):
    """(B, g0 (N,)) window plan from per-row outgoing support [lo, hi], or None.

    One safety group each side absorbs support-edge roundoff; the window
    offset is clipped into [0, ng - B] so each row's window always covers
    its [g_lo, g_hi]. Returns None (keep the dense path) when the pow2
    width bucket reaches half the structure: the saving would be < 2x.
    """
    ng = bounds.size - 1
    g_lo = np.clip(np.searchsorted(bounds, lo, side="right") - 2, 0, ng - 1)
    g_hi = np.clip(np.searchsorted(bounds, hi, side="left") + 1, 1, ng)
    width = int((g_hi - g_lo).max()) if g_lo.size else 1
    b_w = unionize.bucket_pow2(width, lo=lo_bucket)
    if b_w >= ng // 2:
        return None
    g0 = np.clip(g_lo, 0, ng - b_w)
    return b_w, g0


def partition(lo: np.ndarray, hi: np.ndarray, bounds: np.ndarray, lo_bucket: int = 16):
    """Row partition for mixed-reach dispatches: (narrow mask, B, g0), or None.

    Continuum/chi supports vary enormously across one law's rows (a
    threshold reaction's top-E rows reach the whole structure while its
    near-threshold rows span a handful of groups), so a single shared
    window bucket degenerates to dense on the widest row. Instead: rows
    whose window fits the largest pow2 bucket below ng/2 ride ONE banded
    dispatch set (B = bucket of the widest such row); the rest stay dense.

    Returns (narrow (N,) bool, B, g0 (N,) — meaningful where narrow) or
    None when no row is narrow (or the structure is too coarse to pay).

    Window widths come from a 1-1.5 ladder (16, 24, 32, 48, 64, ...) up
    to 3/5 of the structure: pow2-only buckets left the fission-chi class
    (widths ~0.43 G at 361 groups) stranded just above the pow2 cap.
    """
    ng = bounds.size - 1
    cap = ng * 3 // 5
    ladder = []
    b = lo_bucket
    while b <= cap:
        ladder.append(b)
        if 3 * b // 2 <= cap:
            ladder.append(3 * b // 2)
        b *= 2
    if not ladder:
        return None  # coarse structure: banding cannot pay
    g_lo = np.clip(np.searchsorted(bounds, lo, side="right") - 2, 0, ng - 1)
    g_hi = np.clip(np.searchsorted(bounds, hi, side="left") + 1, 1, ng)
    width = np.maximum(g_hi - g_lo, 1)
    narrow = width <= ladder[-1]
    if not narrow.any():
        return None
    wmax = int(width[narrow].max())
    b_w = next(v for v in ladder if v >= wmax)
    g0 = np.clip(g_lo, 0, ng - b_w)
    return narrow, b_w, g0


def window_bounds(bounds: np.ndarray, g0: np.ndarray, b_w: int) -> np.ndarray:
    """(N, B+1) per-row boundary windows gathered from the shared bounds."""
    return bounds[g0[:, None] + np.arange(b_w + 1)[None, :]]


def support_cm(e: np.ndarray, awr: float, e_knots: np.ndarray):
    """Outgoing E'_lab support [lo, hi] of CM-frame law rows.

    e: (N,) incident energies; e_knots: (N, K) sorted E'_cm knot tables
    (edge padding preserves the row min/max). With s = sqrt(E)/(A+1) and
    y = sqrt(E'_cm) in [y_lo, y_hi], E'_lab = w^2 with w in
    [min |y -+ s| (0 if s inside), y_hi + s] — the same domain the device
    kernel derives (ops.continuum.cm_moments_pointwise).
    """
    s = np.sqrt(np.maximum(e, 0.0)) / (awr + 1.0)
    ylo = np.sqrt(np.maximum(e_knots[:, 0], 0.0))
    yhi = np.sqrt(np.maximum(e_knots[:, -1], 0.0))
    inside = (ylo <= s) & (s <= yhi)
    w_min = np.where(inside, 0.0, np.minimum(np.abs(ylo - s), np.abs(yhi - s)))
    w_max = yhi + s
    return w_min * w_min, w_max * w_max


def densify(mom: np.ndarray, g0: np.ndarray | None, ng: int) -> np.ndarray:
    """Banded (N, L+1, B) + per-row offsets -> dense (N, L+1, G)."""
    if g0 is None:
        return mom
    n, lp1, gw = mom.shape
    out = np.zeros((n, lp1, ng))
    cols = g0[:, None] + np.arange(gw)[None, :]
    out[np.arange(n)[:, None, None], np.arange(lp1)[None, :, None], cols[:, None, :]] = mom
    return out
