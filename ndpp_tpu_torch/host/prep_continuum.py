"""Host batching for continuum secondary-energy laws (configs 4; SURVEY.md 3.4).

Normalizes every ACE continuum law to one of a few device layouts:

  'lab-tabular'   piecewise-linear p(E'|E) rows + per-knot exact Legendre
                  moment rows M_l (lab frame: angle decouples or is
                  correlated-but-lab; kernel: ops.continuum.lab_tabular)
  'cm-kalbach'    p(E'_cm|E) rows + Kalbach (r, a) rows (ops.continuum.cm)
  'cm-tabular'    p(E'_cm|E) rows + angular pdf tensor on a shared mu-knot
                  union (law 61 CM / law 4 CM with AND angles)
  'cm-nbody'      analytic N-body phase-space pdf (law 66), isotropic CM

Unit-base interpolation between bracketing incident tables follows ACE
practice: supports interpolate linearly, pdfs combine with span-Jacobians so
normalization is preserved exactly; Kalbach r/a and tabulated angles
interpolate linearly in the unit-base variable (reference semantics
unverifiable with the mount empty — choice documented, SURVEY.md section 0).

Rows bracketed by the same incident panel share one knot union (the same
panel trick as host.prep for angles).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ndpp_tpu_torch.host import interp as interp_mod
from ndpp_tpu_torch.host.ace.records import (
    AngularTable,
    ContinuousTable,
    EnergyDistribution,
    LawData,
    Nuclide,
    Reaction,
)
from ndpp_tpu_torch.host.angular_moments import kalbach_moments, linlin_moments
from ndpp_tpu_torch.host.prep import linlin_rep, merge_linlin
from ndpp_tpu_torch.utils.errors import AceFormatError


@dataclass
class ContinuumPrepared:
    kind: str  # 'lab-tabular' | 'cm-kalbach' | 'cm-tabular' | 'cm-nbody'
    e: np.ndarray  # (NE,)
    applicability: np.ndarray  # (NE,) law probability p(E)
    e_knots: np.ndarray | None = None  # (NE, KE) outgoing-energy knots (eV)
    pdf: np.ndarray | None = None  # (NE, KE) 1/eV
    mom_knots: np.ndarray | None = None  # (NE, KE, L+1) lab path
    r_rows: np.ndarray | None = None  # (NE, KE) kalbach
    a_rows: np.ndarray | None = None  # (NE, KE)
    mu_knots: np.ndarray | None = None  # (KMU,) shared union for cm-tabular
    mu_pdf: np.ndarray | None = None  # (NE, KE, KMU)
    nbody_emax: np.ndarray | None = None  # (NE,)
    nbody_expo: float | None = None  # (3*npsx/2 - 4)
    real_elements: int = 0
    padded_elements: int = 0
    extra: dict = field(default_factory=dict)


# --------------------------------------------------------------------------
# generic tabular (laws 4 / 44 / 61) unit-base machinery


def _continuous_view(t: ContinuousTable) -> ContinuousTable:
    """The continuous tail of a table with ND discrete lines at its head.

    ACE DLW convention: the first ND (e_out, pdf, cdf) entries are delta
    lines whose pdf value IS the line probability; the rest is the usual
    density whose integral is 1 - sum(line probabilities). An (almost) all-
    discrete table degrades to a zero-density stub so the discrete engine
    carries everything.
    """
    nd = t.nd
    if t.e_out.size - nd >= 2:
        return ContinuousTable(
            intt=t.intt, nd=0,
            e_out=t.e_out[nd:], pdf=t.pdf[nd:], cdf=t.cdf[nd:],
            r=None if t.r is None else t.r[nd:],
            a=None if t.a is None else t.a[nd:],
            angular=None if t.angular is None else t.angular[nd:],
        )
    lo = float(t.e_out[:nd].min()) if nd else 1.0
    hi = float(t.e_out[:nd].max()) if nd else 2.0
    span = np.array([0.9 * lo, 1.1 * hi + 1e-9])
    zeros = np.zeros(2)
    return ContinuousTable(intt=2, nd=0, e_out=span, pdf=zeros, cdf=zeros)


def _table_linlin(t: ContinuousTable) -> tuple[np.ndarray, np.ndarray, dict[str, np.ndarray]]:
    """(e_out, pdf, aux-arrays) in piecewise-linear form (histogram doubled).

    Discrete lines (ND > 0) are NOT represented here — they are split off
    into the discrete-lines engine (discrete_line_rows); only the
    continuous tail flows through the unit-base machinery.
    """
    if t.nd:
        t = _continuous_view(t)
    aux: dict[str, np.ndarray] = {}
    if t.intt == 2:
        x, y = t.e_out.astype(np.float64), t.pdf.astype(np.float64)
        if t.r is not None:
            aux["r"], aux["a"] = t.r.astype(np.float64), t.a.astype(np.float64)
        return x, y, aux
    if t.intt != 1:
        raise AceFormatError(f"secondary-energy INTT={t.intt} unsupported")
    x, p = t.e_out, t.pdf
    n = x.size
    xs = np.empty(2 * (n - 1))
    ys = np.empty(2 * (n - 1))
    xs[0::2], xs[1::2] = x[:-1], x[1:]
    ys[0::2] = p[:-1]
    ys[1::2] = p[:-1]
    if t.r is not None:
        for name, arr in (("r", t.r), ("a", t.a)):
            vs = np.empty(2 * (n - 1))
            vs[0::2], vs[1::2] = arr[:-1], arr[:-1]
            aux[name] = vs
    return xs, ys, aux


def _xi(x: np.ndarray) -> np.ndarray:
    span = x[-1] - x[0]
    if span <= 0:
        raise AceFormatError("secondary-energy table has zero support")
    return (x - x[0]) / span


def _interp_on_xi(x_src_xi, y_src, xi_query, left_right="right"):
    """Piecewise-linear evaluation on possibly-duplicated xi knots."""
    from ndpp_tpu_torch.host.prep import _eval_limit

    return _eval_limit(x_src_xi, y_src, xi_query, left_right)


@dataclass
class PanelRows:
    """One incident panel's shared unit-base structure (panel-vectorized prep).

    All incident rows bracketed by panel p share ONE merged xi knot set;
    per-row quantities are linear in the bracketing weight t, so whole
    panels vectorize as `(1-t) v1 + t v2` broadcasts — host prep cost is
    O(panels), not O(NE) python iterations.
    """

    idx: np.ndarray  # (NR,) incident-row indices covered by this panel
    p: int  # bracketing table index (p, p+1); p == -1 -> single table 0
    t: np.ndarray  # (NR,) bracketing weights in [0, 1]
    xi_u: np.ndarray  # (K,) merged unit-base knots (may contain duplicates)


def tabular_rows(
    data: LawData, e_grid: np.ndarray, aux_names: tuple[str, ...] = ()
) -> tuple[np.ndarray, np.ndarray, dict[str, np.ndarray], list[PanelRows], int]:
    """Unit-base rows for a law 4/44/61 table on the incident grid.

    Returns (e_knots (NE,K), pdf (NE,K), aux rows dict, panel list, real
    element count), all knot-padded to the widest panel.
    """
    es = data.energies
    tables = data.tables
    reps = [_table_linlin(t) for t in tables]
    ne = e_grid.size
    panel_of = np.clip(np.searchsorted(es, e_grid, side="right") - 1, 0, max(es.size - 2, 0))
    hist_incident = np.isscalar(data.int_law) and int(data.int_law) == interp_mod.HISTOGRAM
    panels: list[PanelRows] = []
    blocks: list[tuple[np.ndarray, np.ndarray, dict[str, np.ndarray]]] = []
    real = 0
    for p in np.unique(panel_of):
        idx = np.where(panel_of == p)[0]
        if es.size == 1:
            x, y, aux = reps[0]
            bx = np.broadcast_to(x[None, :], (idx.size, x.size))
            by = np.broadcast_to(y[None, :], (idx.size, x.size))
            baux = {
                n: np.broadcast_to(aux.get(n, np.zeros_like(x))[None, :], bx.shape)
                for n in aux_names
            }
            panels.append(PanelRows(idx=idx, p=-1, t=np.zeros(idx.size), xi_u=_xi(x)))
            blocks.append((bx, by, baux))
            real += bx.size
            continue
        x1, y1, aux1 = reps[p]
        x2, y2, aux2 = reps[p + 1]
        xi1, xi2 = _xi(x1), _xi(x2)
        span1 = x1[-1] - x1[0]
        span2 = x2[-1] - x2[0]
        # union xi knots preserving jumps of either table
        xi_u, y1_u, y2_u = merge_linlin(xi1, y1, xi2, y2)
        if hist_incident:
            t = np.zeros(idx.size)
        else:
            t = np.clip((e_grid[idx] - es[p]) / (es[p + 1] - es[p]), 0.0, 1.0)
        lo = x1[0] + t * (x2[0] - x1[0])
        hi = x1[-1] + t * (x2[-1] - x1[-1])
        span = hi - lo
        bx = lo[:, None] + xi_u[None, :] * span[:, None]
        by = ((1.0 - t)[:, None] * (y1_u * span1)[None, :] + t[:, None] * (y2_u * span2)[None, :]) / span[:, None]
        baux = {}
        for n in aux_names:
            a1 = aux1.get(n, np.zeros_like(x1))
            a2 = aux2.get(n, np.zeros_like(x2))
            first_copy = np.ones(xi_u.size, dtype=bool)
            first_copy[1:] = xi_u[1:] != xi_u[:-1]
            v1 = np.where(first_copy, _interp_on_xi(xi1, a1, xi_u, "left"), _interp_on_xi(xi1, a1, xi_u, "right"))
            v2 = np.where(first_copy, _interp_on_xi(xi2, a2, xi_u, "left"), _interp_on_xi(xi2, a2, xi_u, "right"))
            baux[n] = (1.0 - t)[:, None] * v1[None, :] + t[:, None] * v2[None, :]
        panels.append(PanelRows(idx=idx, p=int(p), t=t, xi_u=xi_u))
        blocks.append((bx, by, baux))
        real += bx.size
    k_max = max(b[0].shape[1] for b in blocks)
    e_knots = np.empty((ne, k_max))
    pdf = np.empty((ne, k_max))
    aux_out = {n: np.empty((ne, k_max)) for n in aux_names}
    for pr, (bx, by, baux) in zip(panels, blocks):
        k = bx.shape[1]
        e_knots[pr.idx, :k] = bx
        pdf[pr.idx, :k] = by
        e_knots[pr.idx, k:] = bx[:, -1:]
        pdf[pr.idx, k:] = by[:, -1:]
        for n in aux_names:
            aux_out[n][pr.idx, :k] = baux[n]
            aux_out[n][pr.idx, k:] = baux[n][:, -1:]
    return e_knots, pdf, aux_out, panels, real


# --------------------------------------------------------------------------
# law conversions -> ContinuousTable form


def _law1_as_tables(data: LawData) -> LawData:
    """Law 1 equiprobable E' bins -> histogram ContinuousTables."""
    tables = []
    for row in data.e_out_bins:
        widths = np.diff(row)
        if np.any(widths <= 0):
            raise AceFormatError("law 1: non-increasing equiprobable bin bounds")
        nb = row.size - 1
        pdf = np.concatenate([(1.0 / nb) / widths, [0.0]])
        cdf = np.linspace(0.0, 1.0, nb + 1)
        tables.append(ContinuousTable(intt=1, nd=0, e_out=row, pdf=pdf, cdf=cdf))
    return LawData(law=4, energies=data.energies, nbt=data.nbt, int_law=data.int_law, tables=tables)


def _law5_as_tables(data: LawData) -> LawData:
    """Law 5 general evaporation: E' = X(xi) * theta(E); X equiprobable."""
    x = np.asarray(data.x_grid, dtype=np.float64)
    if np.any(np.diff(x) <= 0):
        raise AceFormatError("law 5: X table must be increasing")
    energies = data.theta.x
    tables = []
    nb = x.size - 1
    for e in energies:
        th = float(data.theta(e))
        eo = x * th
        widths = np.diff(eo)
        pdf = np.concatenate([(1.0 / nb) / widths, [0.0]])
        tables.append(ContinuousTable(intt=1, nd=0, e_out=eo, pdf=pdf, cdf=np.linspace(0, 1, nb + 1)))
    return LawData(law=4, energies=energies, tables=tables)


# --------------------------------------------------------------------------
# angular payloads


def _and_moment_rows(rxn: Reaction, e_grid: np.ndarray, order: int, k: int) -> np.ndarray:
    """Exact lab angular moments A_l(E) broadcast over the knot axis: (NE, K, L+1).

    Panel-vectorized: moments are linear in the pdf values and the
    trapezoid norm is linear in t, so each angular panel needs TWO
    linlin_moments calls, not one per incident row."""
    from ndpp_tpu_torch.host.prep import angular_panel_blocks

    ne = e_grid.size
    out = np.empty((ne, order + 1))
    if rxn.angular is None:
        out[:] = 0.0
        out[:, 0] = 1.0
    else:
        for idx, x, v1, v2, t in angular_panel_blocks(rxn.angular, e_grid):
            widths = np.diff(x)
            n1 = np.sum(0.5 * (v1[1:] + v1[:-1]) * widths)
            n2 = np.sum(0.5 * (v2[1:] + v2[:-1]) * widths)
            m1 = linlin_moments(x, v1, order)
            m2 = linlin_moments(x, v2, order)
            norm = n1 + t * (n2 - n1)
            out[idx] = (m1[None, :] + t[:, None] * (m2 - m1)[None, :]) / norm[:, None]
    return np.broadcast_to(out[:, None, :], (ne, k, order + 1)).copy()


def _law61_lab_moment_rows(
    data: LawData, e_grid: np.ndarray, panels: list[PanelRows], order: int, k_max: int
) -> np.ndarray:
    """Per-knot exact lab moments for law 61: M_l at each (row, xi-knot).

    Panel-vectorized: per panel the moments interpolate onto the shared
    xi union once per bracketing table, then every row is a `(1-t) v1 +
    t v2` broadcast (moments are linear in the pdf values, which are
    linear in t)."""
    # per-table, per-knot moments (exact) at the ORIGINAL table knots
    tab_moms = []
    for t in data.tables:
        if t.nd:
            t = _continuous_view(t)  # discrete head handled by discrete_line_rows
        src_xi = _xi(t.e_out.astype(np.float64))
        ang = t.angular or [None] * t.e_out.size
        moms = np.empty((t.e_out.size, order + 1))
        for j, at in enumerate(ang):
            if at is None:
                moms[j] = 0.0
                moms[j, 0] = 1.0
            else:
                xx, yy = linlin_rep(at)
                norm = np.sum(0.5 * (yy[1:] + yy[:-1]) * np.diff(xx))
                moms[j] = linlin_moments(xx, yy / norm, order)
        tab_moms.append((src_xi, moms))

    def on_xi(ti: int, xi_u: np.ndarray) -> np.ndarray:
        src_xi, moms = tab_moms[ti]
        return np.stack(
            [np.interp(xi_u, src_xi, moms[:, l]) for l in range(order + 1)], axis=-1
        )  # (K, L+1)

    ne = e_grid.size
    out = np.zeros((ne, k_max, order + 1))
    for pr in panels:
        k = pr.xi_u.size
        if pr.p < 0:
            block = np.broadcast_to(on_xi(0, pr.xi_u)[None], (pr.idx.size, k, order + 1))
        else:
            v1 = on_xi(pr.p, pr.xi_u)
            v2 = on_xi(pr.p + 1, pr.xi_u)
            block = v1[None] + pr.t[:, None, None] * (v2 - v1)[None]
        out[pr.idx, :k] = block
        out[pr.idx, k:] = block[:, -1:, :]
    return out


def _angular_table_moments(at, order: int) -> np.ndarray:
    """Exact Legendre moments of one AngularTable (isotropic if None)."""
    if at is None:
        out = np.zeros(order + 1)
        out[0] = 1.0
        return out
    xx, yy = linlin_rep(at)
    norm = np.sum(0.5 * (yy[1:] + yy[:-1]) * np.diff(xx))
    return linlin_moments(xx, yy / norm, order)


def discrete_line_rows(
    data: LawData, e_grid: np.ndarray, order: int, law: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Per-incident-row discrete lines for ND > 0 tables.

    Returns (e_d (NE, J), p_d (NE, J), am_d (NE, J, L+1)) or None if the law
    carries no discrete lines. Lines are matched by index across incident
    panels (the ACE/ENDF convention for line spectra): energies and angular
    moments interpolate linearly; probabilities interpolate with a vanishing
    contribution from a panel that lacks the line. Law 44 lines carry
    Kalbach (r, a) analytic moments; law 61 lines their own angular tables;
    law 4 lines are separable (caller broadcasts the AND-block moments).
    """
    tables = data.tables
    jm = max(t.nd for t in tables)
    if jm == 0:
        return None
    es = data.energies
    nt = len(tables)
    e_tab = np.zeros((nt, jm))
    p_tab = np.zeros((nt, jm))
    am_tab = np.zeros((nt, jm, order + 1))
    am_tab[:, :, 0] = 1.0
    valid = np.zeros((nt, jm), dtype=bool)
    for ti, t in enumerate(tables):
        nd = t.nd
        if nd == 0:
            continue
        valid[ti, :nd] = True
        e_tab[ti, :nd] = t.e_out[:nd]
        p_tab[ti, :nd] = t.pdf[:nd]
        if law == 44:
            am_tab[ti, :nd] = kalbach_moments(
                t.r[:nd][None, :], np.maximum(t.a[:nd], 1e-12)[None, :], order
            )[0]
        elif law == 61 and t.angular is not None:
            for j in range(nd):
                am_tab[ti, j] = _angular_table_moments(t.angular[j], order)
        if nd < jm:
            e_tab[ti, nd:] = e_tab[ti, nd - 1]
    hist_incident = np.isscalar(data.int_law) and int(data.int_law) == interp_mod.HISTOGRAM
    ne = e_grid.size
    panel_of = np.clip(np.searchsorted(es, e_grid, side="right") - 1, 0, max(es.size - 2, 0))
    e_d = np.zeros((ne, jm))
    p_d = np.zeros((ne, jm))
    am_d = np.zeros((ne, jm, order + 1))
    am_d[:, :, 0] = 1.0
    for i in range(ne):
        if es.size == 1:
            e_d[i], p_d[i], am_d[i] = e_tab[0], p_tab[0], am_tab[0]
            continue
        p = panel_of[i]
        t = 0.0 if hist_incident else float(np.clip((e_grid[i] - es[p]) / (es[p + 1] - es[p]), 0.0, 1.0))
        v1, v2 = valid[p], valid[p + 1]
        both = v1 & v2
        e_d[i] = np.where(both, (1.0 - t) * e_tab[p] + t * e_tab[p + 1], np.where(v1, e_tab[p], e_tab[p + 1]))
        p_d[i] = (1.0 - t) * p_tab[p] * v1 + t * p_tab[p + 1] * v2
        w1 = np.where(both, 1.0 - t, v1.astype(np.float64))
        w2 = np.where(both, t, v2.astype(np.float64))
        am_d[i] = w1[:, None] * am_tab[p] + w2[:, None] * am_tab[p + 1]
    return e_d, p_d, am_d


def _law61_cm_mu_payload(
    data: LawData, e_grid: np.ndarray, panels: list[PanelRows], k_max: int
) -> tuple[np.ndarray, np.ndarray]:
    """(mu_knots (KMU,), mu_pdf (NE, K, KMU)) for CM law 61: angular pdf on a
    global mu union. Panel-vectorized (see PanelRows)."""
    # global mu union over all tables (piecewise-linear reps)
    all_knots = [np.array([-1.0, 1.0])]
    for t in data.tables:
        for at in t.angular or []:
            if at is not None:
                x, _ = linlin_rep(at)
                all_knots.append(x)
    mu_u = np.unique(np.concatenate(all_knots))
    kmu = mu_u.size

    def table_mu_pdf(t: ContinuousTable) -> tuple[np.ndarray, np.ndarray]:
        """(src_xi (NPo,), pdf (NPo, KMU)) at original knots."""
        src_xi = _xi(t.e_out.astype(np.float64))
        ang = t.angular or [None] * t.e_out.size
        vals = np.empty((len(ang), kmu))
        for j, at in enumerate(ang):
            if at is None:
                vals[j] = 0.5
            else:
                x, y = linlin_rep(at)
                norm = np.sum(0.5 * (y[1:] + y[:-1]) * np.diff(x))
                vals[j] = np.interp(mu_u, x, y / norm)
        return src_xi, vals

    tab_payload = [table_mu_pdf(t) for t in data.tables]

    def on_xi(ti: int, xi_u: np.ndarray) -> np.ndarray:
        src_xi, vals = tab_payload[ti]
        res = np.empty((xi_u.size, kmu))
        for m in range(kmu):
            res[:, m] = np.interp(xi_u, src_xi, vals[:, m])
        return res

    ne = e_grid.size
    out = np.zeros((ne, k_max, kmu))
    for pr in panels:
        k = pr.xi_u.size
        if pr.p < 0:
            block = np.broadcast_to(on_xi(0, pr.xi_u)[None], (pr.idx.size, k, kmu))
        else:
            v1 = on_xi(pr.p, pr.xi_u)
            v2 = on_xi(pr.p + 1, pr.xi_u)
            block = v1[None] + pr.t[:, None, None] * (v2 - v1)[None]
        out[pr.idx, :k] = block
        out[pr.idx, k:] = block[:, -1:, :]
    return mu_u, out


# --------------------------------------------------------------------------
# entry point


def _nbody_emax(nuc: Nuclide, rxn: Reaction, ap: float, e_grid: np.ndarray) -> np.ndarray:
    """Law 66 maximum CM outgoing energy: Emax = (Ap-1)/Ap * (A/(A+1) E + Q)."""
    a = nuc.awr
    return (ap - 1.0) / ap * (a / (a + 1.0) * e_grid + rxn.q)


def _law67_as_law61(data: LawData) -> LawData:
    """Reduce law-67 joint (mu, E') tables to the law-61 lab representation.

    Per incident energy: E'-union of every slice's knots; at each union knot
    the joint values across the mu grid give (a) the angular marginal by the
    INTMU rule (lin-lin trapezoid) -> the E' pdf, and (b) the conditional
    p(mu|E') -> a tabulated AngularTable whose exact per-knot Legendre
    moments the lab-tabular path already computes. Convention notes in
    records.AngleEnergySlice.
    """
    tables = []
    for t in data.ae_tables:
        if t.intmu != 2:
            raise AceFormatError(f"law 67 INTMU={t.intmu} unsupported (lin-lin only)")
        if t.mu.size < 2:
            raise AceFormatError("law 67 table needs >= 2 mu slices")
        for s in t.slices:
            if s.intep not in (1, 2):
                raise AceFormatError(f"law 67 INTEP={s.intep} unsupported")
        union = np.unique(np.concatenate([s.e_out for s in t.slices]))
        if any(s.intep == 1 for s in t.slices):
            # Histogram slices are piecewise-CONSTANT: represent the union
            # exactly as a lin-lin table with doubled knots (panel-start and
            # panel-end limits), preserving every step. Zero-width doubled
            # panels integrate to zero downstream; jumps stay sharp.
            mid = 0.5 * (union[:-1] + union[1:])
            grid = np.empty(2 * (union.size - 1))
            grid[0::2] = union[:-1]
            grid[1::2] = union[1:]
            joint = np.zeros((t.mu.size, grid.size))
            for i, s in enumerate(t.slices):
                if s.intep == 2:
                    joint[i] = np.interp(grid, s.e_out, s.pdf, left=0.0, right=0.0)
                else:
                    # histogram: pdf[p] IS the constant on [e_p, e_{p+1})
                    pj = np.clip(np.searchsorted(s.e_out, mid, side="right") - 1, 0, s.e_out.size - 2)
                    pv = s.pdf[pj]
                    pv = np.where((mid < s.e_out[0]) | (mid >= s.e_out[-1]), 0.0, pv)
                    joint[i, 0::2] = pv
                    joint[i, 1::2] = pv
            union = grid
        else:
            joint = np.zeros((t.mu.size, union.size))
            for i, s in enumerate(t.slices):
                joint[i] = np.interp(union, s.e_out, s.pdf, left=0.0, right=0.0)
        # angular marginal (lin-lin trapezoid over mu) = the E' pdf
        marg = np.sum(0.5 * (joint[1:] + joint[:-1]) * np.diff(t.mu)[:, None], axis=0)
        total = np.trapezoid(marg, union)
        if total <= 0:
            raise AceFormatError("law 67 table integrates to zero")
        marg = marg / total
        ang: list[AngularTable | None] = []
        for k in range(union.size):
            m = marg[k] * total
            if m <= 0:
                ang.append(None)  # zero-density knot: conditional undefined -> isotropic
            else:
                ang.append(AngularTable.from_tabulated(2, t.mu, joint[:, k] / m))
        cdf = np.concatenate([[0.0], np.cumsum(0.5 * (marg[1:] + marg[:-1]) * np.diff(union))])
        tables.append(
            ContinuousTable(intt=2, nd=0, e_out=union, pdf=marg, cdf=cdf, angular=ang)
        )
    return LawData(law=61, energies=data.energies, nbt=data.nbt, int_law=data.int_law, tables=tables)


def prepare_continuum(
    nuc: Nuclide, rxn: Reaction, ed: EnergyDistribution, e_grid: np.ndarray, order: int
) -> ContinuumPrepared:
    """Bake one law of one reaction into a device-ready ContinuumPrepared."""
    law = ed.law
    data = ed.data
    applic = np.clip(ed.applicability(e_grid), 0.0, 1.0)
    frame = rxn.frame

    if law in (7, 9, 11):
        # analytic spectra, isotropic lab: handled by ops.chi closed forms
        theta = (data.theta(e_grid) if data.theta is not None else data.a_tab(e_grid))
        b = data.b_tab(e_grid) if data.b_tab is not None else np.zeros_like(e_grid)
        return ContinuumPrepared(
            kind="lab-analytic",
            e=e_grid,
            applicability=applic,
            extra={"law": law, "theta": theta, "b": b, "u": float(data.restriction_u or 0.0)},
        )

    if law == 66:
        if frame != "cm":
            raise AceFormatError("law 66 in lab frame unsupported")
        emax = _nbody_emax(nuc, rxn, float(data.ap), e_grid)
        return ContinuumPrepared(
            kind="cm-nbody",
            e=e_grid,
            applicability=applic,
            nbody_emax=np.maximum(emax, 0.0),
            nbody_expo=1.5 * data.npsx - 4.0,
        )

    if law == 1:
        data = _law1_as_tables(data)
        law = 4
    elif law == 5:
        data = _law5_as_tables(data)
        law = 4
    elif law == 67:
        # lab angle-energy: the joint (mu, E') tables reduce exactly to the
        # law-61 lab representation (marginal E' pdf + per-knot conditional
        # angular tables); File 6 LAW=7 data is lab-frame by definition.
        data = _law67_as_law61(data)
        law = 61
        frame = "lab"
    if law not in (4, 44, 61):
        raise AceFormatError(f"continuum law {law} unsupported by the moment engine")

    aux_names = ("r", "a") if law == 44 else ()
    e_knots, pdf, aux, panels, real = tabular_rows(data, e_grid, aux_names)
    prep = ContinuumPrepared(
        kind="",
        e=e_grid,
        applicability=applic,
        e_knots=e_knots,
        pdf=pdf,
        real_elements=real,
        padded_elements=e_knots.size,
    )

    if law == 44:
        if frame == "cm":
            prep.kind = "cm-kalbach"
            prep.r_rows = aux["r"]
            prep.a_rows = np.maximum(aux["a"], 1e-12)
        else:
            # lab Kalbach: mu_lab = mu, so per-knot moments are analytic
            prep.kind = "lab-tabular"
            prep.mom_knots = kalbach_moments(aux["r"], np.maximum(aux["a"], 1e-12), order)
    elif law == 61:
        if frame == "cm":
            prep.kind = "cm-tabular"
            prep.mu_knots, prep.mu_pdf = _law61_cm_mu_payload(data, e_grid, panels, e_knots.shape[1])
        else:
            prep.kind = "lab-tabular"
            prep.mom_knots = _law61_lab_moment_rows(data, e_grid, panels, order, e_knots.shape[1])
    else:  # law 4: separable angular from the AND block (or isotropic)
        if frame == "cm":
            prep.kind = "cm-tabular"
            mu_u, mu_pdf = _and_payload_cm(rxn, e_grid, e_knots.shape[1])
            prep.mu_knots, prep.mu_pdf = mu_u, mu_pdf
        else:
            prep.kind = "lab-tabular"
            prep.mom_knots = _and_moment_rows(rxn, e_grid, order, e_knots.shape[1])

    if any(t.nd for t in data.tables):
        if frame == "cm":
            # a CM delta line spreads into a continuous lab distribution —
            # the two-body fold, not the tabular engine; not carried by any
            # fixture and rejected with a typed error (docs/design.md scope)
            raise AceFormatError("discrete secondary-energy lines (ND > 0) supported in the lab frame only")
        disc = discrete_line_rows(data, e_grid, order, law)
        if disc is not None:
            e_d, p_d, am_d = disc
            if law == 4:  # separable: lines share the AND-block angular moments
                am_rows = _and_moment_rows(rxn, e_grid, order, 1)[:, 0, :]
                am_d = np.broadcast_to(am_rows[:, None, :], am_d.shape).copy()
            prep.extra["disc"] = (e_d, p_d, am_d)
    return prep


def _and_payload_cm(rxn: Reaction, e_grid: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """CM angular pdf tensor from the AND block (independent of E'): (KMU,), (NE, K, KMU).

    Panel-vectorized: pdf values on the global mu union and the trapezoid
    norm are both linear in t, so each angular panel costs two interps."""
    from ndpp_tpu_torch.host.prep import angular_panel_blocks

    ne = e_grid.size
    if rxn.angular is None:
        mu_u = np.array([-1.0, 1.0])
        return mu_u, np.full((ne, k, 2), 0.5)
    all_knots = []
    for t in rxn.angular.tables:
        x, _ = linlin_rep(t)
        all_knots.append(x)
    mu_u = np.unique(np.concatenate(all_knots))
    rows = np.empty((ne, mu_u.size))
    for idx, x, v1, v2, t in angular_panel_blocks(rxn.angular, e_grid):
        widths = np.diff(x)
        n1 = np.sum(0.5 * (v1[1:] + v1[:-1]) * widths)
        n2 = np.sum(0.5 * (v2[1:] + v2[:-1]) * widths)
        u1 = np.interp(mu_u, x, v1)
        u2 = np.interp(mu_u, x, v2)
        norm = n1 + t * (n2 - n1)
        rows[idx] = (u1[None, :] + t[:, None] * (u2 - u1)[None, :]) / norm[:, None]
    return mu_u, np.broadcast_to(rows[:, None, :], (ne, k, mu_u.size)).copy()
