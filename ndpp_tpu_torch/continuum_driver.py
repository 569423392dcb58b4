"""Continuum-law scattering-moment driver (config 4, BASELINE.json:10).

Counterpart of ndpp_tpu/continuum_driver.py. Maps each law of a continuum
reaction onto the matching device op (ops.continuum / ops.chi), weights by
the law applicability p(E), and sums.

A dispatch set is one law's (or one pool's) rows, cut into banded and dense
subsets (banding.partition) and each subset into row tiles, each tile split
over the run's shards (parallel.rows.RowPlan). A subset's operands go to
each shard once and pieces are slices of them; each piece's (T, L+1, G|B)
result starts its copy to pinned host memory as soon as it is enqueued, and
the host waits once per dispatch set.
"""

from __future__ import annotations

import numpy as np
import torch

from ndpp_tpu_torch import banding
from ndpp_tpu_torch.host import unionize
from ndpp_tpu_torch.host.prep_continuum import ContinuumPrepared, prepare_continuum
from ndpp_tpu_torch.ops import continuum as cont_ops
from ndpp_tpu_torch.ops.chi import analytic_group_fractions
from ndpp_tpu_torch.ops.continuum import cm_moments_pointwise, discrete_lines_moments, lab_tabular_moments
from ndpp_tpu_torch.parallel import rows as rows_mod
from ndpp_tpu_torch.utils.errors import AceFormatError, NdppError
from ndpp_tpu_torch.utils.metrics import RunMetrics

# Rows per shard of one dispatch at the default device.e_tile = 512 (each
# scales with e_tile: parallel.rows.tile_for), by op family
ANALYTIC_TILE = 4096  # analytic_group_fractions and discrete_lines_moments
TABULAR_TILE = 1024  # lab_tabular_moments and tabular_group_fractions
CM_TILE = 256  # cm_moments_pointwise: one kernel launch on the card, chunked on the CPU

# The CM path's outer w-panels end at every group boundary of the row's
# window ("panels"): each panel's integrand is analytic, so its GL rule
# converges and no group value rests on an interpolant. The G-independent
# "lagrange" split takes group values from the degree nq_w - 1 interpolant
# of each panel instead, and missed 1e-8 of a row's scale at 361 groups
# and P5 where a panel is wide beside P_5's structure: 5.4e-8 on an N-body
# (law 66) row near E'_lab = 0, 3.8e-8 on an actinide's Kalbach row at 20 MeV.
CM_GROUP_SPLIT = "panels"


def cm_quadrature(angular: str, order: int) -> tuple[int, int]:
    """(nq_w, nq_y): the GL nodes per outer w-panel and per inner y-panel of
    cm_moments_pointwise for a law kind at Legendre order `order`.

    A heavy target's inner window [|w - s|, w + s] is 2s wide, under one
    outgoing-knot spacing, so one inner panel carries the whole Kalbach
    factor exp(a mu_cm) and P_L(mu_lab) over mu in [-1, 1]: 7 nodes missed
    1e-8 of the row's scale by up to 3.2e-6 at P5 (U-235 (n,2n) at 20 MeV,
    a up to 3.3). 12 nodes are exact through degree 23 (P_5 in y is degree
    10, the pdf 2) and leave the exponential 11 degrees; above P5 the nodes
    grow with the order. Tabular angles split their inner panels at the
    mu-knot crossing roots and keep 8.
    """
    if angular == "tabular":
        return 10, 8
    return 10, max(12, order + 7)


def _window_knot_bound(e_rows: np.ndarray, awr: float, e_knots: np.ndarray) -> int:
    """Static bound on data knots inside any [|w-s|, w+s] window (ksel).

    The pointwise op's inner panels only ever span a y-window of width
    2s (s = sqrt(E)/(A+1)); gathering just the knots that can fall inside
    one window (plus the bracketing panel) keeps the inner edge count
    independent of the full knot table. Bucketed to powers of two, as the
    reference does, so both packages select the same knots.
    """
    ke = e_knots.shape[1]
    yk = np.sqrt(np.maximum(e_knots, 0.0))
    s = np.sqrt(np.maximum(e_rows, 0.0)) / (awr + 1.0)
    # per row: max count of knots within [yk_j, yk_j + 2s] over all j.
    # Both the data row and the shifted queries are sorted, so one
    # searchsorted per row is O(KE log KE), and the loop exits the moment
    # the bound degenerates to the full-knot path.
    need = 2
    ar = np.arange(ke)
    for c in range(e_rows.size):
        row = yk[c]
        hi = np.searchsorted(row, row + 2.0 * s[c], side="right")
        need = max(need, int((hi - ar).max()) + 2)  # + bracketing panels
        if need >= ke - 1:
            return 0  # full-knot path
    if need >= ke - 1:
        return 0  # full-knot path
    k = 4
    while k < need:
        k *= 2
    return min(k, ke)


def quantize_ksel(bound: int, k16: int) -> int:
    """Clamp a window-knot bound onto the allowed ksel rung ladder.

    Rungs {k/16, k/8, k/4} (each >= 4), the reference's ladder: the rung
    decides which knots become inner panel edges, so keeping it makes port
    and reference split the same panels. The result does not depend on the
    rung beyond quadrature roundoff (tests/test_torch_continuum_ops.py holds
    the rungs and the full-knot path to 1e-12 of the row's scale). Returns 0
    (full-knot path) when no rung fits.
    """
    if bound <= 0:
        return 0
    for rung in (k16 // 16, k16 // 8, k16 // 4):
        if rung >= 4 and rung < k16 and bound <= rung:
            return rung
    return 0


def _law_moments(
    prep: ContinuumPrepared, gs, order, cfg, awr: float, place: rows_mod.Placement, metrics=None,
    ksel_override: int | None = None, *, law: tuple,
) -> np.ndarray:
    """(NE, L+1, G) for one law (unweighted), its rows split over `place`.

    law: (ENDF law, frame), the key the metrics' counters file the rows'
    outer panels under.

    Each family's cap (ANALYTIC_TILE, TABULAR_TILE, CM_TILE) is rows per
    shard at the default device.e_tile = 512 and scales with it, so the
    driver's device-OOM retry (which halves e_tile) shrinks every family's
    tiles.

    ksel_override: the windowed-knot selection bound, already quantized —
    passed by the pooled path (batched_continuum_moments), whose
    concatenated rows carry edge-pad duplicate knots that would inflate
    the bound computed here.
    """
    ne = prep.e.size
    ng = gs.ng
    bounds = place.put_replicated(gs.bounds)
    clamp = cfg.clamp_outside
    e_tile = cfg.device.e_tile
    out = np.zeros((ne, order + 1, ng))

    if prep.kind == "lab-analytic":
        law = prep.extra["law"]
        pending = []
        with RunMetrics.span_or_null(metrics, "dispatch.continuum"):
            place.plan(ne, ANALYTIC_TILE, e_tile).dispatch(
                lambda piece, e, th, b: analytic_group_fractions(
                    e, th, b, prep.extra["u"], bounds[piece.k], law, clamp
                ),
                out[:, 0, :], pending, prep.e, prep.extra["theta"], prep.extra["b"],
            )
        with RunMetrics.span_or_null(metrics, "wait.continuum"):
            place.land(pending, "continuum")
        return out  # isotropic lab: moments l >= 1 vanish

    if prep.kind == "lab-tabular":
        k16 = unionize.bucket_pow2(prep.e_knots.shape[1])
        kn = unionize.pad_to(prep.e_knots, k16, axis=1)
        # per-row group-band windows: the outgoing support is the knot
        # range; narrow rows copy back (T, L+1, B) instead of dense G-wide
        # rows (banding.partition: wide rows keep the dense dispatch)
        banding.dispatch(
            place, banding.partition(kn[:, 0], kn[:, -1], gs.bounds) if clamp else None, gs.bounds,
            TABULAR_TILE, e_tile, out,
            lambda piece, kn, pd, mm, win: lab_tabular_moments(
                kn, pd, mm, bounds[piece.k] if win is None else win, order, 8, clamp
            ),
            kn, unionize.pad_to(prep.pdf, k16, axis=1), unionize.pad_to(prep.mom_knots, k16, axis=1),
            metrics=metrics, family="continuum",
        )
        add_discrete_lines(out, prep, gs, cfg, place)
        return out

    if prep.kind in ("cm-kalbach", "cm-tabular", "cm-nbody"):
        angular = {"cm-kalbach": "kalbach", "cm-tabular": "tabular", "cm-nbody": "isotropic"}[prep.kind]
        energy = "nbody" if prep.kind == "cm-nbody" else "tabular"
        # operands of the op, by name, in cm_piece's order; the ones a law kind does not read stay None
        host: dict[str, np.ndarray | None] = dict.fromkeys(("kn", "pd", "rr", "aa", "mup", "emax"))
        muk = None
        kmu = 0
        if energy == "nbody":
            host["emax"] = prep.nbody_emax
            ke = cont_ops.NBODY_KNOTS
            ksel = 0
        else:
            k16 = unionize.bucket_pow2(prep.e_knots.shape[1])
            host["kn"] = unionize.pad_to(prep.e_knots, k16, axis=1)
            host["pd"] = unionize.pad_to(prep.pdf, k16, axis=1)
            ke = k16
            if prep.kind == "cm-kalbach":
                host["rr"] = unionize.pad_to(prep.r_rows, k16, axis=1)
                host["aa"] = unionize.pad_to(prep.a_rows, k16, axis=1)
            else:
                muk = place.put_replicated(prep.mu_knots)
                kmu = prep.mu_knots.size
                host["mup"] = unionize.pad_to(prep.mu_pdf, k16, axis=1)
            if ksel_override is not None:
                ksel = ksel_override
            else:
                with RunMetrics.span_or_null(metrics, "prep.continuum_window"):
                    # bound on the UNPADDED knots: edge-pad duplicates all sit
                    # at the top of the window and would inflate `need` past
                    # the windowed-path threshold
                    ksel = quantize_ksel(_window_knot_bound(prep.e, awr, prep.e_knots), k16)
        # per-row group-band windows: the CM kinematic reach
        # [E'_min, E'_max] is closed-form from the knot table and s —
        # narrow for exactly the heavy nuclides that dominate a library —
        # and the banded call both shrinks the bytes copied back (B/G of
        # the dense row) and cuts the outer panels at B+1 boundaries
        # instead of G+1. Wide-reach rows (a threshold reaction's top-E
        # rows see the whole structure) keep the dense dispatch.
        if clamp:
            if energy == "nbody":
                sup_kn = np.stack(
                    [np.zeros(ne), np.maximum(np.asarray(prep.nbody_emax, dtype=np.float64), 0.0)],
                    axis=1,
                )
            else:
                sup_kn = host["kn"]
            part = banding.partition(*banding.support_cm(prep.e, awr, sup_kn), gs.bounds)
        else:
            part = None
        # Tabular-angle payloads carry data-knot-crossing C^1 kinks whose
        # closed-form w-images are outer panel edges too (cross_edges).
        tab = angular == "tabular"
        nq_w, nq_y = cm_quadrature(angular, order)
        sy = cont_ops.inner_panel_count(ke, ksel, angular, kmu)
        budget = cont_ops.CHUNK_BUDGET_BYTES * e_tile // 512  # shrinks with the OOM retry's e_tile

        def cm_piece(piece, e, kn, pd, rr, aa, mup, emax, win):
            b = bounds[piece.k] if win is None else win
            npan = cont_ops.outer_panel_count(ke, b.shape[-1] - 1, angular, kmu, CM_GROUP_SPLIT, tab)
            # outer panels per pass of the plain (CPU) path; the CUDA kernel takes the tile whole
            chunk = cont_ops.chunk_for(piece.length, nq_w, nq_y, sy, npan, budget)
            if metrics is not None:
                metrics.continuum_outer_panels[law] += piece.length * npan
                metrics.continuum_chunks[chunk] += 1
            return cm_moments_pointwise(
                e, kn, pd, rr, aa, None if muk is None else muk[piece.k], mup, emax, float(prep.nbody_expo or 0.0),
                b, awr, order, nq_w, nq_y, angular, energy, clamp, chunk, ksel, CM_GROUP_SPLIT, tab,
                lanes=cont_ops.cm_tile_lanes(piece.tile, npan * nq_w, place.devices[piece.k]),
            )

        with RunMetrics.span_or_null(metrics, "continuum.kernel"):
            banding.dispatch(
                place, part, gs.bounds, CM_TILE, e_tile, out, cm_piece, prep.e, *host.values(),
                metrics=metrics, family="continuum",
            )
        return out

    raise NdppError(f"unknown continuum preparation kind {prep.kind!r}")


def add_discrete_lines(out: np.ndarray, prep: ContinuumPrepared, gs, cfg, place: rows_mod.Placement) -> None:
    """Add the ND>0 delta-line contribution (host/prep_continuum.discrete_line_rows)."""
    disc = prep.extra.get("disc")
    if disc is None:
        return
    bounds = place.put_replicated(gs.bounds)
    lines = np.empty_like(out)
    pending = []
    place.plan(disc[0].shape[0], ANALYTIC_TILE, cfg.device.e_tile).dispatch(
        lambda piece, e, p, am: discrete_lines_moments(e, p, am, bounds[piece.k], cfg.clamp_outside),
        lines, pending, *disc,
    )
    place.land(pending, "continuum")
    out += lines


def _pool_class(prep: ContinuumPrepared):
    """Dispatch-pool class key, or None if the law cannot pool.

    cm-kalbach and lab-tabular laws sharing a knot bucket concatenate
    freely (the ops are per-row); cm-tabular laws carry a law-specific
    shared mu grid, cm-nbody a static exponent, lab-analytic a static law
    number — those stay per-law (each is a single cheap dispatch anyway).
    """
    if prep.kind in ("cm-kalbach", "lab-tabular"):
        return (prep.kind, unionize.bucket_pow2(prep.e_knots.shape[1]))
    return None


def _pooled_prep(kind: str, k16: int, preps: list[ContinuumPrepared]) -> ContinuumPrepared:
    """Concatenate same-class laws into one synthetic row pool."""
    cat = lambda key: np.concatenate(  # noqa: E731
        [unionize.pad_to(getattr(p, key), k16, axis=1) for p in preps]
    )
    e_all = np.concatenate([p.e for p in preps])
    pooled = ContinuumPrepared(
        kind=kind,
        e=e_all,
        applicability=np.ones_like(e_all),  # weighting happens per item at split
        e_knots=cat("e_knots"),
        pdf=cat("pdf"),
    )
    if kind == "cm-kalbach":
        pooled.r_rows = cat("r_rows")
        pooled.a_rows = cat("a_rows")
    else:  # lab-tabular (discrete lines handled per item after the split)
        pooled.mom_knots = cat("mom_knots")
    return pooled


def batched_continuum_moments(
    nuc, rxn_rows, gs, order, cfg, place: rows_mod.Placement | torch.device, metrics=None
) -> list[np.ndarray]:
    """Per-reaction continuum moments with CROSS-REACTION dispatch pooling.

    rxn_rows: list of (rxn, e_rows) for one nuclide; place: the run's
    Placement, or one device. Returns one
    applicability-weighted (NE_i, L+1, G) per reaction. All cm-kalbach
    (and separately lab-tabular) laws sharing a knot bucket ride ONE tiled
    dispatch set instead of one per reaction: fewer, larger tiles, and one
    wait for the pool's results.
    """
    place = rows_mod.as_placement(place)
    totals = [np.zeros((e_rows.size, order + 1, gs.ng)) for _, e_rows in rxn_rows]
    entries: list[tuple[int, tuple, ContinuumPrepared]] = []
    for ri, (rxn, e_rows) in enumerate(rxn_rows):
        if not rxn.energy_dists:
            raise AceFormatError(f"MT={rxn.mt}: no energy distribution")
        for ed in rxn.energy_dists:
            with RunMetrics.span_or_null(metrics, "prep.continuum"):
                prep = prepare_continuum(nuc, rxn, ed, e_rows, order)
            law = (ed.law, rxn.frame)
            if metrics is not None:
                metrics.continuum_rows[law] += prep.e.size
                if prep.padded_elements:
                    metrics.record_padding(prep.real_elements, prep.padded_elements)
            entries.append((ri, law, prep))

    pools: dict[tuple, list[tuple[int, tuple, ContinuumPrepared]]] = {}
    for ri, law, prep in entries:
        key = _pool_class(prep)
        if key is None:
            mom = _law_moments(prep, gs, order, cfg, nuc.awr, place, metrics, law=law)
            totals[ri] += prep.applicability[:, None, None] * mom
        else:
            pools.setdefault(key, []).append((ri, law, prep))

    for (kind, k16), members in sorted(pools.items()):
        if len(members) == 1:
            ri, law, prep = members[0]
            mom = _law_moments(prep, gs, order, cfg, nuc.awr, place, metrics, law=law)
            totals[ri] += prep.applicability[:, None, None] * mom
            continue
        ksel = None
        if kind == "cm-kalbach":
            with RunMetrics.span_or_null(metrics, "prep.continuum_window"):
                # per-item bounds on UNPADDED knots, combined as the max —
                # then the same hard quantization as the single-law path
                need = max(
                    _window_knot_bound(p.e, nuc.awr, p.e_knots) or k16 for _, _, p in members
                )
                ksel = quantize_ksel(need, k16)
        pooled = _pooled_prep(kind, k16, [p for _, _, p in members])
        # a pool holds one preparation kind: cm-kalbach is law 44 alone, and
        # lab-tabular rows integrate no outer panels
        mom_all = _law_moments(pooled, gs, order, cfg, nuc.awr, place, metrics, ksel_override=ksel,
                               law=members[0][1])
        off = 0
        for ri, _, prep in members:
            mom = mom_all[off : off + prep.e.size]
            if kind == "lab-tabular" and prep.extra.get("disc") is not None:
                mom = mom.copy()  # the pooled buffer slice is shared
                add_discrete_lines(mom, prep, gs, cfg, place)
            totals[ri] += prep.applicability[:, None, None] * mom
            off += prep.e.size
    return totals


def continuum_reaction_moments(nuc, rxn, e_grid, gs, order, cfg, place, metrics=None) -> np.ndarray:
    """Applicability-weighted sum over the reaction's law chain: (NE, L+1, G)."""
    return batched_continuum_moments(nuc, [(rxn, e_grid)], gs, order, cfg, place, metrics)[0]
