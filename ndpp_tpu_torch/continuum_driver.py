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

_CONTINUUM_TILE = 256  # rows per cm_moments_pointwise dispatch: one kernel launch on the card, chunked on the CPU


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
    ksel_override: int | None = None,
) -> np.ndarray:
    """(NE, L+1, G) for one law (unweighted), its rows split over `place`.

    Each family's cap (4096, 1024, _CONTINUUM_TILE) is rows per shard at
    the default device.e_tile = 512 and scales with it, so the driver's
    device-OOM retry (which halves e_tile) shrinks every family's tiles.

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
        plan = place.plan(ne, 4096, e_tile)
        pending = []
        with RunMetrics.span_or_null(metrics, "dispatch.continuum"):
            e_d, th_d, b_d = (plan.put(a) for a in (prep.e, prep.extra["theta"], prep.extra["b"]))
            for k, sl, start, length in plan.pieces:
                with place.shard(k):
                    frac = analytic_group_fractions(
                        e_d[k][sl], th_d[k][sl], b_d[k][sl], prep.extra["u"], bounds[k], law, clamp
                    )
                    pending.append((out[:, 0, :], start, length, place.fetch(frac)))
        with RunMetrics.span_or_null(metrics, "wait.continuum"):
            place.land(pending, "continuum")
        return out  # isotropic lab: moments l >= 1 vanish

    if prep.kind == "lab-tabular":
        k16 = unionize.bucket_pow2(prep.e_knots.shape[1])
        kn = unionize.pad_to(prep.e_knots, k16, axis=1)
        pd = unionize.pad_to(prep.pdf, k16, axis=1)
        mm = unionize.pad_to(prep.mom_knots, k16, axis=1)
        # per-row group-band windows: the outgoing support is the knot
        # range; narrow rows copy back (T, L+1, B) instead of dense G-wide
        # rows (banding.partition: wide rows keep the dense dispatch)
        subsets = _band_subsets(
            banding.partition(kn[:, 0], kn[:, -1], gs.bounds) if clamp else None, ne, ng, gs
        )
        pending = []
        finals = []
        with RunMetrics.span_or_null(metrics, "dispatch.continuum"):
            for idx, gw, g0s, b_rows in subsets:
                plan = place.plan(idx.size, 1024, e_tile)
                kn_d, pd_d, mm_d = (plan.put(a[idx]) for a in (kn, pd, mm))
                b_d = None if b_rows is None else plan.put(b_rows)
                buf = np.empty((idx.size, order + 1, gw))
                finals.append((idx, g0s, buf))
                for k, sl, start, length in plan.pieces:
                    with place.shard(k):
                        res = lab_tabular_moments(
                            kn_d[k][sl], pd_d[k][sl], mm_d[k][sl], bounds[k] if b_d is None else b_d[k][sl],
                            order, 8, clamp,
                        )
                        pending.append((buf, start, length, place.fetch(res)))
        with RunMetrics.span_or_null(metrics, "wait.continuum"):
            place.land(pending, "continuum")
        for idx, g0s, buf in finals:
            out[idx] = banding.densify(buf, g0s, ng)
        _add_discrete_lines(out, prep, gs, cfg, place)
        return out

    if prep.kind in ("cm-kalbach", "cm-tabular", "cm-nbody"):
        angular = {"cm-kalbach": "kalbach", "cm-tabular": "tabular", "cm-nbody": "isotropic"}[prep.kind]
        energy = "nbody" if prep.kind == "cm-nbody" else "tabular"
        # operands of the op, by name; the ones a law kind does not read stay None
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
        # the dense row) and cuts the Lagrange boundary-cumulant work from
        # G+1 to B+1 lookups. Wide-reach rows (a threshold reaction's top-E
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
        subsets = _band_subsets(part, ne, ng, gs)
        # Tabular-angle payloads carry data-knot-crossing C^1 kinks whose
        # closed-form w-images are outer panel EDGES (cross_edges), so every
        # panel's integrand is analytic and the G-independent lagrange split
        # converges spectrally at nq_w 12 / nq_y 8. Kalbach/nbody integrands
        # are smooth in w and run the lagrange split at nq_w 10 / nq_y 7
        # (the reference's production-shape gates; the orders are part of
        # the result, so the port keeps them).
        nq_w, nq_y = (12, 8) if angular == "tabular" else (10, 7)
        sy = cont_ops.inner_panel_count(ke, ksel, angular, kmu)
        budget = cont_ops.CHUNK_BUDGET_BYTES * e_tile // 512  # shrinks with the OOM retry's e_tile
        pending = []
        finals = []
        with RunMetrics.span_or_null(metrics, "dispatch.continuum"):
            for idx, gw, g0s, b_rows in subsets:
                plan = place.plan(idx.size, _CONTINUUM_TILE, e_tile)
                e_d = plan.put(prep.e[idx])
                dev = {name: None if a is None else plan.put(a[idx]) for name, a in host.items()}
                b_d = None if b_rows is None else plan.put(b_rows)
                buf = np.empty((idx.size, order + 1, gw))
                finals.append((idx, g0s, buf))
                npan = cont_ops.outer_panel_count(ke, gw, angular, kmu, "lagrange", angular == "tabular")
                for k, sl, start, length in plan.pieces:
                    cut = {name: None if a is None else a[k][sl] for name, a in dev.items()}
                    # outer panels per pass of the plain (CPU) path; the CUDA kernel takes the tile whole
                    chunk = cont_ops.chunk_for(length, nq_w, nq_y, sy, npan, budget)
                    if metrics is not None:
                        metrics.continuum_chunks[chunk] += 1
                    with place.shard(k):
                        res = cm_moments_pointwise(
                            e_d[k][sl], cut["kn"], cut["pd"], cut["rr"], cut["aa"],
                            None if muk is None else muk[k], cut["mup"], cut["emax"],
                            float(prep.nbody_expo or 0.0),
                            bounds[k] if b_d is None else b_d[k][sl],
                            awr, order, nq_w, nq_y, angular, energy, clamp, chunk, ksel,
                            "lagrange", angular == "tabular",
                            lanes=cont_ops.cm_tile_lanes(plan.tile_rows(start), npan * nq_w, place.devices[k]),
                        )
                        pending.append((buf, start, length, place.fetch(res)))
        with RunMetrics.span_or_null(metrics, "wait.continuum"):
            place.land(pending, "continuum")
        for idx, g0s, buf in finals:
            out[idx] = banding.densify(buf, g0s, ng)
        return out

    raise NdppError(f"unknown continuum preparation kind {prep.kind!r}")


def _band_subsets(part, ne: int, ng: int, gs):
    """Dispatch subsets [(row idx, out width, g0 | None, window bounds | None)].

    part: banding.partition result. One banded subset (narrow rows) plus
    one dense subset (wide rows), or a single dense subset covering all.
    """
    if part is None:
        return [(np.arange(ne), ng, None, None)]
    narrow, b_w, g0f = part
    nidx = np.nonzero(narrow)[0]
    subsets = [(nidx, b_w, g0f[nidx], banding.window_bounds(gs.bounds, g0f[nidx], b_w))]
    didx = np.nonzero(~narrow)[0]
    if didx.size:
        subsets.append((didx, ng, None, None))
    return subsets


def _add_discrete_lines(out: np.ndarray, prep: ContinuumPrepared, gs, cfg, place: rows_mod.Placement) -> None:
    """Add the ND>0 delta-line contribution (host/prep_continuum.discrete_line_rows)."""
    disc = prep.extra.get("disc")
    if disc is None:
        return
    plan = place.plan(disc[0].shape[0], 4096, cfg.device.e_tile)
    e_d, p_d, am_d = (plan.put(a) for a in disc)
    bounds = place.put_replicated(gs.bounds)
    lines = np.empty_like(out)
    pending = []
    for k, sl, start, length in plan.pieces:
        with place.shard(k):
            res = discrete_lines_moments(e_d[k][sl], p_d[k][sl], am_d[k][sl], bounds[k], cfg.clamp_outside)
            pending.append((lines, start, length, place.fetch(res)))
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
    entries: list[tuple[int, ContinuumPrepared]] = []
    for ri, (rxn, e_rows) in enumerate(rxn_rows):
        if not rxn.energy_dists:
            raise AceFormatError(f"MT={rxn.mt}: no energy distribution")
        for ed in rxn.energy_dists:
            with RunMetrics.span_or_null(metrics, "prep.continuum"):
                prep = prepare_continuum(nuc, rxn, ed, e_rows, order)
            if metrics is not None and prep.padded_elements:
                metrics.record_padding(prep.real_elements, prep.padded_elements)
            entries.append((ri, prep))

    pools: dict[tuple, list[tuple[int, ContinuumPrepared]]] = {}
    for ri, prep in entries:
        key = _pool_class(prep)
        if key is None:
            mom = _law_moments(prep, gs, order, cfg, nuc.awr, place, metrics)
            totals[ri] += prep.applicability[:, None, None] * mom
        else:
            pools.setdefault(key, []).append((ri, prep))

    for (kind, k16), members in sorted(pools.items()):
        if len(members) == 1:
            ri, prep = members[0]
            mom = _law_moments(prep, gs, order, cfg, nuc.awr, place, metrics)
            totals[ri] += prep.applicability[:, None, None] * mom
            continue
        ksel = None
        if kind == "cm-kalbach":
            with RunMetrics.span_or_null(metrics, "prep.continuum_window"):
                # per-item bounds on UNPADDED knots, combined as the max —
                # then the same hard quantization as the single-law path
                need = max(
                    _window_knot_bound(p.e, nuc.awr, p.e_knots) or k16 for _, p in members
                )
                ksel = quantize_ksel(need, k16)
        pooled = _pooled_prep(kind, k16, [p for _, p in members])
        mom_all = _law_moments(pooled, gs, order, cfg, nuc.awr, place, metrics, ksel_override=ksel)
        off = 0
        for ri, prep in members:
            mom = mom_all[off : off + prep.e.size]
            if kind == "lab-tabular" and prep.extra.get("disc") is not None:
                mom = mom.copy()  # the pooled buffer slice is shared
                _add_discrete_lines(mom, prep, gs, cfg, place)
            totals[ri] += prep.applicability[:, None, None] * mom
            off += prep.e.size
    return totals


def continuum_reaction_moments(nuc, rxn, e_grid, gs, order, cfg, place, metrics=None) -> np.ndarray:
    """Applicability-weighted sum over the reaction's law chain: (NE, L+1, G)."""
    return batched_continuum_moments(nuc, [(rxn, e_grid)], gs, order, cfg, place, metrics)[0]
