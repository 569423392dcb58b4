"""Fission chi collapse (config 4, BASELINE.json:10; SURVEY.md section 3.4).

Counterpart of ndpp_tpu/chi_driver.py.
chi_g'(E) = integral over g' of p(E'|E) from the fission MT's law chain
(prompt), plus precursor-weighted delayed spectra:

    chi_prompt_g(E)  = sum_laws p_law(E) * frac_law(E, g)
    chi_delayed_g(E) = sum_k P_k(E) * frac_k(E, g)   (P_k from the BDD block)
    chi_total_g(E)   = [nu_p chi_p + nu_d chi_d] / nu_t

Fission secondary energies are lab-frame in ACE; the energy pdf is collapsed
directly. nu-bar curves are evaluated on the same incident grid and stored.
"""

from __future__ import annotations

import numpy as np
import torch

from ndpp_tpu_torch import banding
from ndpp_tpu_torch.continuum_driver import ANALYTIC_TILE, TABULAR_TILE, add_discrete_lines
from ndpp_tpu_torch.host import unionize
from ndpp_tpu_torch.host.prep_continuum import ContinuumPrepared, prepare_continuum
from ndpp_tpu_torch.ops.chi import analytic_group_fractions, tabular_group_fractions
from ndpp_tpu_torch.parallel import rows as rows_mod
from ndpp_tpu_torch.utils import log as log_mod
from ndpp_tpu_torch.utils.errors import AceFormatError
from ndpp_tpu_torch.utils.metrics import RunMetrics

FISSION_MTS = (18, 19, 20, 21, 38)


def _law_fractions(prep, gs, cfg, place: rows_mod.Placement, metrics=None) -> np.ndarray:
    """(NE, G) group fractions of one law's energy pdf (tiled dispatch, each
    tile split over the shards of `place`)."""
    ne = prep.e.size
    bounds = place.put_replicated(gs.bounds)
    clamp = cfg.clamp_outside
    out = np.zeros((ne, gs.ng))
    if prep.kind == "lab-analytic":
        pending = []
        with RunMetrics.span_or_null(metrics, "dispatch.chi"):
            place.plan(ne, ANALYTIC_TILE, cfg.device.e_tile).dispatch(
                lambda piece, e, th, b: analytic_group_fractions(
                    e, th, b, prep.extra["u"], bounds[piece.k], prep.extra["law"], clamp
                ),
                out, pending, prep.e, prep.extra["theta"], prep.extra["b"],
            )
        with RunMetrics.span_or_null(metrics, "wait.chi"):
            place.land(pending, "chi")
        return out
    if prep.e_knots is None:
        raise AceFormatError(f"chi: unsupported spectrum kind {prep.kind!r}")
    k16 = unionize.bucket_pow2(prep.e_knots.shape[1])
    kn = unionize.pad_to(prep.e_knots, k16, axis=1)
    # per-row group-band windows: a spectrum's support is its knot range;
    # narrow rows copy back (T, B) instead of dense G-wide fraction rows,
    # wide rows keep the dense dispatch (banding.partition)
    banding.dispatch(
        place, banding.partition(kn[:, 0], kn[:, -1], gs.bounds) if clamp else None, gs.bounds,
        TABULAR_TILE, cfg.device.e_tile, out[:, None, :],
        lambda piece, kn, pd, win: tabular_group_fractions(
            kn, pd, bounds[piece.k] if win is None else win, clamp
        )[:, None],
        kn, unionize.pad_to(prep.pdf, k16, axis=1),
        metrics=metrics, family="chi",
    )
    # ND > 0 delta lines: their l=0 contribution is the line probability
    # in the containing group (ops.continuum.discrete_lines_moments l=0)
    add_discrete_lines(out[:, None, :], prep, gs, cfg, place)
    return out


def _batched_law_fractions(preps, gs, cfg, place: rows_mod.Placement, metrics=None) -> list[np.ndarray]:
    """One (NE_i, G) per law, with tabular laws POOLED by knot bucket into
    one tiled dispatch set: a fissionable nuclide's prompt laws plus its ~6
    delayed precursor spectra share their tiles and their one wait."""
    out: list = [None] * len(preps)
    pools: dict[int, list[int]] = {}
    for i, prep in enumerate(preps):
        if prep.kind == "lab-analytic" or prep.e_knots is None:
            out[i] = _law_fractions(prep, gs, cfg, place, metrics)
        else:
            pools.setdefault(unionize.bucket_pow2(prep.e_knots.shape[1]), []).append(i)
    for k16, idxs in sorted(pools.items()):
        if len(idxs) == 1:
            out[idxs[0]] = _law_fractions(preps[idxs[0]], gs, cfg, place, metrics)
            continue
        e_all = np.concatenate([preps[i].e for i in idxs])
        pooled = ContinuumPrepared(
            kind="lab-tabular",
            e=e_all,
            applicability=np.ones_like(e_all),  # weighting happens at the caller
            e_knots=np.concatenate([unionize.pad_to(preps[i].e_knots, k16, axis=1) for i in idxs]),
            pdf=np.concatenate([unionize.pad_to(preps[i].pdf, k16, axis=1) for i in idxs]),
        )
        frac_all = _law_fractions(pooled, gs, cfg, place, metrics)
        off = 0
        for i in idxs:
            n = preps[i].e.size
            f = frac_all[off : off + n]
            if preps[i].extra.get("disc") is not None:
                f = f.copy()  # the pooled buffer slice is shared
                add_discrete_lines(f[:, None, :], preps[i], gs, cfg, place)
            out[i] = f
            off += n
    return out


def chi_collapse(res, nuc, gs, cfg, place: rows_mod.Placement | torch.device, metrics=None) -> None:
    """Fill res.chi_* / res.nu_* in place; `place` is the run's Placement,
    or one device."""
    place = rows_mod.as_placement(place)
    log = log_mod.get()
    fission = None
    for mt in FISSION_MTS:
        if mt in nuc.reactions:
            fission = nuc.reactions[mt]
            break
    if fission is None or not fission.energy_dists:
        log.warning("chi: %s is fissionable but has no usable fission spectrum", nuc.name)
        return

    e_grid = res.energy
    ng = gs.ng

    # collect EVERY law (prompt + delayed) first, then dispatch with pooling
    prompt_items = []
    for ed in fission.energy_dists:
        with RunMetrics.span_or_null(metrics, "prep.chi"):
            prep = prepare_continuum(nuc, fission, ed, e_grid, order=0)
        if metrics is not None and prep.padded_elements:
            metrics.record_padding(prep.real_elements, prep.padded_elements)
        prompt_items.append((prep.applicability, prep))

    delayed_items = []
    if nuc.precursors and nuc.delayed_spectra:
        for prec, spec in zip(nuc.precursors, nuc.delayed_spectra):
            with RunMetrics.span_or_null(metrics, "prep.chi"):
                prep = prepare_continuum(nuc, fission, spec, e_grid, order=0)
            pk = np.clip(prec.probability(e_grid), 0.0, None)
            delayed_items.append((pk * prep.applicability, prep))

    fracs = _batched_law_fractions(
        [p for _, p in prompt_items + delayed_items], gs, cfg, place, metrics
    )
    prompt = np.zeros((e_grid.size, ng))
    for (w, _), f in zip(prompt_items, fracs[: len(prompt_items)]):
        prompt += w[:, None] * f

    delayed = None
    if delayed_items:
        delayed = np.zeros((e_grid.size, ng))
        for (w, _), f in zip(delayed_items, fracs[len(prompt_items) :]):
            delayed += w[:, None] * f
        # normalize delayed fractions if precursor probabilities don't sum to 1
        psum = np.sum([np.clip(p.probability(e_grid), 0.0, None) for p in nuc.precursors], axis=0)
        with np.errstate(invalid="ignore"):
            delayed = np.where(psum[:, None] > 0, delayed / np.where(psum[:, None] > 0, psum[:, None], 1.0), 0.0)

    nu_t = nuc.nu_total(e_grid) if nuc.nu_total is not None else None
    nu_d = nuc.nu_delayed(e_grid) if nuc.nu_delayed is not None else None
    nu_p = nuc.nu_prompt(e_grid) if nuc.nu_prompt is not None else None
    if nu_p is None and nu_t is not None and nu_d is not None:
        nu_p = nu_t - nu_d
    if nu_t is None and nu_p is not None:
        nu_t = nu_p + (nu_d if nu_d is not None else 0.0)

    res.chi_energy = e_grid
    res.chi_prompt = prompt
    if delayed is not None:
        res.chi_delayed = delayed
    if nu_p is not None:
        res.nu_prompt = nu_p
    if nu_d is not None:
        res.nu_delayed = nu_d
    if nu_t is not None:
        res.nu_total = nu_t
    if delayed is not None and nu_p is not None and nu_d is not None and nu_t is not None:
        with np.errstate(invalid="ignore", divide="ignore"):
            res.chi_total = (nu_p[:, None] * prompt + nu_d[:, None] * delayed) / nu_t[:, None]
    else:
        res.chi_total = prompt
