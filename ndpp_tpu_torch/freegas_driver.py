"""Free-gas thermal replacement driver (counterpart of ndpp_tpu/freegas_driver.py).

Below the thermal cutoff (cfg.thermal_cutoff_kt * kT, conventionally 400 kT;
SURVEY.md section 3.3), the 0K elastic transfer moments are replaced by
target-in-motion free-gas moments with up-scatter, per temperature:

    scatter[T, rows] += w_el(rows) * (f_freegas(rows, T) - f_elastic_0K(rows))

with w_el the elastic share of the scattering weight. Cross-section WEIGHTS
keep the ACE table values (the table is already at its base temperature);
with cfg.freegas_xs_weighting the elastic channel is scaled by the ratio of
analytic Doppler sigma_eff factors between the requested and the table
temperature.
"""

from __future__ import annotations

import numpy as np
import torch

from ndpp_tpu_torch import banding
from ndpp_tpu_torch.config import BOLTZMANN_EV_PER_K
from ndpp_tpu_torch.host import unionize
from ndpp_tpu_torch.host.prep import prepare_twobody
from ndpp_tpu_torch.ops import freegas as freegas_ops
from ndpp_tpu_torch.ops.continuum import CHUNK_BUDGET_BYTES
from ndpp_tpu_torch.ops.freegas import freegas_moments_sab
from ndpp_tpu_torch.parallel import rows as rows_mod
from ndpp_tpu_torch.utils import log as log_mod
from ndpp_tpu_torch.utils.metrics import RunMetrics

_FREEGAS_TILE = 256  # rows per freegas_moments_sab dispatch at e_tile 512: one density launch on the card, chunked on the CPU
_ZERO_K_TILE = 256  # rows per two-body dispatch of the 0K elastic rows that are not sliced, at e_tile 512


def doppler_sigma_ratio(e: np.ndarray, awr: float, kt: float) -> np.ndarray:
    """Analytic sigma_eff/sigma_free for a Maxwellian free gas, constant
    free-atom cross section:

        (1 + 1/(2 x^2)) erf(x) + exp(-x^2) / (sqrt(pi) x),  x = sqrt(A E / kT)
    """
    from scipy.special import erf

    x = np.sqrt(np.maximum(awr * np.asarray(e, dtype=np.float64) / kt, 1e-30))
    return (1.0 + 0.5 / x**2) * erf(x) + np.exp(-(x**2)) / (np.sqrt(np.pi) * x)


def elastic_weights(nuc, e_grid):
    """(sigma_el, sigma_s) on e_grid: the elastic and the total scattering
    cross section, the weighting of the 0K combine that free-gas and
    S(alpha,beta) rows replace."""
    sigma_el = nuc.sigma_el
    if not np.array_equal(e_grid, nuc.energy):
        sigma_el = np.interp(e_grid, nuc.energy, sigma_el)
    sigma_s = np.zeros_like(e_grid)
    for rxn in nuc.scattering_reactions(include_fission=False):
        sig = nuc.sigma_on_grid(rxn)
        if not np.array_equal(e_grid, nuc.energy):
            sig = np.interp(e_grid, nuc.energy, sig)
        sigma_s += sig
    return sigma_el, sigma_s


def apply_freegas(
    scatter: np.ndarray,
    nuc,
    gs,
    cfg,
    e_grid: np.ndarray,
    place: rows_mod.Placement | torch.device,
    metrics=None,
    e_min_by_temp=None,
    elastic0k=None,
) -> np.ndarray:
    """scatter: (NT, NE, L+1, G) 0K combined moments; returns the corrected
    array. place: the run's Placement (every tile split over its shards),
    or one device.

    e_min_by_temp: optional per-temperature lower limits (eV) below which the
    free-gas replacement is SKIPPED — rows there are owned by an S(alpha,beta)
    table (thermal_driver.apply_sab supersedes free-gas where tabulated).

    elastic0k: optional (mom, g0, i0) from driver.scattering_moments — the
    UNWEIGHTED 0K elastic moments already computed on e_grid[i0:] (possibly
    banded). When present and every thermal row is evaluated, the rows are
    sliced from it instead of dispatched again.
    """
    from ndpp_tpu_torch import driver as driver_mod

    log = log_mod.get()
    if cfg.freegas_for and nuc.name not in cfg.freegas_for:
        return scatter
    order = scatter.shape[2] - 1
    e_tile = cfg.device.e_tile
    place = rows_mod.as_placement(place)

    with RunMetrics.span_or_null(metrics, "prep.freegas"):
        sigma_el, sigma_s = elastic_weights(nuc, e_grid)
        w_el = np.where(sigma_s > 0, sigma_el / np.where(sigma_s > 0, sigma_s, 1.0), 0.0)

    # Pass 1: enqueue EVERY temperature's scattering-law tiles and prepare
    # every 0K-elastic row set up front; pass 2 waits once and combines. The
    # 0K elastic rows of all temperatures ride ONE pooled two-body dispatch.
    plans = []
    zero_k_preps = []
    for k, temp_k in enumerate(cfg.temperatures):
        kt = BOLTZMANN_EV_PER_K * temp_k
        cutoff = cfg.thermal_cutoff_kt * kt
        n_rows = int(np.searchsorted(e_grid, cutoff))
        e_min = 0.0 if e_min_by_temp is None else float(e_min_by_temp[k])
        n_lo = int(np.searchsorted(e_grid, e_min, side="right")) if e_min > 0 else 0
        if n_rows <= n_lo:
            continue
        rows = slice(n_lo, n_rows)
        n_rows = n_rows - n_lo

        # Default (freegas_max_rows=0): evaluate EVERY thermal union row
        # exactly. A positive max_rows evaluates a bounded log-subgrid and
        # lin-log-interpolates the correction back: a speed knob whose
        # error (~1e-2 at 256 rows in the reference's tests) is far above
        # the 1e-8 bar.
        max_rows = cfg.device.freegas_max_rows or n_rows
        if n_rows > max_rows:
            sub_idx = np.unique(np.round(np.linspace(0, n_rows - 1, max_rows)).astype(int))
            e_sub = e_grid[rows][sub_idx]
        else:
            sub_idx = None
            e_sub = e_grid[rows]
        # Group WINDOW: only groups reachable from thermal energies matter,
        # E'_max ~ (v + 2 gamma (v + 8/beta))^2; a pow2 bucket of groups.
        gamma = nuc.awr / (nuc.awr + 1.0)
        beta = np.sqrt(nuc.awr / kt)
        vmax = np.sqrt(cutoff)
        e_reach = 1.5 * (vmax + 2.0 * gamma * (vmax + 8.0 / beta)) ** 2
        w = int(np.clip(np.searchsorted(gs.bounds, e_reach), 1, gs.ng))
        w = min(unionize.bucket_pow2(w), gs.ng)

        ns = e_sub.size
        plan = place.plan(ns, _FREEGAS_TILE, e_tile)
        # The op normalizes over ITS OWN window, so it always gets a
        # COVERING one: a leading [0, bounds_0) catch group holds the
        # below-range mass, folded into the edge group under clamping and
        # DROPPED otherwise (sum_g f0 < 1, the 0K clamp=False convention).
        bw = np.concatenate([[0.0], gs.bounds[: w + 1]])
        raw = np.empty((ns, order + 1, w + 1))  # [catch, g0..g_{w-1}] per row
        pending = []
        with RunMetrics.span_or_null(metrics, "dispatch.freegas"):
            bounds_pw = place.put_replicated(bw)
            e_d = plan.put(e_sub)
            chunk = freegas_ops.chunk_for(plan.piece_rows, CHUNK_BUDGET_BYTES * e_tile // 512)
            for sh, sl, start, length in plan.pieces:
                lanes = freegas_ops.sab_tile_lanes(plan.tile_rows(start), place.devices[sh])
                with place.shard(sh):
                    part = freegas_moments_sab(e_d[sh][sl], nuc.awr, kt, bounds_pw[sh], order, chunk=chunk,
                                               lanes=lanes)
                    pending.append((raw, start, length, place.fetch(part)))
        if elastic0k is not None and sub_idx is None and n_lo >= elastic0k[2]:
            zero_k_preps.append(None)  # exact rows: slice the main pool's elastic output
        else:
            with RunMetrics.span_or_null(metrics, "prep.twobody"):
                zero_k_preps.append(prepare_twobody(nuc, nuc.elastic, e_sub))
        plans.append((k, kt, rows, sub_idx, e_sub, w, raw, pending))

    if not plans:
        return scatter

    # 0K elastic for ALL temperatures: sliced from the main pool's elastic
    # output where possible, else one pooled dispatch set; banded results
    # are densified on the host for the combine
    todo_preps = [p for p in zero_k_preps if p is not None]
    computed = iter(
        driver_mod._tiled_twobody_multi(
            todo_preps, gs.bounds, order, cfg.device.quad_points, _ZERO_K_TILE * e_tile // 512, metrics,
            cfg.clamp_outside, place,
        )
        if todo_preps
        else []
    )
    f0k_all = []
    for (k, kt, rows, *_), prep in zip(plans, zero_k_preps):
        if prep is None:
            mom, g0, i0 = elastic0k
            sl = slice(rows.start - i0, rows.stop - i0)
            f0k_all.append(banding.densify(mom[sl], None if g0 is None else g0[sl], gs.ng))
        else:
            mom, g0 = next(computed)
            f0k_all.append(banding.densify(mom, g0, gs.ng))

    # Pass 2: wait for the scattering-law tiles and combine per temperature
    for (k, kt, rows, sub_idx, e_sub, w, raw, pending), f0k in zip(plans, f0k_all):
        with RunMetrics.span_or_null(metrics, "wait.freegas"):
            place.land(pending, "freegas")
        ffg = np.zeros((e_sub.size, order + 1, gs.ng))
        ffg[:, :, :w] = raw[:, :, 1:]
        if cfg.clamp_outside:
            ffg[:, :, 0] += raw[:, :, 0]

        def to_rows(arr, rows=rows, sub_idx=sub_idx, e_sub=e_sub):
            """Subgrid -> full rows (both kernels' shapes are smooth in E)."""
            if sub_idx is None:
                return arr
            return unionize.interp_rows_loglin(e_grid[rows], e_sub, arr)

        if cfg.freegas_xs_weighting:
            # the elastic channel's cross section at the REQUESTED temperature
            # is the table's scaled by the ratio of analytic free-gas sigma_eff
            # factors (exactly 1 when T matches the table)
            r = doppler_sigma_ratio(e_grid[rows], nuc.awr, kt) / doppler_sigma_ratio(
                e_grid[rows], nuc.awr, max(nuc.kT, 1e-12)
            )
            ffg_full = to_rows(ffg)
            f0k_full = to_rows(f0k)
            sig_el_r = sigma_el[rows]
            denom = sigma_s[rows] + sig_el_r * (r - 1.0)
            ok = denom > 0
            num = (
                scatter[k, rows] * sigma_s[rows, None, None]
                - sig_el_r[:, None, None] * f0k_full
                + (sig_el_r * r)[:, None, None] * ffg_full
            )
            scatter[k, rows] = np.where(
                ok[:, None, None], num / np.where(ok, denom, 1.0)[:, None, None], scatter[k, rows]
            )
        else:
            corr = to_rows(ffg - f0k)  # (rows, L+1, G) smooth in E
            scatter[k, rows] = scatter[k, rows] + w_el[rows, None, None] * corr
        if metrics is not None:
            metrics.moments_computed += ffg.size
        log.debug(
            "free-gas: %s kT=%.3g eV replaced %d rows (window %d/%d groups)", nuc.name, kt, e_sub.size, w, gs.ng,
        )
    return scatter
