"""Bound-thermal S(alpha,beta) replacement driver (counterpart of ndpp_tpu/thermal_driver.py).

For nuclides with an S(alpha,beta) assignment (cfg.sab), the 0K elastic
channel below the thermal table's validity range is replaced by the bound
thermal channels (chemical binding + lattice coherence — physics the
free-gas model cannot represent):

    f_new = [ f_0K * sigma_s - sigma_el * f_el_0K
              + sigma_inel_th * f_inel_th + sigma_el_th * f_el_th ]
            / (sigma_s - sigma_el + sigma_inel_th + sigma_el_th)

Free-gas replacement then applies only ABOVE the table range (S(alpha,beta)
supersedes free-gas where tabulated; the driver passes e_min to
apply_freegas).

Moment conventions (the reference's):
- continuous inelastic moments are computed exactly at the table's incident
  energies and lin-log-interpolated onto union-grid rows — the shapes are
  smooth in E; discrete lines are interpolated in energy and placed per row;
- elastic moments are E'-preserving deltas, so their GROUP PLACEMENT is
  evaluated exactly at every union-grid row; coherent (Bragg) rows are
  closed-form per row, discontinuities included.
"""

from __future__ import annotations

import numpy as np
import torch

from ndpp_tpu_torch import banding
from ndpp_tpu_torch.config import BOLTZMANN_EV_PER_K
from ndpp_tpu_torch.freegas_driver import elastic_weights
from ndpp_tpu_torch.host.ace.thermal import ThermalTable, read_thermal_ace
from ndpp_tpu_torch.host.prep import prepare_twobody
from ndpp_tpu_torch.host.prep_thermal import prepare_thermal
from ndpp_tpu_torch.host.unionize import interp_rows_loglin
from ndpp_tpu_torch.ops.thermal import (
    coherent_elastic_moments,
    incoherent_elastic_placement,
    thermal_continuous_moments,
    thermal_discrete_moments,
)
from ndpp_tpu_torch.parallel import rows as rows_mod
from ndpp_tpu_torch.utils import log as log_mod
from ndpp_tpu_torch.utils.errors import ConfigError
from ndpp_tpu_torch.utils.metrics import RunMetrics


def resolve_tables(names: list[str], idx=None) -> list[ThermalTable]:
    """Resolve thermal table names: library index first, then built-in fixtures."""
    out = []
    for name in names:
        path = None
        if idx is not None:
            try:
                path = idx.path_for(name)
            except Exception:
                path = None
        if path is not None:
            out.append(read_thermal_ace(path))
            continue
        from ndpp_tpu_torch.host.ace import synth

        base = name.split(".")[0]
        if base in synth.THERMAL_FIXTURES:
            out.append(synth.build_thermal(base))
        else:
            raise ConfigError(f"thermal S(alpha,beta) table {name!r} not found in library or fixtures")
    return out


def match_tables(tables: list[ThermalTable], temps_k: list[float]):
    """Match each requested temperature to the nearest-kT table (or None)."""
    out = []
    for t_k in temps_k:
        kt = BOLTZMANN_EV_PER_K * t_k
        best = None
        for tab in tables:
            if best is None or abs(tab.kT - kt) < abs(best.kT - kt):
                best = tab
        if best is not None and abs(best.kT - kt) > 0.25 * kt:
            log_mod.get().warning(
                "sab: nearest table %s (kT=%.4g eV) is far from requested T=%.6g K", best.name, best.kT, t_k
            )
        out.append(best)
    return out


def apply_sab(
    scatter: np.ndarray, nuc, gs, cfg, e_grid: np.ndarray, tables, place: rows_mod.Placement | torch.device,
    metrics=None,
) -> np.ndarray:
    """scatter: (NT, NE, L+1, G) 0K combined moments; returns corrected array.

    tables: per-temperature ThermalTable (from match_tables); None entries
    skip. place: the run's Placement (each channel's rows split over its
    shards), or one device.
    """
    from ndpp_tpu_torch import driver as driver_mod

    log = log_mod.get()
    order = scatter.shape[2] - 1

    sigma_el, sigma_s = elastic_weights(nuc, e_grid)

    bounds_cl = gs.bounds.copy()
    if cfg.clamp_outside:
        # both edges swallow out-of-range outgoing energies (the clamp of
        # every other op): thermal E' can exceed the top boundary of a coarse
        # user structure
        bounds_cl[0] = 0.0
        bounds_cl[-1] = np.inf
    place = rows_mod.as_placement(place)
    bounds_d = place.put_replicated(bounds_cl)

    prep_cache: dict[str, object] = {}
    for k, tab in enumerate(tables):
        if tab is None:
            continue
        n_rows = int(np.searchsorted(e_grid, tab.e_max, side="right"))
        if n_rows == 0:
            continue
        rows = slice(0, n_rows)
        e_rows = e_grid[rows]
        prep = prep_cache.get(tab.name)
        if prep is None:
            prep = prep_cache[tab.name] = prepare_thermal(tab, order)

        # --- the table's channels on the device, one wait for both results
        pending = []
        with RunMetrics.span_or_null(metrics, "dispatch.sab"):
            if prep.kind == "continuous":
                # at the table's incident energies; lin-log onto the rows below
                f_inel = np.empty((prep.e_knots.shape[0], order + 1, gs.ng))
                place.whole(f_inel.shape[0]).dispatch(
                    lambda piece, kn, pdf, am: thermal_continuous_moments(kn, pdf, am, bounds_d[piece.k], order),
                    f_inel, pending, prep.e_knots, prep.pdf, prep.am,
                )
            else:
                # discrete lines are deltas: interpolating PLACED (L+1, G)
                # matrices across incident energy would smear each line over
                # two groups near its crossing, so the line ENERGIES and
                # angular factors are interpolated onto every row and placed
                ne_t = prep.e_in.size
                if ne_t > 1:
                    ii = np.clip(np.searchsorted(prep.e_in, e_rows, side="right") - 1, 0, ne_t - 2)
                    tf = np.clip((e_rows - prep.e_in[ii]) / (prep.e_in[ii + 1] - prep.e_in[ii]), 0.0, 1.0)
                    e_lines = (1 - tf)[:, None] * prep.e_out[ii] + tf[:, None] * prep.e_out[ii + 1]
                    am_lines = (1 - tf)[:, None, None] * prep.am_lines[ii] + tf[:, None, None] * prep.am_lines[ii + 1]
                else:
                    e_lines = np.broadcast_to(prep.e_out[0], (n_rows,) + prep.e_out.shape[1:])
                    am_lines = np.broadcast_to(prep.am_lines[0], (n_rows,) + prep.am_lines.shape[1:])
                w_lines = place.put_replicated(prep.w_lines)
                f_inel = np.empty((n_rows, order + 1, gs.ng))
                place.whole(n_rows).dispatch(
                    lambda piece, e_out, am: thermal_discrete_moments(
                        e_out, w_lines[piece.k], am, bounds_d[piece.k], clamp=cfg.clamp_outside
                    ),
                    f_inel, pending, e_lines, am_lines,
                )
            # elastic channel, exact placement per row
            f_el = None
            if prep.elastic_kind == "coherent":
                edges, s_b = place.put_replicated(prep.e_el), place.put_replicated(prep.bragg_s)
                f_el = np.empty((n_rows, order + 1, gs.ng))
                place.whole(n_rows).dispatch(
                    lambda piece, e: coherent_elastic_moments(
                        e, edges[piece.k], s_b[piece.k], bounds_d[piece.k], order
                    ),
                    f_el, pending, e_rows,
                )
            elif prep.elastic_kind == "incoherent":
                fvec = interp_rows_loglin(e_rows, prep.e_el, prep.am_el)  # (NR, L+1)
                f_el = np.empty((n_rows, order + 1, gs.ng))
                place.whole(n_rows).dispatch(
                    lambda piece, f, e: incoherent_elastic_placement(f, e, bounds_d[piece.k]),
                    f_el, pending, fvec, e_rows,
                )
        with RunMetrics.span_or_null(metrics, "wait.sab"):
            place.land(pending, "sab")
        if prep.kind == "continuous":
            f_inel = interp_rows_loglin(e_rows, prep.e_in, f_inel)  # (NR, L+1, G)
        if f_el is None:
            f_el = np.zeros_like(f_inel)
        sig_i = np.interp(e_rows, prep.e_in, prep.sigma_in, left=0.0, right=0.0)
        sig_e = np.zeros_like(e_rows)
        if prep.elastic_kind == "coherent":
            sig_e = tab.elastic.sigma_at(e_rows)
        elif prep.elastic_kind == "incoherent":
            sig_e = np.interp(e_rows, prep.e_el, prep.sigma_el, left=0.0, right=0.0)

        # --- 0K elastic moments to subtract: the main pools' two-body path
        # (pooled dispatch, tile cap e_tile), densified on the host
        (mom, g0), = driver_mod._tiled_twobody_multi(
            [prepare_twobody(nuc, nuc.elastic, e_rows)], gs.bounds, order, cfg.device.quad_points,
            cfg.device.e_tile, None, cfg.clamp_outside, place,
        )
        f_el0k = banding.densify(mom, g0, gs.ng)

        num = (
            scatter[k, rows] * sigma_s[rows, None, None]
            - sigma_el[rows, None, None] * f_el0k
            + sig_i[:, None, None] * f_inel
            + sig_e[:, None, None] * f_el
        )
        den = sigma_s[rows] - sigma_el[rows] + sig_i + sig_e
        ok = den > 0
        scatter[k, rows] = np.where(ok[:, None, None], num / np.where(ok, den, 1.0)[:, None, None], scatter[k, rows])
        if metrics is not None:
            metrics.moments_computed += f_inel.size + f_el.size
        log.debug(
            "sab: %s <- %s replaced %d rows below %.4g eV (%s inelastic, %s elastic)",
            nuc.name, tab.name, n_rows, tab.e_max, prep.kind, prep.elastic_kind,
        )
    return scatter


def sab_e_max(tables) -> list[float]:
    """Per-temperature free-gas lower limits implied by the sab tables."""
    return [0.0 if t is None else t.e_max for t in tables]
