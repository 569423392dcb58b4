"""Per-nuclide processing pipeline and run driver.

Counterpart of ndpp_tpu/driver.py:

    cli.run -> config.load -> host parse (ACE) -> host prep
      -> device: two-body moments (ops.twobody, group moments on the CUDA kernel),
                 continuum moments (continuum_driver -> ops.continuum),
                 bound-thermal S(alpha,beta) (thermal_driver -> ops.thermal),
                 free-gas (freegas_driver -> ops.freegas),
                 fission chi (chi_driver -> ops.chi)
      -> host write (HDF5/ASCII)

Per-nuclide failures are quarantined rather than fatal (SURVEY.md section
5 'failure detection'): the sweep is a bag of independent tasks.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ndpp_tpu_torch.chi_driver import chi_collapse
from ndpp_tpu_torch.config import RunConfig
from ndpp_tpu_torch.continuum_driver import batched_continuum_moments
from ndpp_tpu_torch.freegas_driver import apply_freegas
from ndpp_tpu_torch.groups import GroupStructure
from ndpp_tpu_torch.host import library_index, unionize
from ndpp_tpu_torch.host.ace.parse import read_ace
from ndpp_tpu_torch.host.ace.records import Nuclide, Reaction
from ndpp_tpu_torch.host.ace.thermal import ThermalTable
from ndpp_tpu_torch.host.prep import prepare_twobody
from ndpp_tpu_torch.io.library import AsciiLibraryWriter, NuclideResult, open_writers
from ndpp_tpu_torch.ops.twobody import twobody_moments
from ndpp_tpu_torch.parallel import rows as rows_mod
from ndpp_tpu_torch.thermal_driver import apply_sab, match_tables, resolve_tables, sab_e_max
from ndpp_tpu_torch.utils import log as log_mod
from ndpp_tpu_torch.utils.errors import ConfigError, NdppError
from ndpp_tpu_torch.utils.metrics import RunMetrics
from ndpp_tpu_torch.utils.timer import PhaseTimers


_DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")  # chrome-trace categories of device work


def is_twobody(rxn: Reaction) -> bool:
    """Elastic, or a reaction whose only energy law is 3 (discrete level)."""
    if rxn.mt == 2:
        return True
    return len(rxn.energy_dists) == 1 and rxn.energy_dists[0].law == 3


def reaction_yield(rxn: Reaction, e_grid: np.ndarray, include_yield: bool) -> np.ndarray:
    """Neutron multiplicity on the grid (1.0 everywhere if yields disabled)."""
    if not include_yield:
        return np.ones_like(e_grid)
    if rxn.yield_tab is not None:
        return rxn.yield_tab(e_grid)
    mult = rxn.multiplicity if rxn.multiplicity not in (0, 19) else 1
    return np.full_like(e_grid, float(mult))


def _band_windows(preps, idxs, bounds):
    """Per-row boundary-window plan for one pooled knot bucket, or None.

    Each two-body row's outgoing reach is closed-form:
    E'_lab(mu = -+1) = (sqrt(E'_cm) -+ sqrt(E)/(A+1))^2 — so the set of
    group boundaries a row can hit is a contiguous window. Banding pays on
    heavy nuclides (band width ~ ln(1/alpha) in lethargy: a handful of the
    361 groups), where it cuts the kernel's subinterval count (S = K + B
    + 11 instead of K + G + 11) and the result bytes (B/G of the dense
    row). Light nuclides (wide reach) return None and keep the dense path.

    Returns (B, g0_all (NE,)) with B a pow2 bucket; the window is clipped
    into [0, ng - B] so it always covers each row's [g_lo, g_hi].
    """
    ng = bounds.size - 1
    g_lo_parts = []
    g_hi_parts = []
    for i in idxs:
        p = preps[i]
        ecm = p.c2 * (p.e - p.c1)
        valid = ecm > 0
        ecm = np.where(valid, ecm, 1.0)
        root = np.sqrt(p.e * ecm)
        lo = np.where(valid, ecm + p.e / (p.awr + 1.0) ** 2 - 2.0 * root / (p.awr + 1.0), 0.0)
        hi = np.where(valid, ecm + p.e / (p.awr + 1.0) ** 2 + 2.0 * root / (p.awr + 1.0), 1.0)
        g_lo_parts.append(np.searchsorted(bounds, np.maximum(lo, 0.0), side="right") - 1)
        g_hi_parts.append(np.searchsorted(bounds, hi, side="left"))
    # one safety group each side absorbs breakpoint roundoff
    g_lo = np.clip(np.concatenate(g_lo_parts) - 1, 0, ng - 1)
    g_hi = np.clip(np.concatenate(g_hi_parts) + 1, 1, ng)
    width = int((g_hi - g_lo).max())
    b_w = unionize.bucket_pow2(width, lo=16)
    if b_w >= ng // 2:
        return None  # wide reach: the dense path is as good and simpler
    g0 = np.clip(g_lo, 0, ng - b_w)
    return b_w, g0


def _tiled_twobody_multi(preps, bounds, order, nq, tile_cap, metrics, clamp, place):
    """Batched two-body dispatch: ALL reactions sharing a knot bucket ride
    ONE row pool, with per-row group-band windows where the kinematic reach
    is narrow (see _band_windows).

    The kernel takes per-row (c1, c2, awr), so rows from different
    reactions concatenate freely. Each pool is cut into tiles of tile_cap
    rows per shard of `place` (a Placement, or one device); every piece's
    result is copied back into pinned host memory on its shard's stream as
    soon as it is enqueued, and the host waits once, after the last piece.

    preps: list of TwoBodyPrepared. Returns a list of (moments, g0) pairs:
    g0 is None for dense (NE_i, L+1, G) results, else the (NE_i,) window
    offsets of banded (NE_i, L+1, B) results.
    """
    place = rows_mod.as_placement(place)
    b = place.put_replicated(bounds)
    ng = bounds.size - 1
    buckets: dict[int, list[int]] = {}
    for i, prep in enumerate(preps):
        k16 = unionize.bucket_pow2(prep.knots.shape[1])
        buckets.setdefault(k16, []).append(i)
        if metrics is not None:
            metrics.record_padding(prep.real_elements, prep.padded_elements)

    outs: list[tuple[np.ndarray, np.ndarray | None] | None] = [None] * len(preps)
    pending = []  # (buffer, start, length, host result)
    slices = []  # (bucket buffer, g0_all | None, prep index, row offset)
    with RunMetrics.span_or_null(metrics, "dispatch.twobody"):
        for k16, idxs in sorted(buckets.items()):
            e_all = np.concatenate([preps[i].e for i in idxs])
            kn_all = np.concatenate([unionize.pad_to(preps[i].knots, k16, axis=1) for i in idxs])
            pd_all = np.concatenate([unionize.pad_to(preps[i].pdf, k16, axis=1) for i in idxs])
            c1_all = np.concatenate([np.full(preps[i].e.size, preps[i].c1) for i in idxs])
            c2_all = np.concatenate([np.full(preps[i].e.size, preps[i].c2) for i in idxs])
            aw_all = np.concatenate([np.full(preps[i].e.size, preps[i].awr) for i in idxs])
            ne = e_all.size
            plan = place.plan(ne, tile_cap)
            band = _band_windows(preps, idxs, bounds)
            if band is None:
                gw, g0_all = ng, None
                bounds_rows = None
            else:
                gw, g0_all = band
                # per-row boundary windows, gathered host-side (cheap)
                bounds_rows = bounds[g0_all[:, None] + np.arange(gw + 1)[None, :]]
            buf = np.empty((ne, order + 1, gw))
            off = 0
            for i in idxs:
                slices.append((buf, g0_all, i, off))
                off += preps[i].e.size
            plan.dispatch(
                lambda piece, e, kn, pd, c1, c2, aw, br: twobody_moments(
                    e, kn, pd, b[piece.k] if br is None else br, c1, c2, aw, order, nq, clamp
                ),
                buf, pending, e_all, kn_all, pd_all, c1_all, c2_all, aw_all, bounds_rows,
            )
    with RunMetrics.span_or_null(metrics, "wait.twobody"):
        place.land(pending, "twobody")  # one wait per shard, for every piece's copy
    for buf, g0_all, i, off in slices:
        n_i = preps[i].e.size
        g0_i = None if g0_all is None else g0_all[off : off + n_i]
        outs[i] = (buf[off : off + n_i], g0_i)
    return outs


def scattering_moments(
    nuc: Nuclide,
    gs: GroupStructure,
    cfg: RunConfig,
    e_grid: np.ndarray,
    place: rows_mod.Placement | torch.device,
    metrics: RunMetrics | None = None,
) -> tuple[np.ndarray, np.ndarray, tuple | None]:
    """Combined per-unit-scatter transfer moments over all scattering MTs.

    f_{l,g'}(E) = sum_MT [ sigma_MT(E) y_MT(E) / sigma_scat(E) ] f^MT_{l,g'}(E)
    with sigma_scat = sum_MT sigma_MT (fission excluded; SURVEY.md section 3.1).

    Returns (moments (NE, L+1, G), sigma_scatter (NE,), elastic0k):
    elastic0k is (mom, g0, i0) — the UNWEIGHTED elastic moments on
    e_grid[i0:] (banded when g0 is not None), which apply_freegas slices
    for its 0K subtraction — or None when the nuclide has no elastic channel.
    """
    log = log_mod.get()
    rxns = nuc.scattering_reactions(include_fission=False)
    ne = e_grid.size
    order = cfg.legendre_order
    sigma_by_rxn = {}
    with RunMetrics.span_or_null(metrics, "prep.sigma"):
        for rxn in rxns:
            sig = nuc.sigma_on_grid(rxn)
            if e_grid.size != nuc.energy.size or not np.array_equal(e_grid, nuc.energy):
                sig = np.interp(e_grid, nuc.energy, sig)
            sigma_by_rxn[rxn.mt] = sig
        sigma_s = np.sum([sigma_by_rxn[r.mt] for r in rxns], axis=0)
    accum = np.zeros((ne, order + 1, gs.ng))

    def _accumulate(rxn, i0, mom, g0=None):
        yld = reaction_yield(rxn, e_grid, cfg.include_yield)
        w = np.where(sigma_s > 0, sigma_by_rxn[rxn.mt] / np.where(sigma_s > 0, sigma_s, 1.0), 0.0)
        wy = (w * yld)[i0:, None, None]
        if g0 is None:
            accum[i0:] += wy * mom
            return
        # banded result: add each row's (L+1, B) block at its window offset
        # (unique (row, l, group) triples — fancy-indexed += is exact)
        n, lp1, gw = mom.shape
        cols = g0[:, None] + np.arange(gw)[None, :]
        accum[i0:][
            np.arange(n)[:, None, None], np.arange(lp1)[None, :, None], cols[:, None, :]
        ] += wy * mom

    tb_items: list[tuple[Reaction, int, object]] = []
    cont_items: list[tuple[Reaction, int]] = []
    elastic0k = None
    for rxn in rxns:
        # Threshold-row restriction: a reaction only contributes where
        # sigma_MT > 0, so the kernels run on e_grid[i0:] only (one margin
        # row below the first nonzero). Exact: the combine weight w is zero
        # on the skipped rows.
        sig = sigma_by_rxn[rxn.mt]
        nz = np.nonzero(sig > 0)[0]
        if nz.size == 0:
            log.debug("MT=%d skipped: sigma == 0 on the whole grid", rxn.mt)
            continue
        i0 = max(int(nz[0]) - 1, 0)
        sub = e_grid[i0:]
        if is_twobody(rxn):
            # collected, then dispatched as ONE batched row pool per knot bucket
            with RunMetrics.span_or_null(metrics, "prep.twobody"):
                prep = prepare_twobody(nuc, rxn, sub)
            tb_items.append((rxn, i0, prep))
        else:
            # collected, then dispatched with cross-reaction law pooling
            # (continuum_driver.batched_continuum_moments): all cm-kalbach /
            # lab-tabular laws of a nuclide sharing a knot bucket ride one
            # tiled dispatch set
            cont_items.append((rxn, i0))
        log.debug("MT=%d queued (%d/%d rows)", rxn.mt, sub.size, ne)
    if cont_items:
        moms = batched_continuum_moments(
            nuc, [(rxn, e_grid[i0:]) for rxn, i0 in cont_items], gs, order, cfg, place, metrics
        )
        for (rxn, i0), mom in zip(cont_items, moms):
            _accumulate(rxn, i0, mom)
    if tb_items:
        outs = _tiled_twobody_multi(
            [p for _, _, p in tb_items], gs.bounds, order, cfg.device.quad_points,
            cfg.device.e_tile, metrics, cfg.clamp_outside, place,
        )
        for (rxn, i0, _), (mom, g0) in zip(tb_items, outs):
            _accumulate(rxn, i0, mom, g0)
            if rxn.mt == 2:
                elastic0k = (mom, g0, i0)
    return accum, sigma_s, elastic0k


def process_nuclide(
    nuc: Nuclide,
    gs: GroupStructure,
    cfg: RunConfig,
    place: rows_mod.Placement | torch.device,
    metrics: RunMetrics | None = None,
    sab_tables=None,
) -> NuclideResult:
    """Full single-nuclide pipeline -> NuclideResult, every family's rows
    split over `place` (a Placement, or one device).

    sab_tables: optional list of ThermalTable for this nuclide (cfg.sab);
    bound-thermal replacement supersedes free-gas where tabulated.
    """
    e_grid = unionize.moment_grid(nuc.energy)
    if cfg.thin_tol > 0:
        keep = unionize.thin_grid(e_grid, np.stack([nuc.sigma_t, nuc.sigma_el]), cfg.thin_tol)
        e_grid = e_grid[keep]
    temps = np.asarray(cfg.temperatures, dtype=np.float64)
    nt = temps.size

    base, sigma_s, elastic0k = scattering_moments(nuc, gs, cfg, e_grid, place, metrics)
    scatter = np.broadcast_to(base, (nt,) + base.shape).copy()

    # Bound-thermal S(alpha,beta) replacement (below each table's range),
    # then free-gas above it up to the thermal cutoff, per temperature
    e_min_by_temp = None
    if sab_tables:
        matched = match_tables(sab_tables, list(cfg.temperatures))
        scatter = apply_sab(scatter, nuc, gs, cfg, e_grid, matched, place, metrics)
        e_min_by_temp = sab_e_max(matched)
    scatter = apply_freegas(scatter, nuc, gs, cfg, e_grid, place, metrics, e_min_by_temp, elastic0k)
    res = NuclideResult(
        name=nuc.name,
        zaid=nuc.zaid,
        awr=nuc.awr,
        kT=nuc.kT,
        energy=e_grid,
        temperatures=temps,
        scatter=scatter,
        sigma_scatter=sigma_s,
    )
    if nuc.fissionable:
        chi_collapse(res, nuc, gs, cfg, place, metrics)
    if metrics is not None:
        metrics.moments_computed += scatter.size
    return res


def _process_with_oom_retry(nuc, gs, cfg, place, metrics, sab_tables=None):
    """Device-OOM recovery (SURVEY.md section 5 'failure detection'): device
    memory grows with the tile size, so halving device.e_tile and retrying
    is sound; every family's per-shard tile scales with it, so the halving
    holds on every shard. Two halvings, then quarantine; any other device
    runtime fault quarantines the nuclide instead of killing the sweep."""
    from copy import deepcopy

    log = log_mod.get()
    place = rows_mod.as_placement(place)
    try_cfg = cfg
    for attempt in range(3):
        try:
            return process_nuclide(nuc, gs, try_cfg, place, metrics, sab_tables)
        except rows_mod.NonFiniteResult as e:
            raise NdppError(f"{e} for {nuc.name}") from e
        except RuntimeError as e:
            # torch.cuda.OutOfMemoryError is a RuntimeError; other CUDA and
            # plain python RuntimeErrors quarantine rather than kill the sweep
            msg = f"{type(e).__name__}: {e}"
            oom = isinstance(e, torch.cuda.OutOfMemoryError)
            if oom and attempt < 2 and try_cfg.device.e_tile > 64:
                try_cfg = deepcopy(try_cfg)
                try_cfg.device.e_tile //= 2
                for d in _cards(place):
                    with torch.cuda.device(d):
                        torch.cuda.empty_cache()
                log.warning("%s: device OOM — retrying with e_tile=%d", nuc.name, try_cfg.device.e_tile)
                continue
            label = (
                f"device failure (OOM, after {attempt} tile-halving retr"
                f"{'y' if attempt == 1 else 'ies'}, e_tile={try_cfg.device.e_tile})"
                if oom
                else "device runtime failure"
            )
            raise NdppError(f"{label} for {nuc.name}: {msg[:500]}") from e
    raise AssertionError("unreachable")


def resolve_device(device: str | torch.device) -> torch.device:
    """The run's device, taken as given: a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError(f"device {dev} requested but torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ConfigError(f"device must be cuda or cpu, got {dev}")
    return dev


def _cards(place: rows_mod.Placement) -> list[torch.device]:
    """The distinct CUDA devices of a placement, in order."""
    return list(dict.fromkeys(d for d in place.devices if d.type == "cuda"))


def resolve_placement(device, max_devices: int = 0) -> rows_mod.Placement:
    """The run's devices, one row shard each:

      "cuda"        the first max_devices visible cards (0 = all of them);
      "cuda:k"      card k alone;
      "cpu"         one CPU device;
      a sequence    those devices, in order (a card named twice gives two
                    shards on it, each with its own stream);
      a Placement   taken as it is.

    A CUDA device without a card raises ConfigError."""
    if isinstance(device, rows_mod.Placement):
        return device
    if isinstance(device, (list, tuple)):
        return rows_mod.Placement([resolve_device(d) for d in device])
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)  # raises without a card
        n = torch.cuda.device_count()
        n = n if max_devices <= 0 else min(max_devices, n)
        return rows_mod.Placement([torch.device("cuda", i) for i in range(n)])
    return rows_mod.Placement([resolve_device(dev)])


def run(cfg: RunConfig, device="cuda", debug_nans: bool = False) -> RunMetrics:
    """Full library run: parse -> process -> write, with quarantine + resume.

    device: the run's devices (resolve_placement): "cuda" spreads every
    family's rows over the first device.max_devices cards (0 = all visible),
    "cuda:k" or "cpu" runs on one device, a sequence names the shards.
    debug_nans: every family's results are checked for NaN/Inf where they
    land on the host (parallel.rows.Placement.land); a nuclide with one is
    quarantined with the family and its name as the reason.
    """
    log = log_mod.get()
    place = resolve_placement(device, cfg.device.max_devices)
    cards = _cards(place)
    timers = PhaseTimers()
    metrics = RunMetrics()
    t0 = time.perf_counter()
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    if cards:
        log.info(
            "devices %s (%s): device.precision=%r runs native float64; two-body group "
            "moments run the CUDA kernel csrc/twobody_inner.cu, the other families run torch ops",
            [str(d) for d in place.devices], ", ".join(torch.cuda.get_device_name(d) for d in cards),
            cfg.device.precision,
        )
    else:
        log.info(
            "device cpu: device.precision=%r runs native float64; two-body group "
            "moments run the kernel's plain torch version", cfg.device.precision,
        )
    if place.nd > 1:
        log.info("row-sharded dispatch over %d devices", place.nd)

    gs = cfg.group_structure()
    with timers.span("index"):
        idx = library_index.load(cfg.library)
    names = cfg.nuclides or idx.names()
    if names == ["all"]:
        names = idx.names()
    # thermal S(alpha,beta) tables (ACE class 't') are never sweep items
    names = [n for n in names if not n.endswith("t")]
    si, sn = cfg.shard_of()
    if sn > 1:
        names = names[si::sn]  # deterministic round-robin nuclide shard
        log.info("nuclide shard %s: %d of the library's nuclides", cfg.shard, len(names))

    # Sweep stall watchdog (utils/watchdog.py): every completed phase span
    # is a heartbeat; a stall dumps stacks and exits 4 so a supervisor can
    # restart with --resume.
    watchdog = None
    if cfg.device.watchdog_minutes > 0:
        from ndpp_tpu_torch.utils.watchdog import EXIT_STALL, SweepWatchdog

        watchdog = SweepWatchdog(cfg.device.watchdog_minutes * 60.0).start()
        metrics.timers.on_add = watchdog.progress
        timers.on_add = watchdog.progress
        log.info(
            "watchdog armed: exit(%d) after %.1f min without dispatch progress",
            EXIT_STALL,
            cfg.device.watchdog_minutes,
        )

    writers = open_writers(cfg, gs)
    quarantined: list[tuple[str, str]] = []
    todo = [n for n in names if not (cfg.resume and any(w.is_complete(n) for w in writers))]
    for skipped in set(names) - set(todo):
        log.info("resume: skipping %s (complete)", skipped)

    def _parse(name: str):
        return read_ace(idx.path_for(name), name_hint=name)

    sab_cache: dict[str, ThermalTable] = {}

    def _sab_tables(name: str):
        table_names = cfg.sab.get(name, [])
        if not table_names:
            return None
        missing = [t for t in table_names if t not in sab_cache]
        for t, tab in zip(missing, resolve_tables(missing, idx)):
            sab_cache[t] = tab
        return [sab_cache[t] for t in table_names]

    # 3-stage pipeline (SURVEY.md section 2 'Pipeline'): host ACE parsing is
    # prefetched on worker threads while the device computes the current
    # nuclide; writes happen on one dedicated writer thread.
    import queue as queue_mod
    import threading
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="ndpp-parse")
    futures = {}
    prefetch_depth = 2

    # Writer thread: writes of nuclide i overlap prep + device compute of
    # nuclide i+1. ALL writes happen on this one thread (single writer per
    # file); the bounded queue caps buffered results. Writer faults stay
    # systemic: the first exception aborts the sweep at the next enqueue
    # (or at finalize), never quarantines.
    write_q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
    writer_fault: list[BaseException] = []

    def _writer_loop():
        while True:
            res = write_q.get()
            if res is None:
                return
            try:
                with timers.span("write"):
                    for w in writers:
                        w.write_nuclide(res)
            except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
                writer_fault.append(e)
                return

    writer_thread = threading.Thread(target=_writer_loop, name="ndpp-write", daemon=True)
    writer_thread.start()

    def _enqueue_write(res):
        while True:
            if writer_fault:
                raise writer_fault[0]
            try:
                write_q.put(res, timeout=1.0)
                return
            except queue_mod.Full:
                continue

    profiler = None
    if cfg.device.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cards:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    try:
        rows_mod.debug_nans = debug_nans
        for i, name in enumerate(todo):
            for j in range(i, min(i + prefetch_depth, len(todo))):
                nm = todo[j]
                if nm not in futures:
                    futures[nm] = pool.submit(_parse, nm)
            write_phase = False
            try:
                snap = metrics.timers.snapshot()
                t_nuc = time.perf_counter()
                with timers.span("parse"):
                    nuc = futures.pop(name).result()
                with timers.span("compute"):
                    res = _process_with_oom_retry(nuc, gs, cfg, place, metrics, _sab_tables(name))
                # the write phase is OUTSIDE the quarantine catch: a writer
                # fault (disk full, permissions) is systemic, not a
                # per-nuclide data problem — abort the sweep
                write_phase = True
                with timers.span("write_enqueue"):
                    _enqueue_write(res)
                write_phase = False
                metrics.nuclides_done += 1
                sub = PhaseTimers.delta(snap, metrics.timers.snapshot())
                log.info(
                    "done %s (NE=%d) %.2fs %s",
                    name,
                    res.energy.size,
                    time.perf_counter() - t_nuc,
                    " ".join(f"{k}={v:.2f}" for k, v in sub.items()),
                )
            except Exception as e:
                if write_phase:
                    raise  # writer faults are systemic; see comment above
                # quarantine this nuclide, keep sweeping: ANY per-nuclide
                # failure must not kill the remaining sweep
                reason = str(e) if isinstance(e, NdppError) else f"{type(e).__name__}: {e}"
                quarantined.append((name, reason))
                metrics.nuclides_quarantined += 1
                log.error("quarantined %s: %s", name, reason)
    finally:
        rows_mod.debug_nans = False
        if watchdog is not None:
            watchdog.stop()
        if profiler is not None:
            profiler.stop()
            trace = Path(cfg.output.path).parent / "torch_trace.json"
            profiler.export_chrome_trace(str(trace))
            # device-busy time: kernels and copies in the trace (they do not
            # overlap on one stream; with several shards their sum counts
            # every stream's work, and can exceed the wall)
            events = json.loads(trace.read_text())["traceEvents"]
            busy_s = sum(e.get("dur", 0) for e in events if e.get("cat") in _DEVICE_EVENTS) * 1e-6
            log.info(
                "device profile -> %s; device busy %.4f s of %.4f s wall", trace, busy_s,
                time.perf_counter() - t0,
            )
        pool.shutdown(wait=False, cancel_futures=True)
        # poll the sentinel in: an unbounded put can block forever when the
        # writer thread died on a fault with the queue full
        while writer_thread.is_alive() and not writer_fault:
            try:
                write_q.put(None, timeout=1.0)
                break
            except queue_mod.Full:
                continue
        writer_thread.join()
        if writer_fault:
            raise writer_fault[0]
        metrics.wall_seconds = time.perf_counter() - t0
        for k, v in metrics.timers.report().items():
            timers.add(k, v)
        metrics.phase_seconds = timers.report()
        metrics.capture_device_mem(cards)
        for w in writers:
            if isinstance(w, AsciiLibraryWriter):
                metrics.ascii_values_native += w.values_native
                metrics.ascii_values_python += w.values_python
        for w in writers:
            w.finalize(metrics.to_dict())
    log.info("run complete: %s", metrics.json_line())
    if quarantined:
        log.warning("%d nuclide(s) quarantined: %s", len(quarantined), [q[0] for q in quarantined])
    return metrics
