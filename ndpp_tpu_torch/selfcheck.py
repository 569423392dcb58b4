"""Accuracy gate on the card at production shape (counterpart of ndpp_tpu/selfcheck.py).

``python -m ndpp_tpu_torch selfcheck`` runs it and fails loudly when any
family drifts past the 1e-8 accuracy bar (BASELINE.json:5):

  - two-body: the hand-written CUDA kernel (ops/twobody_inner.
    twobody_group_moments) against its plain torch version on the same card
    and the same panels, at the full production shape (P5, 361 groups,
    2048-row tile, nq 16), with a probe batch that mixes smooth, step and
    forward-peaked pdfs, discrete-level kinematics (c1 != 0) on half the
    rows and AWR log-uniform in [0.999, 240];
  - free-gas: the production scattering-law kernel (freegas_moments_sab,
    whose density is the hand-written CUDA kernel ops/freegas.sab_density on
    the card) against the structurally independent panel-split quadrature
    kernel (freegas_moments_panelsplit, torch on every device) at the
    production 257-group window;
  - continuum: the production Lagrange group split at production quadrature
    against the boundary-edged panels split at higher quadrature, on rows
    that straddle the top group boundary, with a small-`a` probe and a
    tabular-angle leg (on the card both run the inner integral through the
    hand-written CUDA kernel ops/continuum.cm_inner_moments);
  - chi: the tabular collapse kernel against an exact host integral of the
    same piecewise-linear pdf.

Every check takes its device explicitly (default cuda, which raises without a
card: a gate that cannot run on the card is a failure, not a skip). On the
CPU the two-body leg reports why it did not run, since the kernel exists only
on a CUDA device, and the families run their plain torch code. Each check
takes its sizes as keyword arguments, the production values by default, so
that the tests can run it small on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

PROD_TILE = 2048
PROD_K = 48
PROD_NG = 361
PROD_ORDER = 5
PROD_NQ = 16
TWOBODY_GATE = 1e-8  # max relative error (floor 1e-6) of the kernel against its plain version


def _bounds(ng: int, lo: float, hi: float) -> np.ndarray:
    """The production group structure at 361 groups, else log-uniform on [lo, hi]."""
    from ndpp_tpu_torch import groups

    if ng == 361:
        return groups.get("uniform-lethargy-361").bounds
    return np.exp(np.linspace(np.log(lo), np.log(hi), ng + 1))


def production_inputs(tile: int = PROD_TILE, k: int = PROD_K, ng: int = PROD_NG, device="cuda"):
    """Synthetic two-body batch at the production shape, float64 on `device`.

    Returns (e0, args): args = (knots, pdf, bounds, c1, c2, awr), the
    arguments of ops.twobody.twobody_moments after e. The batch spans the
    input families the sweep dispatches: rows alternate smooth / step
    (equiprobable-bin-like) / forward-peaked pdfs; AWR is log-uniform per row
    in [0.999, 240]; half the rows carry discrete-level kinematics (c1 != 0
    with a matching threshold shift). The numpy arrays are the reference's,
    from the same default_rng(7).
    """
    dev = torch.device(device)
    rng = np.random.default_rng(7)
    e = np.exp(rng.uniform(np.log(1e2), np.log(1e6), size=tile))
    knots = np.broadcast_to(np.linspace(-1.0, 1.0, k), (tile, k)).copy()
    pdf = np.abs(0.5 + 0.1 * rng.standard_normal((tile, k)))
    # step rows: 32-equiprobable-bin style plateaus on the shared knot ladder
    # (values constant over runs of 3 knots)
    step_rows = np.arange(tile) % 3 == 1
    plateau = np.repeat(np.abs(0.2 + rng.standard_normal((tile, (k + 2) // 3))), 3, axis=1)[:, :k]
    pdf[step_rows] = plateau[step_rows]
    # peaked rows: strong forward anisotropy (exp ramp in mu)
    peak_rows = np.arange(tile) % 3 == 2
    pdf[peak_rows] = np.exp(3.0 * knots[peak_rows])
    widths = np.diff(knots, axis=-1)
    pdf /= np.sum(0.5 * (pdf[:, 1:] + pdf[:, :-1]) * widths, axis=-1, keepdims=True)
    bounds = _bounds(ng, 1e-1, 2e7)
    awr = np.exp(rng.uniform(np.log(0.999), np.log(240.0), size=tile))
    # discrete-level kinematics on half the rows: E'_cm = c1 + c2 E with
    # c1 = -|Q| A/(A+1) (twobody_constants convention), |Q| below threshold
    c1 = np.zeros(tile)
    lev = np.arange(tile) % 2 == 1
    q_abs = 0.5 * e * awr / (awr + 1.0)  # safely above threshold
    c1[lev] = -(q_abs * awr / (awr + 1.0))[lev]
    c2 = (awr / (awr + 1.0)) ** 2
    args = tuple(torch.as_tensor(x, dtype=torch.float64, device=dev) for x in (knots, pdf, bounds, c1, c2, awr))
    return torch.as_tensor(e, dtype=torch.float64, device=dev), args


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _errpair(got, ref, floor: float = 1e-6):
    """(max abs, max relative) error; relative to max(|ref|, floor), since the
    moments are O(1) and a relative error below the floor is noise."""
    got, ref = _np(got), _np(ref)
    a = np.abs(got - ref)
    denom = np.maximum(np.abs(ref), floor)
    return float(a.max()), float((a / denom).max())


def _family_gate(got, ref) -> dict:
    """The 1e-8 metric for row-normalized moment tensors (the reference's
    definition): absolute error <= 1e-8 on row-normalized values AND relative
    error <= 1e-7 among elements carrying >= 10% of their row's dominant
    moment (the looser relative leg absorbs the budget of comparing two
    independent kernels, each with its own ~1e-9 quadrature envelope)."""
    got, ref = _np(got), _np(ref)
    a = np.abs(got - ref)
    f0 = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (ref.ndim - 1))
    big = np.abs(ref) >= 0.1 * f0
    rel_big = np.where(big, a / np.maximum(np.abs(ref), 1e-300), 0.0)
    return {
        "max_abs": float(a.max()),
        "max_rel_significant": float(rel_big.max()),
        "ok": bool(a.max() <= 1e-8 and rel_big.max() <= 1e-7),
    }


def _worst(gates: list[dict]) -> dict:
    return {
        "max_abs": max(g["max_abs"] for g in gates),
        "max_rel_significant": max(g["max_rel_significant"] for g in gates),
        "ok": all(g["ok"] for g in gates),
    }


def check_freegas(
    device="cuda", rows: int = 8, window: int = 256, awrs=(0.999, 238.0), nq=(16, 20, 20), order: int = PROD_ORDER
) -> dict:
    """freegas_moments_sab against the independent panel-split kernel at the
    production window (the 361-group structure's lowest `window` groups plus
    the below-range catch group), at light and heavy AWR. The panel-split
    quadrature (16, 20, 20) keeps the reference below the gate by a wide
    margin; (12, 16, 16) was the gate's own limiter at 1.0e-8 on the TPU
    round's measurement."""
    from ndpp_tpu_torch import groups
    from ndpp_tpu_torch.ops.freegas import freegas_moments_panelsplit, freegas_moments_sab

    dev = torch.device(device)
    kt = 0.0253
    gsb = groups.get("uniform-lethargy-361").bounds
    bw = torch.as_tensor(np.concatenate([[0.0], gsb[: window + 1]]), device=dev)
    e = torch.as_tensor(np.geomspace(1e-3, 10.0, rows), device=dev)
    gates = []
    for awr in awrs:
        got = freegas_moments_sab(e, awr, kt, bw, order)
        ref = freegas_moments_panelsplit(e, awr, kt, bw, order, *nq)
        gates.append(_family_gate(got, ref))
    return {**_worst(gates), "rows": rows, "window": window, "awr": list(awrs), "nq": list(nq)}


def check_continuum(device="cuda", rows: int = 16, k: int = 32, ng: int = PROD_NG, order: int = PROD_ORDER) -> dict:
    """Continuum gate at production shape: rows whose outgoing support
    straddles the top group boundary, light and heavy AWR, and both angular
    payloads the sweep dispatches (Kalbach and tabular-angle). Each leg: the
    continuum driver's group split and quadrature (CM_GROUP_SPLIT,
    cm_quadrature) against the boundary-edged panels split at 16 nodes a
    panel."""
    from ndpp_tpu_torch.continuum_driver import CM_GROUP_SPLIT, cm_quadrature
    from ndpp_tpu_torch.ops.continuum import cm_moments_pointwise

    dev = torch.device(device)
    bounds = torch.as_tensor(_bounds(ng, 1e2, 2e7), device=dev)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    def payload(awr):
        e = np.geomspace(3e6, 2e7, rows)  # top rows straddle bounds[-1]
        emax_r = (e - 2e6) * awr / (awr + 1.0)
        kn = np.linspace(1e3, emax_r, k, axis=-1)
        pd = kn * np.exp(-kn / (emax_r[:, None] / 4.0))
        pd /= np.trapezoid(pd, kn, axis=1)[:, None]
        rr = np.full((rows, k), 0.35)
        aa = 0.2 + 1.3 * kn / np.maximum(emax_r[:, None], 1.0)
        return e, kn, pd, rr, aa

    zeros = torch.zeros(rows, dtype=torch.float64, device=dev)
    gates = []
    small_gates = []
    for awr in (1.5, 238.0):
        e, kn, pd, rr, aa = payload(awr)
        muk = t(np.array([-1.0, 1.0]))
        mup = torch.zeros((rows, k, 2), dtype=torch.float64, device=dev)
        common = (t(e), t(kn), t(pd), t(rr), t(aa), muk, mup, zeros, 0.0, bounds, awr, order)
        got = cm_moments_pointwise(*common, *cm_quadrature("kalbach", order), "kalbach", "tabular", True, 8, 0,
                                   CM_GROUP_SPLIT)
        ref = cm_moments_pointwise(*common, 16, 16, "kalbach", "tabular", True, 8, 0, "panels")
        gates.append(_family_gate(got, ref))

        # Small-a probe: at the a = 0 clamp a law-44 row is isotropic to
        # O(a), so the independent reference is the isotropic angular path
        # at the same quadrature. A formula-level regression in the Kalbach
        # angular factor (e.g. the e^a - e^-a cancellation, ~5e-5 at the
        # clamp) shows here, where the two-quadrature comparison above cannot
        # see it (both legs share that formula elementwise).
        small = (t(e), t(kn), t(pd), t(rr), torch.zeros_like(t(aa)), muk, mup, zeros, 0.0, bounds, awr, order)
        got0 = cm_moments_pointwise(*small, 8, 8, "kalbach", "tabular", True, 8, 0, "lagrange")
        ref0 = cm_moments_pointwise(*small, 8, 8, "isotropic", "tabular", True, 8, 0, "lagrange")
        small_gates.append(_family_gate(got0, ref0))

    # tabular-angle leg (law 61-class payload): the production setting
    # (with the K x KMU crossing-image edges) against the boundary-edged
    # panels split at 16/8, also with crossing edges. With every crossing
    # image an outer panel edge both converge spectrally on this rough
    # payload, so this leg holds the full 1e-8 metric, absolute and
    # relative-significant.
    awr = 55.4
    e, kn, pd, _, _ = payload(awr)
    kmu = 9
    muk_t = np.linspace(-1.0, 1.0, kmu)
    rng = np.random.default_rng(13)
    mup_t = np.abs(0.5 + 0.2 * rng.standard_normal((rows, k, kmu)))
    mup_t /= np.trapezoid(mup_t, muk_t, axis=2)[:, :, None]
    zk = torch.zeros((rows, k), dtype=torch.float64, device=dev)
    common_t = (t(e), t(kn), t(pd), zk, zk, t(muk_t), t(mup_t), zeros, 0.0, bounds, awr, order)
    got_t = cm_moments_pointwise(*common_t, *cm_quadrature("tabular", order), "tabular", "tabular", True, 8, 0,
                                 CM_GROUP_SPLIT, True)
    ref_t = cm_moments_pointwise(*common_t, 16, 8, "tabular", "tabular", True, 8, 0, "panels", True)
    g_t = _family_gate(got_t, ref_t)
    g_t["ok"] = bool(g_t["ok"] and g_t["max_rel_significant"] <= 1e-8)
    gates.append(g_t)

    worst = _worst(gates)
    r0 = _worst(small_gates)
    return {
        **worst,
        "small_aa_max_abs": r0["max_abs"],
        "small_aa_ok": r0["ok"],
        "ok": worst["ok"] and r0["ok"],
        "rows": rows,
        "groups": ng,
        "awr": [1.5, 238.0, 55.4],
    }


def check_chi(device="cuda", rows: int = 16, k: int = 24, ng: int = PROD_NG) -> dict:
    """The tabular chi collapse kernel against an exact host integral of the
    same piecewise-linear pdf (an independent path), at the production group
    count."""
    from ndpp_tpu_torch.ops.chi import tabular_group_fractions

    dev = torch.device(device)
    rng = np.random.default_rng(11)
    kn = np.sort(rng.uniform(1e2, 2e6, size=(rows, k)), axis=1)
    pd = rng.uniform(0.2, 1.0, size=(rows, k))
    pd /= np.sum(0.5 * (pd[:, 1:] + pd[:, :-1]) * np.diff(kn, axis=1), axis=1)[:, None]
    bounds = np.exp(np.linspace(np.log(1e1), np.log(3e6), ng + 1))
    got = tabular_group_fractions(*(torch.as_tensor(x, device=dev) for x in (kn, pd, bounds)))

    # exact host integral of the piecewise-linear pdf over each group, with
    # the edge-clamp semantics of clamp=True
    ref = np.zeros((rows, ng))
    for r in range(rows):
        edges = np.unique(np.concatenate([kn[r], np.clip(bounds, kn[r, 0], kn[r, -1])]))
        lo, hi = edges[:-1], edges[1:]
        mid = 0.5 * (lo + hi)
        seg = 0.5 * (np.interp(lo, kn[r], pd[r]) + np.interp(hi, kn[r], pd[r])) * (hi - lo)
        g = np.clip(np.searchsorted(bounds, mid, side="right") - 1, 0, ng - 1)
        np.add.at(ref[r], g, seg)
    return {**_family_gate(got, ref), "rows": rows}


def check_twobody(dev: torch.device, tile: int, order: int, ng: int, nq: int) -> dict:
    """The CUDA kernel against its plain version on the same card, on the
    same panels of production_inputs (twobody_panels runs once)."""
    from ndpp_tpu_torch.ops.twobody import twobody_panels
    from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments, twobody_group_moments_ref

    e0, (knots, pdf, bounds, c1, c2, awr) = production_inputs(tile, ng=ng, device=dev)
    mid, half, a_s, b_s, base, slope, ecm, e_safe, ap1, valid_e = twobody_panels(
        e0, knots, pdf, bounds, c1, c2, awr, True
    )
    kin = torch.stack([base, slope, torch.sqrt(ecm), torch.sqrt(e_safe) / ap1], dim=1)
    args = (mid, half, a_s, b_s, kin, valid_e, bounds, order, nq, True)
    before = twobody_group_moments.launches
    got = twobody_group_moments(*args)
    launches = twobody_group_moments.launches - before
    ref = twobody_group_moments_ref(*args)
    max_abs, max_rel = _errpair(got, ref)
    return {
        "twobody_max_abs": max_abs,
        "twobody_max_rel": max_rel,
        "twobody_route": "cuda",
        "twobody_kernel_launches": launches,
        "twobody_subintervals": int(mid.shape[1]),
        "twobody_ok": bool(max_rel <= TWOBODY_GATE and launches >= 1 and np.isfinite(max_abs)),
    }


FAMILIES = {"freegas": check_freegas, "continuum": check_continuum, "chi": check_chi}


def run(tile: int = PROD_TILE, order: int = PROD_ORDER, nq: int = PROD_NQ, device="cuda") -> dict:
    """Each leg's errors on `device` at PROD_NG groups; ``ok`` is the AND of
    every gate that ran (two-body kernel at <= 1e-8 relative, free-gas,
    continuum and chi under _family_gate) and ``failed`` names the legs that
    did not pass. A CUDA device without a card raises ConfigError
    (driver.resolve_device). On the CPU the two-body leg is reported as
    skipped, with its reason, and the families run."""
    from ndpp_tpu_torch.driver import resolve_device
    from ndpp_tpu_torch.ops.continuum import cm_inner_moments
    from ndpp_tpu_torch.ops.freegas import sab_density

    dev = resolve_device(device)
    before = sab_density.launches, cm_inner_moments.launches
    out: dict = {"shape": {"tile": tile, "order": order, "groups": PROD_NG, "nq": nq}, "device": str(dev)}
    failed = []
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        t0 = time.perf_counter()
        out.update(check_twobody(dev, tile, order, PROD_NG, nq))
        torch.cuda.synchronize(dev)
        out["twobody_seconds"] = time.perf_counter() - t0
        if not out["twobody_ok"]:
            failed.append("twobody")
    else:
        out["twobody"] = {"skipped": "the kernel runs only on a CUDA device"}
    for name, fn in FAMILIES.items():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        try:
            r = fn(dev)
        except Exception as e:  # report the family as failed; the others still run
            r = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            r["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
        r["seconds"] = time.perf_counter() - t0
        out[name] = r
        if not r["ok"]:
            failed.append(name)
    # the hand-written free-gas and continuum kernels' launches (0 on the CPU)
    out["sab_density_launches"] = sab_density.launches - before[0]
    out["cm_inner_launches"] = cm_inner_moments.launches - before[1]
    out["failed"] = failed
    out["ok"] = not failed
    return out
