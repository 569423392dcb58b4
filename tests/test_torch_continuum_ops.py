"""Continuum and chi device ops of the port against their JAX counterparts.

The same seeded numpy inputs (or a fixture's prepared arrays, through
ndpp_tpu_torch.interop) go through the jitted reference function on the CPU
and the port's torch function on the CPU. Shapes are small (3 rows, 16 knots,
12-24 groups, P3) so each reference compile stays short.

Tolerance, every comparison against the reference: |got - ref| <= 1e-10 |ref|
+ 1e-13 * (the row's largest |moment|). Both sides are float64 with the same
formulas; they differ by the ulp of exp/expm1/pow between XLA:CPU and torch
and by summation order (measured ~1e-15 of the row's scale). The absolute
term is there because group values of the lagrange split are differences of
O(1) cumulants, so an element at roundoff level has no relative accuracy in
either package. Port-against-port comparisons (chunk, ksel rung, banded vs
dense) state their own bound.
"""

import numpy as np
import pytest
import torch

from ndpp_tpu.host.ace import synth as j_synth
from ndpp_tpu.host.prep_continuum import prepare_continuum as j_prepare
from ndpp_tpu.ops import chi as j_chi
from ndpp_tpu.ops import continuum as j_cont
from ndpp_tpu.ops import panelsplit as j_split
from ndpp_tpu.ops.legendre import gl_nodes_weights
from ndpp_tpu_torch import banding
from ndpp_tpu_torch.continuum_driver import _window_knot_bound, quantize_ksel
from ndpp_tpu_torch.interop import chi_inputs, continuum_inputs
from ndpp_tpu_torch.ops import chi as t_chi
from ndpp_tpu_torch.ops import continuum as t_cont
from ndpp_tpu_torch.ops import panelsplit as t_split

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

ORDER = 3
AWR = 200.0  # heavy: narrow y-windows, so the windowed-knot path is valid


def _assert_close(got, ref, rtol=1e-10, atol_scale=1e-13):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (ref.ndim - 1))
    bad = np.abs(got - ref) > rtol * np.abs(ref) + atol_scale * scale
    assert not bad.any(), f"{int(bad.sum())} elements differ, worst {np.abs(got - ref).max():.3e}"


def _t(x):
    return None if x is None else torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64)


def _bounds(ng):
    return np.geomspace(1e3, 2e7, ng + 1)


def _windows(bounds, lo, hi, b_w, cover=True):
    """Per-row (T, B+1) windows of b_w groups from the group below `lo`;
    with `cover` they must reach past `hi` (banded == dense needs that, a
    comparison of the two packages on the same windows does not)."""
    ng = bounds.size - 1
    g_lo = np.clip(np.searchsorted(bounds, lo, side="right") - 2, 0, ng - 1)
    g_hi = np.clip(np.searchsorted(bounds, hi, side="left") + 1, 1, ng)
    assert not cover or int((g_hi - g_lo).max()) <= b_w, "window too narrow for the test's support"
    g0 = np.clip(g_lo, 0, ng - b_w)
    return banding.window_bounds(bounds, g0, b_w), g0


def _cm_inputs(seed, t=3, k_real=13, ke=16, kmu=5, awr=AWR, f_lo=0.3):
    """Seeded CM-law rows: E'_cm knots in [f_lo, 0.9] of the incident energy
    (jittered by 15% of their spacing, so a y-window of the heavy target
    holds at most two of them), edge-padded from k_real to ke as the driver's
    knot bucket does."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(2e6, 1.5e7, size=t)
    jitter = 0.15 * (0.9 - f_lo) / (k_real - 1)
    frac = np.linspace(f_lo, 0.9, k_real)[None, :] + rng.uniform(-jitter, jitter, size=(t, k_real))
    kn = np.sort(frac, axis=1) * e[:, None]
    pdf = rng.uniform(0.2, 1.0, size=(t, k_real))
    pdf[:, 0] = pdf[:, -1] = 0.0
    pdf /= np.sum(0.5 * (pdf[:, 1:] + pdf[:, :-1]) * np.diff(kn, axis=1), axis=1, keepdims=True)
    rr = rng.uniform(0.0, 1.0, size=(t, k_real))
    aa = rng.uniform(0.0, 3.0, size=(t, k_real))
    aa[:, 0] = 1e-12  # the isotropic limit the expm1 form is for
    mu_knots = np.concatenate([[-1.0], np.sort(rng.uniform(-0.9, 0.9, size=kmu - 2)), [1.0]])
    mup = rng.uniform(0.2, 1.0, size=(t, k_real, kmu))
    mup /= np.sum(0.5 * (mup[..., 1:] + mup[..., :-1]) * np.diff(mu_knots), axis=-1, keepdims=True)
    pad = lambda a: np.pad(a, [(0, 0), (0, ke - k_real)] + [(0, 0)] * (a.ndim - 2), mode="edge")  # noqa: E731
    return dict(e=e, kn=pad(kn), pd=pad(pdf), rr=pad(rr), aa=pad(aa), muk=mu_knots, mup=pad(mup), emax=0.8 * e,
                awr=awr, bound=_window_knot_bound(e, awr, kn))


def _cm_both(d, bounds, angular, energy, clamp, ksel, split, cross, nq_w=6, nq_y=5, chunk=8, expo=0.5):
    """(port, reference) results of cm_moments_pointwise on the inputs d."""
    ref = j_cont.cm_moments_pointwise(
        d["e"], d["kn"], d["pd"], d["rr"], d["aa"], d["muk"], d["mup"], d["emax"], expo, bounds, d["awr"],
        ORDER, nq_w, nq_y, angular, energy, clamp, 8, ksel, split, cross,
    )
    got = _cm_port(d, bounds, angular, energy, clamp, ksel, split, cross, nq_w, nq_y, chunk, expo)
    return got.numpy(), np.asarray(ref)


def _cm_port(d, bounds, angular, energy, clamp, ksel, split, cross, nq_w=6, nq_y=5, chunk=8, expo=0.5):
    """The port's call, with the operands its options do not read left None."""
    nbody, kal, tab = energy == "nbody", angular == "kalbach", angular == "tabular"
    return t_cont.cm_moments_pointwise(
        _t(d["e"]), None if nbody else _t(d["kn"]), None if nbody else _t(d["pd"]),
        _t(d["rr"]) if kal else None, _t(d["aa"]) if kal else None,
        _t(d["muk"]) if tab else None, _t(d["mup"]) if tab else None, _t(d["emax"]) if nbody else None,
        expo, _t(bounds), d["awr"], ORDER, nq_w, nq_y, angular, energy, clamp, chunk, ksel, split, cross,
    )


# (id, angular, energy, split, cross_edges, ksel, per-row bounds, clamp)
CM_CASES = [
    ("kalbach-lagrange-windowed", "kalbach", "tabular", "lagrange", False, 4, False, True),
    ("kalbach-lagrange-fullknot-banded", "kalbach", "tabular", "lagrange", False, 0, True, True),
    ("kalbach-panels-windowed-noclamp", "kalbach", "tabular", "panels", False, 8, False, False),
    ("tabular-lagrange-cross-fullknot", "tabular", "tabular", "lagrange", True, 0, False, True),
    ("tabular-panels-windowed-banded", "tabular", "tabular", "panels", False, 8, True, True),
    ("tabular-lagrange-cross-noclamp", "tabular", "tabular", "lagrange", True, 4, False, False),
    ("isotropic-tabular-lagrange-windowed", "isotropic", "tabular", "lagrange", False, 4, False, True),
    ("nbody-lagrange", "isotropic", "nbody", "lagrange", False, 0, False, True),
    ("nbody-panels-banded-noclamp", "isotropic", "nbody", "panels", False, 0, True, False),
]


@pytest.mark.parametrize("case", CM_CASES, ids=[c[0] for c in CM_CASES])
def test_cm_moments_pointwise_matches_reference(case):
    _, angular, energy, split, cross, ksel, per_row, clamp = case
    d = _cm_inputs(seed=len(case[0]))
    assert 0 < d["bound"] <= 4, "the seeded rows must admit the smallest windowed rung"
    bounds = _bounds(24)
    if per_row:
        sup = np.stack([np.zeros_like(d["emax"]), d["emax"]], axis=1) if energy == "nbody" else d["kn"]
        bounds, _ = _windows(bounds, *banding.support_cm(d["e"], AWR, sup), 8, cover=energy != "nbody")
    got, ref = _cm_both(d, bounds, angular, energy, clamp, ksel, split, cross)
    assert got.shape == (3, ORDER + 1, bounds.shape[-1] - 1)
    _assert_close(got, ref)
    if clamp:  # a normalized spectrum under clamping: P0 sums to 1 to quadrature accuracy
        np.testing.assert_allclose(got[:, 0].sum(axis=1), 1.0, rtol=1e-5)  # at nq_w 6, nq_y 5


@pytest.mark.parametrize("angular,split,cross", [("kalbach", "lagrange", False), ("tabular", "panels", True)])
def test_cm_result_does_not_depend_on_chunk(angular, split, cross):
    """chunk only bounds the live tensors: 1, 3, 8 and all panels at once agree
    to 1e-15 of the row's scale (the sums over a node's own inner panels may
    be vectorized differently at another tensor shape, nothing more)."""
    d = _cm_inputs(seed=7)
    bounds = _bounds(12)
    base = _cm_port(d, bounds, angular, "tabular", True, 4, split, cross, chunk=8).numpy()
    for chunk in (1, 3, 10_000):
        other = _cm_port(d, bounds, angular, "tabular", True, 4, split, cross, chunk=chunk).numpy()
        _assert_close(other, base, rtol=0.0, atol_scale=1e-15)


@pytest.mark.parametrize("angular", ["kalbach", "tabular"])
def test_ksel_rungs_and_full_knot_path_agree(angular):
    """ksel in {k/16, k/8, k/4, 0} at k = 64: the windowed paths and the
    full-knot path split other inner panels, so they agree to quadrature
    roundoff, held here to 1e-12 of the row's scale."""
    d = _cm_inputs(seed=3, k_real=40, ke=64, awr=238.0, f_lo=0.1)
    k16 = 64
    assert 0 < d["bound"] <= k16 // 16 == quantize_ksel(d["bound"], k16)
    bounds = _bounds(24)
    full = _cm_port(d, bounds, angular, "tabular", True, 0, "lagrange", angular == "tabular", 10, 7).numpy()
    np.testing.assert_allclose(full[:, 0].sum(axis=1), 1.0, rtol=1e-8)  # the product bar, at nq_w 10, nq_y 7
    for ksel in (k16 // 16, k16 // 8, k16 // 4):
        win = _cm_port(d, bounds, angular, "tabular", True, ksel, "lagrange", angular == "tabular", 10, 7).numpy()
        _assert_close(win, full, rtol=0.0, atol_scale=1e-12)


@pytest.mark.parametrize("kind", ["cm-kalbach", "cm-tabular", "lab-tabular"])
def test_banded_equals_dense(kind):
    """Windows that cover each row's support, densified, give the dense
    result: to 1e-13 of the row's scale (other cumsum lengths, same mass)."""
    d = _cm_inputs(seed=5)
    bounds = _bounds(24)
    if kind == "lab-tabular":
        lo, hi = d["kn"][:, 0], d["kn"][:, -1]
        mom = np.random.default_rng(2).uniform(-1, 1, size=d["kn"].shape + (ORDER + 1,))
        call = lambda b: t_cont.lab_tabular_moments(_t(d["kn"]), _t(d["pd"]), _t(mom), _t(b), ORDER, 8, True)  # noqa: E731
        b_w = 8
    else:
        tab = kind == "cm-tabular"
        lo, hi = banding.support_cm(d["e"], AWR, d["kn"])
        call = lambda b: _cm_port(d, b, "tabular" if tab else "kalbach", "tabular", True, 0, "lagrange", tab)  # noqa: E731
        b_w = 8
    win, g0 = _windows(bounds, lo, hi, b_w)
    dense = call(bounds).numpy()
    banded = banding.densify(call(win).numpy(), g0, bounds.size - 1)
    _assert_close(banded, dense, rtol=0.0, atol_scale=1e-13)


def test_index_helpers_on_padded_and_duplicated_knots():
    """searchsorted(right) - 1, clipped, is the reference's first-match panel
    loop: on step (duplicated) knots, edge padding, queries below the first
    knot, on a knot and at or above the last."""
    knots = np.array([
        [1.0, 2.0, 2.0, 3.0, 5.0, 5.0, 5.0, 5.0],  # a step at 2, edge padding at 5
        [0.0, 0.0, 1.0, 4.0, 4.0, 6.0, 7.0, 7.0],  # a dead first panel
        [2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0],
    ])
    rng = np.random.default_rng(0)
    q = np.concatenate([knots, knots - 0.25, knots + 0.25, rng.uniform(-1, 10, size=(3, 9))], axis=1)
    ref = np.asarray(j_cont._panel_index_rows(knots, q))
    got = t_cont._panel_index_rows(_t(knots), _t(q)).numpy()
    np.testing.assert_array_equal(got, ref)
    shared = np.asarray(j_cont._panel_index_rows(np.broadcast_to(knots[2], knots.shape), q))
    np.testing.assert_array_equal(t_cont._panel_index_rows(_t(knots[2]), _t(q)).numpy(), shared)
    for b in (knots[2], knots):  # shared and per-row boundaries, ties included
        np.testing.assert_array_equal(
            t_cont._searchsorted_last(_t(b), _t(q)).numpy(), np.asarray(j_cont._searchsorted_last(b, q)))


@pytest.mark.parametrize("per_row,clamp", [(False, True), (True, True), (False, False)])
def test_lab_tabular_moments_matches_reference(per_row, clamp):
    d = _cm_inputs(seed=9)
    kn, pd = d["kn"].copy(), d["pd"].copy()
    kn[:, 5] = kn[:, 4]  # a histogram step
    mom = np.random.default_rng(4).uniform(-1, 1, size=kn.shape + (ORDER + 1,))
    bounds = _bounds(24)
    if clamp is False:
        bounds = bounds[8:18]  # part of the support outside the table: dropped
    if per_row:
        bounds, _ = _windows(bounds, kn[:, 0], kn[:, -1], 8)
    ref = j_cont.lab_tabular_moments(kn, pd, mom, bounds, ORDER, 8, clamp)
    got = t_cont.lab_tabular_moments(_t(kn), _t(pd), _t(mom), _t(bounds), ORDER, 8, clamp)
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("clamp", [True, False])
def test_discrete_lines_moments_matches_reference(clamp):
    rng = np.random.default_rng(6)
    bounds = _bounds(12)
    e_out = np.exp(rng.uniform(np.log(1e2), np.log(1e8), size=(4, 5)))  # some outside the table
    e_out[0, 1] = e_out[0, 0]  # two lines in one group
    e_out[1, 2] = bounds[3]  # a line exactly on a boundary
    w = rng.uniform(0.0, 0.3, size=(4, 5))
    am = rng.uniform(-1, 1, size=(4, 5, ORDER + 1))
    ref = j_cont.discrete_lines_moments(e_out, w, am, bounds, clamp)
    got = t_cont.discrete_lines_moments(_t(e_out), _t(w), _t(am), _t(bounds), clamp)
    _assert_close(got.numpy(), ref)


def test_lagrange_cumulants_matches_reference():
    rng = np.random.default_rng(8)
    t, npan, pad_p, nq, l1 = 3, 10, 12, 6, ORDER + 1
    edges = np.sort(rng.uniform(0.0, 10.0, size=(t, npan + 1)), axis=1)
    edges[:, 4] = edges[:, 3]  # a dead panel
    pmid = np.pad(0.5 * (edges[:, 1:] + edges[:, :-1]), ((0, 0), (0, pad_p - npan)))
    phalf = np.pad(0.5 * (edges[:, 1:] - edges[:, :-1]), ((0, 0), (0, pad_p - npan)))
    gvals = rng.uniform(-1, 1, size=(t, pad_p, nq, l1))
    wg = gl_nodes_weights(nq)[1]
    for b in (np.sort(rng.uniform(-1.0, 11.0, size=9)), np.sort(rng.uniform(-1.0, 11.0, size=(t, 9)), axis=1)):
        ref = j_split.lagrange_cumulants(edges, pmid, phalf, gvals, wg, b, npan, nq)
        got = t_split.lagrange_cumulants(_t(edges), _t(pmid), _t(phalf), _t(gvals), _t(wg), _t(b), npan, nq)
        _assert_close(got.numpy(), ref)
    # the port evaluates the reference's antiderivatives A_q(t) in the Legendre basis
    tq = np.linspace(-1.0, 1.0, 9)
    pl = t_split.legendre_all_np(tq, nq)
    d = np.concatenate([(tq + 1.0)[:, None], pl[:, 2:] - pl[:, :-2]], axis=1)
    np.testing.assert_allclose(
        d @ t_split.lagrange_antiderivative_basis(nq).T,
        np.polynomial.polynomial.polyvander(tq, nq) @ j_split.lagrange_antiderivative_coeffs(nq).T,
        rtol=0, atol=1e-15,
    )


@pytest.mark.parametrize("per_row,clamp", [(False, True), (True, True), (False, False)])
def test_tabular_group_fractions_matches_reference(per_row, clamp):
    d = _cm_inputs(seed=10)
    kn, pd = d["kn"].copy(), d["pd"].copy()
    kn[:, 7] = kn[:, 6]  # a histogram step
    pd /= np.sum(0.5 * (pd[:, 1:] + pd[:, :-1]) * np.diff(kn, axis=1), axis=1, keepdims=True)
    bounds = _bounds(24)
    if clamp is False:
        bounds = bounds[8:18]
    if per_row:
        bounds, _ = _windows(bounds, kn[:, 0], kn[:, -1], 8)
    ref = j_chi.tabular_group_fractions(kn, pd, bounds, clamp)
    got = t_chi.tabular_group_fractions(_t(kn), _t(pd), _t(bounds), clamp)
    _assert_close(got.numpy(), ref)
    if clamp:
        np.testing.assert_allclose(got.numpy().sum(axis=1), 1.0, rtol=1e-12)


@pytest.mark.parametrize("law", [7, 9, 11])
def test_analytic_group_fractions_matches_reference(law):
    rng = np.random.default_rng(law)
    e = np.array([1e4, 2e5, 1e6, 5e6, 1.9e7])
    theta = rng.uniform(0.8e6, 1.5e6, size=e.size)
    b = rng.uniform(1e-6, 3e-6, size=e.size)
    u = 1.5e5  # the first row lies below U: all zeros
    bounds = _bounds(24)
    for clamp in (True, False):
        ref = j_chi.analytic_group_fractions(e, theta, b, u, bounds, law, clamp)
        got = t_chi.analytic_group_fractions(_t(e), _t(theta), _t(b), u, _t(bounds), law, clamp).numpy()
        _assert_close(got, ref)
        assert not got[0].any()
    np.testing.assert_allclose(got[1:].sum(axis=1) <= 1.0 + 1e-12, True)


# (fixture, MT, what the op is called with)
PREP_CASES = [("kalbach", 91), ("law61cm", 22), ("nbody", 16), ("law61", 22), ("maxwell", 18), ("u235", 18)]


@pytest.mark.parametrize("key,mt", PREP_CASES, ids=[c[0] for c in PREP_CASES])
def test_ops_on_fixture_preps_match_reference(key, mt):
    """One prepared law of each kind (cm-kalbach, cm-tabular, cm-nbody,
    lab-tabular, lab-analytic, chi tabular), three rows of the fixture's grid,
    handed to both packages through interop."""
    nuc = j_synth.build(key)
    rxn = nuc.reactions[mt]
    prep = j_prepare(nuc, rxn, rxn.energy_dists[0], nuc.energy[[-40, -15, -1]], 0 if mt == 18 else ORDER)
    bounds = _bounds(12)
    if mt == 18:
        args = chi_inputs(prep, bounds, device="cpu")
        if prep.kind == "lab-analytic":
            x = prep.extra
            ref = j_chi.analytic_group_fractions(prep.e, x["theta"], x["b"], x["u"], bounds, x["law"])
            got = t_chi.analytic_group_fractions(*args)
        else:
            ref = j_chi.tabular_group_fractions(prep.e_knots, prep.pdf, bounds)
            got = t_chi.tabular_group_fractions(*args)
        _assert_close(got.numpy(), ref)
        np.testing.assert_allclose(got.numpy().sum(axis=1), 1.0, rtol=1e-12)
        return
    x = continuum_inputs(prep, bounds, device="cpu")
    if prep.kind == "lab-tabular":
        ref = j_cont.lab_tabular_moments(prep.e_knots, prep.pdf, prep.mom_knots, bounds, ORDER, 8)
        got = t_cont.lab_tabular_moments(x["e_knots"], x["pdf"], x["mom_knots"], x["bounds"], ORDER, 8)
    else:
        angular = {"cm-kalbach": "kalbach", "cm-tabular": "tabular", "cm-nbody": "isotropic"}[prep.kind]
        energy = "nbody" if prep.kind == "cm-nbody" else "tabular"
        ne = prep.e.size
        zk = np.zeros((ne, 2)) if prep.e_knots is None else np.zeros_like(prep.e_knots)
        ref = j_cont.cm_moments_pointwise(
            prep.e, zk if prep.e_knots is None else prep.e_knots, zk if prep.pdf is None else prep.pdf,
            zk if prep.r_rows is None else prep.r_rows, zk if prep.a_rows is None else prep.a_rows,
            np.array([-1.0, 1.0]) if prep.mu_knots is None else prep.mu_knots,
            np.zeros(zk.shape + (2,)) if prep.mu_pdf is None else prep.mu_pdf,
            np.zeros(ne) if prep.nbody_emax is None else prep.nbody_emax,
            float(prep.nbody_expo or 0.0), bounds, nuc.awr, ORDER, 6, 5, angular, energy, True, 8, 0, "lagrange",
            angular == "tabular",
        )
        got = t_cont.cm_moments_pointwise(
            x["e"], x["e_knots"], x["pdf"], x["r_rows"], x["a_rows"], x["mu_knots"], x["mu_pdf"], x["nbody_emax"],
            float(prep.nbody_expo or 0.0), x["bounds"], nuc.awr, ORDER, 6, 5, angular, energy, True, 8, 0,
            "lagrange", angular == "tabular",
        )
    _assert_close(got.numpy(), ref)
