"""Continuum-law moment kernels vs adaptive oracles (config 4; SURVEY.md section 4)."""

import numpy as np
import pytest

from ndpp_tpu import config as config_mod
from ndpp_tpu import groups
from ndpp_tpu.continuum_driver import continuum_reaction_moments
from ndpp_tpu.host.ace import synth
from ndpp_tpu.host.prep_continuum import prepare_continuum
from ndpp_tpu.oracle.continuum import cm_moments_oracle, lab_tabular_moments_oracle

# Coarse structure keeps the nested-quad oracle affordable; kernel accuracy
# is group-structure independent (same code path).
G12 = groups.uniform_lethargy("ul-12", 12, 1.0, 2.0e7)
CFG = config_mod.RunConfig(legendre_order=3, groups="uniform-lethargy-47")
CFG.device.quad_points = 16


def _driver_moments(nuc, rxn, e_sel, gs, order):
    return continuum_reaction_moments(nuc, rxn, e_sel, gs, order, CFG)


@pytest.mark.slow
def test_kalbach_cm_vs_oracle():
    nuc = synth.build("kalbach")
    rxn = nuc.reactions[91]
    e_sel = np.array([5e6, 1.5e7])
    dev = _driver_moments(nuc, rxn, e_sel, G12, order=3)
    ed = rxn.energy_dists[0]
    prep = prepare_continuum(nuc, rxn, ed, e_sel, 3)
    assert prep.kind == "cm-kalbach"
    for i in range(e_sel.size):
        ora = cm_moments_oracle(prep, i, float(e_sel[i]), nuc.awr, G12.bounds, 3)
        scale = np.abs(ora).max()
        np.testing.assert_allclose(dev[i], ora, rtol=3e-8, atol=3e-8 * scale, err_msg=f"E={e_sel[i]}")


def test_law61_lab_vs_oracle():
    nuc = synth.build("law61")
    rxn = nuc.reactions[22]
    e_sel = np.array([6e6, 1.8e7])
    dev = _driver_moments(nuc, rxn, e_sel, G12, order=3)
    prep = prepare_continuum(nuc, rxn, rxn.energy_dists[0], e_sel, 3)
    assert prep.kind == "lab-tabular"
    for i in range(e_sel.size):
        ora = lab_tabular_moments_oracle(prep, i, G12.bounds, 3)
        scale = np.abs(ora).max()
        np.testing.assert_allclose(dev[i], ora, rtol=1e-8, atol=1e-8 * scale, err_msg=f"E={e_sel[i]}")


def test_nbody_cm_vs_oracle():
    nuc = synth.build("nbody")
    rxn = nuc.reactions[16]
    e_sel = np.array([8e6, 1.6e7])
    dev = _driver_moments(nuc, rxn, e_sel, G12, order=2)
    prep = prepare_continuum(nuc, rxn, rxn.energy_dists[0], e_sel, 2)
    assert prep.kind == "cm-nbody"
    for i in range(e_sel.size):
        ora = cm_moments_oracle(prep, i, float(e_sel[i]), nuc.awr, G12.bounds, 2)
        scale = np.abs(ora).max()
        np.testing.assert_allclose(dev[i], ora, rtol=3e-8, atol=3e-8 * scale, err_msg=f"E={e_sel[i]}")


def test_normalization_properties():
    """f0 rows sum to 1 above threshold for normalized pdfs (clamped bins)."""
    for fixture, mt in [("kalbach", 91), ("law61", 22), ("nbody", 16)]:
        nuc = synth.build(fixture)
        rxn = nuc.reactions[mt]
        thresh = nuc.energy[rxn.threshold_idx]
        e_sel = np.exp(np.linspace(np.log(thresh * 1.2), np.log(1.9e7), 10))
        dev = _driver_moments(nuc, rxn, e_sel, G12, order=2)
        np.testing.assert_allclose(dev[:, 0, :].sum(axis=1), 1.0, rtol=1e-8, err_msg=fixture)
        assert np.all(np.abs(dev[:, 1:, :].sum(axis=2)) <= dev[:, 0, :].sum(axis=1)[:, None] + 1e-10)


@pytest.mark.slow
def test_law61_cm_vs_oracle():
    """CM-frame law 61 exercises the cm-tabular pointwise kernel (bilinear
    (E', mu) payload + closed-form mu-knot crossing roots)."""
    nuc = synth.build("law61cm")
    rxn = nuc.reactions[22]
    e_sel = np.array([6e6, 1.8e7])
    dev = _driver_moments(nuc, rxn, e_sel, G12, order=3)
    prep = prepare_continuum(nuc, rxn, rxn.energy_dists[0], e_sel, 3)
    assert prep.kind == "cm-tabular"
    for i in range(e_sel.size):
        ora = cm_moments_oracle(prep, i, float(e_sel[i]), nuc.awr, G12.bounds, 3)
        scale = np.abs(ora).max()
        np.testing.assert_allclose(dev[i], ora, rtol=3e-8, atol=3e-8 * scale, err_msg=f"E={e_sel[i]}")


def test_law67_lab_vs_oracle():
    """Law 67 (lab angle-energy) reduces to the lab-tabular path: marginal
    E' pdf + per-knot conditional angular moments; checked against the
    adaptive oracle, with genuine anisotropy in the payload."""
    nuc = synth.build("law67")
    rxn = nuc.reactions[28]
    e_sel = np.array([5e6, 1.8e7])
    dev = _driver_moments(nuc, rxn, e_sel, G12, order=3)
    prep = prepare_continuum(nuc, rxn, rxn.energy_dists[0], e_sel, 3)
    assert prep.kind == "lab-tabular"
    for i in range(e_sel.size):
        ora = lab_tabular_moments_oracle(prep, i, G12.bounds, 3)
        scale = np.abs(ora).max()
        np.testing.assert_allclose(dev[i], ora, rtol=1e-8, atol=1e-8 * scale, err_msg=f"E={e_sel[i]}")
    np.testing.assert_allclose(dev[:, 0, :].sum(axis=1), 1.0, rtol=1e-8)
    assert np.abs(dev[:, 1, :]).max() > 1e-3  # anisotropy actually exercised


def test_law4_discrete_lines_vs_oracle():
    """ND=2 discrete lines + continuous tail (lab law 4, separable AND
    anisotropy): the device result must equal continuous-oracle + exact
    line placement, and the l=0 row must still sum to 1."""
    nuc = synth.build("law4nd")
    rxn = nuc.reactions[91]
    e_sel = np.array([4e6, 1.5e7])
    dev = _driver_moments(nuc, rxn, e_sel, G12, order=3)
    prep = prepare_continuum(nuc, rxn, rxn.energy_dists[0], e_sel, 3)
    assert prep.kind == "lab-tabular" and "disc" in prep.extra
    e_d, p_d, am_d = prep.extra["disc"]
    for i in range(e_sel.size):
        ora = lab_tabular_moments_oracle(prep, i, G12.bounds, 3)
        for j in range(e_d.shape[1]):
            g = int(np.clip(np.searchsorted(G12.bounds, e_d[i, j], side="right") - 1, 0, G12.ng - 1))
            ora[:, g] += p_d[i, j] * am_d[i, j]
        scale = np.abs(ora).max()
        np.testing.assert_allclose(dev[i], ora, rtol=1e-8, atol=1e-8 * scale, err_msg=f"E={e_sel[i]}")
    np.testing.assert_allclose(dev[:, 0, :].sum(axis=1), 1.0, rtol=1e-8)
    # the lines carry real probability: discrete mass present at both energies
    assert p_d.min() > 0.05


def test_fine_structure_aggregates_to_coarse():
    """The pointwise-E'_lab path is group-structure independent: fine-G
    moments aggregated over nested groups (96 -> 12) must match the coarse
    run to the full 1e-8 bar (round-1 gap 2 closed)."""
    G96 = groups.uniform_lethargy("ul-96", 96, 1.0, 2.0e7)
    nuc = synth.build("kalbach")
    rxn = nuc.reactions[91]
    e_sel = np.array([5e6, 1.5e7])
    fine = _driver_moments(nuc, rxn, e_sel, G96, order=2)
    coarse = _driver_moments(nuc, rxn, e_sel, G12, order=2)
    agg = fine.reshape(fine.shape[0], fine.shape[1], 12, 8).sum(axis=-1)
    scale = np.abs(coarse).max()
    np.testing.assert_allclose(agg, coarse, rtol=1e-8, atol=1e-9 * scale)


def test_below_threshold_rows_are_zero_not_nan():
    """Sub-threshold incident rows through the CM engine must be exact zeros
    (regression: emax<=0 nbody normalization underflowed to inf -> NaN,
    poisoning the library and faulting the TPU worker)."""
    nuc = synth.build("nbody")
    rxn = nuc.reactions[16]
    mom = _driver_moments(nuc, rxn, np.array([1e3, 1e6, 5e6]), G12, order=2)
    assert not np.isnan(mom).any()
    assert np.all(mom[:2] == 0.0)
    assert abs(mom[2, 0].sum() - 1.0) < 1e-8


def test_law1_and_law5_conversions():
    """Laws 1 (equiprobable bins) and 5 (general evaporation) convert to the
    tabular path; normalization and yield weighting verified."""
    from ndpp_tpu.driver import reaction_yield

    for fixture, mt in [("law1", 16), ("law5", 37)]:
        nuc = synth.build(fixture)
        rxn = nuc.reactions[mt]
        thresh = nuc.energy[rxn.threshold_idx]
        e_sel = np.array([thresh * 1.5, 1.5e7])
        mom = _driver_moments(nuc, rxn, e_sel, G12, order=2)
        np.testing.assert_allclose(mom[:, 0, :].sum(axis=1), 1.0, rtol=1e-8, err_msg=fixture)
        assert np.all(mom[:, 1:, :] == 0.0)  # isotropic lab: no higher moments
    # energy-dependent yield: |TYR|>100 table honored by the driver weighting
    nuc = synth.build("law1")
    y = reaction_yield(nuc.reactions[16], np.array([2.2e6, 2e7]), include_yield=True)
    np.testing.assert_allclose(y, [1.2, 2.0], rtol=1e-12)


def test_law67_histogram_slices_exact():
    """INTEP=1 (histogram) law-67 slices must integrate exactly as
    piecewise constants (doubled-knot representation), not be smeared
    lin-lin (code-review fix). Constant-in-E' panels with mu-linear joint
    have closed-form group fractions."""
    from ndpp_tpu.host.ace.records import AngleEnergySlice, AngleEnergyTable, LawData
    from ndpp_tpu.host.prep_continuum import _law67_as_law61

    mu = np.array([-1.0, 1.0])
    eo = np.array([0.0, 1.0, 3.0])  # two panels
    # joint histogram: panel densities per (mu slice): values at the 2 mus
    # f(mu, E') = a_p + b_p * mu on panel p, constant in E'
    a = np.array([0.30, 0.10])  # panel averages over mu: integral 2*a_p*width
    b = np.array([0.05, -0.025])
    slices = []
    for m in mu:
        pdf = np.array([a[0] + b[0] * m, a[1] + b[1] * m, 0.0])
        cdf = np.array([0.0, pdf[0] * 1.0, pdf[0] * 1.0 + pdf[1] * 2.0])
        slices.append(AngleEnergySlice(intep=1, e_out=eo, pdf=pdf, cdf=cdf))
    # total mass: sum_p width_p * 2*a_p = 1*0.6 + 2*0.4 = 1.0 (normalized)
    data = LawData(
        law=67,
        energies=np.array([1.0, 2.0]),
        ae_tables=[AngleEnergyTable(intmu=2, mu=mu, slices=slices)] * 2,
    )
    red = _law67_as_law61(data)
    t = red.tables[0]
    # marginal must be an exact step function: 0.6 on [0,1), 0.4/... checks
    # via integrals against group-like cuts
    def marg_integral(lo, hi):
        xs = np.linspace(lo, hi, 20001)
        return np.trapezoid(np.interp(xs, t.e_out, t.pdf), xs)

    np.testing.assert_allclose(marg_integral(0.0, 1.0), 0.6, rtol=1e-3)
    np.testing.assert_allclose(marg_integral(1.0, 3.0), 0.4, rtol=1e-3)
    np.testing.assert_allclose(marg_integral(0.5, 1.5), 0.3 + 0.1, rtol=1e-3)
    # per-knot conditional P1 moment: integral of mu * f / marg = (2/3) b_p / (2 a_p)
    from ndpp_tpu.host.prep_continuum import _angular_table_moments

    for k in range(t.e_out.size):
        x = t.e_out[k]
        # doubled grid [0, 1, 1, 3]: odd indices are panel ENDS (carry the
        # left panel's value), even indices are panel starts
        p = 0 if (x < 1.0 or (x == 1.0 and k % 2 == 1)) else 1
        if t.angular[k] is None:
            continue
        m1 = _angular_table_moments(t.angular[k], 1)[1]
        np.testing.assert_allclose(m1, (b[p] / 3.0) / a[p], rtol=1e-9, err_msg=f"k={k} x={x}")


def test_lagrange_group_split_matches_panels():
    """group_split="lagrange" (the production mode since round 2: group
    boundaries removed from the outer panel edges, splits via the shared
    Lagrange cumulant machinery in ops/panelsplit — outer cost independent
    of G, measured 2.8x on the v5e at 361 groups) must agree with the
    boundary-edged "panels" scheme on every law family."""
    import jax.numpy as jnp

    from ndpp_tpu import groups as groups_mod
    from ndpp_tpu.ops.continuum import cm_moments_pointwise

    order, rows, k = 5, 8, 32
    awr = 89.132
    e = np.geomspace(4e6, 2e7, rows)
    emax_r = (e - 2e6) * awr / (awr + 1.0)
    kn = np.linspace(1e3, emax_r, k, axis=-1)
    pd = kn * np.exp(-kn / (emax_r[:, None] / 4.0))
    pd /= np.trapezoid(pd, kn, axis=1)[:, None]
    rr = np.full((rows, k), 0.3)
    aa = 0.2 + 1.5 * kn / np.maximum(emax_r[:, None], 1.0)
    kmu = 9
    muk = np.linspace(-1.0, 1.0, kmu)
    mup = np.abs(0.5 + 0.2 * np.sin(np.arange(rows * k * kmu).reshape(rows, k, kmu) * 0.7))
    bounds = jnp.asarray(groups_mod.get("uniform-lethargy-47").bounds)
    for ang, energy in (("kalbach", "tabular"), ("tabular", "tabular"), ("isotropic", "nbody")):
        nqw = 16 if ang == "tabular" else 8
        emax_nb = emax_r if energy == "nbody" else np.zeros(rows)
        outs = {}
        for mode in ("panels", "lagrange"):
            outs[mode] = np.asarray(
                cm_moments_pointwise(
                    jnp.asarray(e), jnp.asarray(kn), jnp.asarray(pd), jnp.asarray(rr),
                    jnp.asarray(aa), jnp.asarray(muk), jnp.asarray(mup),
                    jnp.asarray(emax_nb), 1.5, bounds, awr, order, nqw, 8,
                    ang, energy, True, 8, 0, mode,
                )
            )
        scale = max(np.abs(outs["panels"]).max(), 1e-30)
        np.testing.assert_allclose(
            outs["lagrange"], outs["panels"], atol=3e-8 * scale, rtol=0,
            err_msg=f"{ang}/{energy}",
        )


def test_kalbach_small_a_isotropic_limit():
    """At the a=0 clamp a law-44 row is isotropic to O(a): the Kalbach
    angular factor must match the isotropic path at the same quadrature to
    ~f64 roundoff. Guards the two-exp denominator against the e^a - e^-a
    cancellation (~5e-5 relative at the 1e-12 clamp) that the round-4
    advisor flagged — every near-isotropic law-44 knot hits that clamp."""
    import jax.numpy as jnp

    from ndpp_tpu.ops.continuum import cm_moments_pointwise

    rows, k = 8, 24
    awr = 55.4
    rng = np.random.default_rng(5)
    e = np.geomspace(3e6, 1.8e7, rows)
    emax_r = (e - 2e6) * awr / (awr + 1.0)
    kn = np.linspace(1e3, emax_r, k, axis=-1)
    pd = kn * np.exp(-kn / (emax_r[:, None] / 4.0))
    pd /= np.trapezoid(pd, kn, axis=1)[:, None]
    rr = rng.uniform(0.0, 0.9, size=(rows, k))  # r is irrelevant as a -> 0
    aa = np.zeros((rows, k))  # clamped to 1e-12 in-kernel
    bounds = G12.bounds
    muk = jnp.asarray(np.array([-1.0, 1.0]))
    mup = jnp.zeros((rows, k, 2))
    common = (
        jnp.asarray(e), jnp.asarray(kn), jnp.asarray(pd), jnp.asarray(rr),
        jnp.asarray(aa), muk, mup, jnp.zeros(rows), 0.0, jnp.asarray(bounds),
        awr, 3,
    )
    got = cm_moments_pointwise(*common, 8, 8, "kalbach", "tabular", True, 8, 0, "lagrange")
    ref = cm_moments_pointwise(*common, 8, 8, "isotropic", "tabular", True, 8, 0, "lagrange")
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-9, atol=1e-11)


def test_batched_pooling_matches_per_reaction():
    """Cross-reaction dispatch pooling (round 4): cm-kalbach and
    lab-tabular laws pooled into one row pool must reproduce the
    per-reaction dispatch results (same kernels, rows are independent;
    only the ksel window quantization may differ, which is exact either
    way)."""
    from ndpp_tpu.continuum_driver import (
        batched_continuum_moments,
        continuum_reaction_moments,
    )

    # cm-kalbach: the same reaction on two different row sets stands in
    # for two reactions sharing a knot bucket
    nuc = synth.build("kalbach")
    rxn = nuc.reactions[91]
    e1 = np.array([5e6, 1.1e7, 1.9e7])
    e2 = np.array([6e6, 1.5e7])
    pooled = batched_continuum_moments(nuc, [(rxn, e1), (rxn, e2)], G12, 3, CFG)
    sep = [
        continuum_reaction_moments(nuc, rxn, e1, G12, 3, CFG),
        continuum_reaction_moments(nuc, rxn, e2, G12, 3, CFG),
    ]
    for got, ref in zip(pooled, sep):
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-8 * scale)

    # lab-tabular with ND discrete lines: per-item line application on the
    # pooled slices
    nuc = synth.build("law4nd")
    rxn = next(iter(r for r in nuc.reactions.values() if r.energy_dists and r.energy_dists[0].law in (4, 44, 61)))
    thresh = nuc.energy[rxn.threshold_idx]
    e1 = np.exp(np.linspace(np.log(thresh * 1.3), np.log(1.8e7), 4))
    e2 = np.exp(np.linspace(np.log(thresh * 1.6), np.log(1.2e7), 3))
    pooled = batched_continuum_moments(nuc, [(rxn, e1), (rxn, e2)], G12, 3, CFG)
    sep = [
        continuum_reaction_moments(nuc, rxn, e1, G12, 3, CFG),
        continuum_reaction_moments(nuc, rxn, e2, G12, 3, CFG),
    ]
    for got, ref in zip(pooled, sep):
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-10 * scale)


def test_window_knot_bound_matches_broadcast_formula():
    # the O(NE*KE log KE) searchsorted pass (round 5) must reproduce the
    # original broadcast definition: need = max over (row, j) of the count
    # of knots in [yk_j, yk_j + 2 s_row], + 2 bracketing panels
    from ndpp_tpu.continuum_driver import _window_knot_bound

    rng = np.random.default_rng(7)
    for awr, ke, scale in [(238.0, 64, 2e7), (55.0, 32, 1e6), (0.999, 16, 1e5)]:
        ne = 37
        e_rows = rng.uniform(1e2, scale, ne)
        e_knots = np.sort(rng.uniform(0.0, scale, (ne, ke)), axis=1)
        # reference: the pre-round-5 broadcast formula
        yk = np.sqrt(np.maximum(e_knots, 0.0))
        s = np.sqrt(np.maximum(e_rows, 0.0)) / (awr + 1.0)
        tgt = yk + 2.0 * s[:, None]
        hi = np.sum(yk[:, None, :] <= tgt[:, :, None], axis=2)
        need = max(2, int((hi - np.arange(ke)[None, :]).max()) + 2)
        if need >= ke - 1:
            expect = 0
        else:
            k = 4
            while k < need:
                k *= 2
            expect = min(k, ke)
        assert _window_knot_bound(e_rows, awr, e_knots) == expect
