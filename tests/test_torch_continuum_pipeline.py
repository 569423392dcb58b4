"""The continuum and chi slice as a whole: drivers and a deck through both packages.

Per fixture, ``batched_continuum_moments`` / ``chi_collapse`` of the port (CPU)
against the reference's (f64 XLA on the CPU) on four rows of the fixture's own
grid, 47 groups, P3; then one deck over a continuum and a fissile nuclide
through both ``driver.run``s, libraries compared by the reference's comparator.

Tolerances. Driver level: |got - ref| <= 1e-10 |ref| + 1e-13 * (the row's
largest |moment|) (measured ~3e-15 of the row's scale: the ulp of exp/expm1
between XLA:CPU and torch, and summation order). Library level: rtol 1e-8
(the product bar, BASELINE.json:5) with atol 1e-14 on per-unit-scatter
moments and chi fractions: group values of the lagrange split are differences
of O(1) cumulants, so elements near 1e-15 differ in relative terms between
any two implementations (measured max abs 5.6e-16 over all sixteen fixtures).
"""

import types

import numpy as np
import pytest
import torch

from ndpp_tpu import chi_driver as j_chi_driver
from ndpp_tpu import config as j_config
from ndpp_tpu import continuum_driver as j_cdrv
from ndpp_tpu import driver as j_driver
from ndpp_tpu import groups as j_groups
from ndpp_tpu.host.ace import synth as j_synth
from ndpp_tpu.host.ace.write import write_ace
from ndpp_tpu.io.library import compare, read_ascii
from ndpp_tpu.parallel import rows as j_rows
from ndpp_tpu_torch import chi_driver as t_chi_driver
from ndpp_tpu_torch import continuum_driver as t_cdrv
from ndpp_tpu_torch import driver as t_driver
from ndpp_tpu_torch.host.ace import synth as t_synth
from ndpp_tpu_torch.interop import config_from_dict, group_structure
from ndpp_tpu_torch.utils.metrics import RunMetrics

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

ORDER = 3
CPU = torch.device("cpu")
CONTINUUM_FIXTURES = ["kalbach", "law61", "law61cm", "law67", "law4nd", "law1", "law5", "nbody"]
CHI_FIXTURES = ["u235", "maxwell", "evap", "watt"]
LIB_ATOL = 1e-14


@pytest.fixture(scope="module")
def setup():
    """Group structure and run configuration of both packages (same values)."""
    j_rows.configure(1)
    gs_j = j_groups.get("uniform-lethargy-47")
    cfg_j = j_config.RunConfig(freegas_for=["none"], legendre_order=ORDER)
    cfg_j.device.e_tile = 64
    cfg_j.device.max_devices = 1
    return gs_j, group_structure(gs_j.name, gs_j.bounds), cfg_j, config_from_dict(cfg_j.to_dict())


def _assert_close(got, ref, rtol=1e-10, atol_scale=1e-13):
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (ref.ndim - 1))
    bad = np.abs(got - ref) > rtol * np.abs(ref) + atol_scale * scale
    assert not bad.any(), f"{int(bad.sum())} elements differ, worst {np.abs(got - ref).max():.3e}"


def _continuum_rows(nuc):
    """[(MT, four rows above its threshold)] for the nuclide's continuum reactions."""
    out = []
    for rxn in nuc.scattering_reactions(include_fission=False):
        nz = np.nonzero(nuc.sigma_on_grid(rxn) > 0)[0]
        if nz.size and not t_driver.is_twobody(rxn):
            e = nuc.energy[max(int(nz[0]) - 1, 0) :]
            out.append((rxn.mt, e[np.linspace(0, e.size - 1, 4).astype(int)]))
    return out


@pytest.mark.parametrize("key", CONTINUUM_FIXTURES)
def test_batched_continuum_moments_matches_reference(key, setup):
    gs_j, gs_t, cfg_j, cfg_t = setup
    jn, tn = j_synth.build(key), t_synth.build(key)
    rows = _continuum_rows(tn)
    assert rows, f"{key} has no continuum reaction"
    ref = j_cdrv.batched_continuum_moments(jn, [(jn.reactions[mt], e) for mt, e in rows], gs_j, ORDER, cfg_j)
    metrics = RunMetrics()
    got = t_cdrv.batched_continuum_moments(
        tn, [(tn.reactions[mt], e) for mt, e in rows], gs_t, ORDER, cfg_t, CPU, metrics
    )
    for g, r in zip(got, ref):
        _assert_close(g, r)
    # the same spans as the reference's driver records
    assert {"prep.continuum", "dispatch.continuum", "wait.continuum"} <= set(metrics.timers.report())


@pytest.mark.parametrize("key", CHI_FIXTURES)
def test_chi_collapse_matches_reference(key, setup):
    gs_j, gs_t, cfg_j, cfg_t = setup
    jn, tn = j_synth.build(key), t_synth.build(key)
    e_grid = jn.energy[np.linspace(0, jn.energy.size - 1, 6).astype(int)]
    ref, got = types.SimpleNamespace(energy=e_grid), types.SimpleNamespace(energy=e_grid)
    j_chi_driver.chi_collapse(ref, jn, gs_j, cfg_j)
    t_chi_driver.chi_collapse(got, tn, gs_t, cfg_t, CPU)
    assert vars(got).keys() == vars(ref).keys() and "chi_total" in vars(got)
    for name, r in vars(ref).items():
        g = getattr(got, name)
        if name.startswith("chi_") and r.ndim == 2:
            _assert_close(g, r)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)  # nu-bars and the grid: numpy on both sides
    live = got.chi_prompt.sum(axis=1) > 0  # analytic rows below U are all zero
    assert live.any()
    np.testing.assert_allclose(got.chi_prompt.sum(axis=1)[live], 1.0, rtol=1e-10)


def test_pooled_equals_per_reaction(setup):
    """Two cm-kalbach (and two lab-tabular) entries of one knot bucket ride
    one pooled dispatch; each must get what it gets alone. Rows are
    independent in every op, so the bound is roundoff of the row's scale
    (the pool may pick another ksel rung and other band windows)."""
    _, gs_t, _, cfg_t = setup
    for key in ("kalbach", "law4nd"):
        nuc = t_synth.build(key)
        (mt, e), = _continuum_rows(nuc)
        rxn = nuc.reactions[mt]
        both = t_cdrv.batched_continuum_moments(nuc, [(rxn, e[:2]), (rxn, e[1:])], gs_t, ORDER, cfg_t, CPU)
        for rows, pooled in zip((e[:2], e[1:]), both):
            alone = t_cdrv.continuum_reaction_moments(nuc, rxn, rows, gs_t, ORDER, cfg_t, CPU)
            _assert_close(pooled, alone, rtol=0.0, atol_scale=1e-12)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """kalbach (cm-kalbach MT 91 beside elastic and level inelastic) and u235
    (fission chi, prompt and delayed) at reduced n_energy."""
    out = tmp_path_factory.mktemp("contlib")
    entries = []
    for key, n in [("kalbach", 40), ("u235", 60)]:
        nuc = j_synth.ALL_FIXTURES[key](n)
        p = write_ace(nuc, out / f"{key}.ace")
        entries.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    (out / "xsdir").write_text("directory\n" + "\n".join(entries) + "\n")
    return out


def test_deck_matches_reference_library(library, tmp_path):
    ref_cfg = j_config.RunConfig(
        nuclides=["40090.80k", "92235.80c"], library=str(library / "xsdir"), groups="uniform-lethargy-47",
        legendre_order=ORDER, freegas_for=["none"],
    )
    ref_cfg.output.path = str(tmp_path / "ref.h5")
    ref_cfg.device.e_tile = 64
    ref_cfg.device.max_devices = 1
    ref_cfg.device.watchdog_minutes = 0
    ref_cfg.validate()
    ref = j_driver.run(ref_cfg)
    port_cfg = config_from_dict(ref_cfg.to_dict())
    port_cfg.output.path = str(tmp_path / "port.txt")
    port_cfg.output.format = "ascii"
    got = t_driver.run(port_cfg, device="cpu")
    assert (got.nuclides_done, got.nuclides_quarantined) == (2, 0) == (ref.nuclides_done, ref.nuclides_quarantined)
    assert got.moments_computed == ref.moments_computed

    report = compare(tmp_path / "ref.h5", tmp_path / "port.txt", rtol=1e-8, atol=LIB_ATOL)
    assert report["match"], report
    names = set(report["datasets"])
    for ds in ("scatter", "sigma_scatter"):
        assert {f"/nuclides/{n}/{ds}" for n in ref_cfg.nuclides} <= names
    for ds in ("chi_prompt", "chi_delayed", "chi_total", "nu_prompt", "nu_delayed", "nu_total"):
        assert f"/nuclides/92235.80c/{ds}" in names

    datasets, _ = read_ascii(tmp_path / "port.txt")
    for n in ref_cfg.nuclides:
        sc, sig = datasets[f"/nuclides/{n}/scatter"], datasets[f"/nuclides/{n}/sigma_scatter"]
        np.testing.assert_allclose(sc[0, :, 0, :].sum(axis=1)[sig > 0], 1.0, rtol=1e-8)
    for ds in ("chi_prompt", "chi_delayed", "chi_total"):
        np.testing.assert_allclose(datasets[f"/nuclides/92235.80c/{ds}"].sum(axis=1), 1.0, rtol=1e-10)
