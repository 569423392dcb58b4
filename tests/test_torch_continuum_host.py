"""Host side of the continuum and chi families: the port's numpy copies give
the reference's arrays bit for bit.

Everything here is numpy on both sides (no device op, no XLA compile), so the
comparison is exact equality, not a tolerance.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ndpp_tpu import banding as j_banding
from ndpp_tpu import continuum_driver as j_cdrv
from ndpp_tpu.host import angular_moments as j_am
from ndpp_tpu.host import prep as j_prep
from ndpp_tpu.host import prep_continuum as j_pc
from ndpp_tpu.host.ace import synth as j_synth
from ndpp_tpu_torch import banding as t_banding
from ndpp_tpu_torch import continuum_driver as t_cdrv
from ndpp_tpu_torch.chi_driver import FISSION_MTS
from ndpp_tpu_torch.host import angular_moments as t_am
from ndpp_tpu_torch.host import prep as t_prep
from ndpp_tpu_torch.host import prep_continuum as t_pc
from ndpp_tpu_torch.host.ace import synth as t_synth

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

ROOT = Path(__file__).resolve().parents[1]
CONTINUUM_FIXTURES = ["kalbach", "law61", "law61cm", "law67", "law4nd", "law1", "law5", "nbody"]
CHI_FIXTURES = ["u235", "maxwell", "evap", "watt"]
PREP_FIELDS = (
    "e", "applicability", "e_knots", "pdf", "mom_knots", "r_rows", "a_rows", "mu_knots", "mu_pdf", "nbody_emax",
)


def _assert_same_prep(a, b):
    assert (a.kind, a.nbody_expo, a.real_elements, a.padded_elements) == (
        b.kind, b.nbody_expo, b.real_elements, b.padded_elements)
    for f in PREP_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.extra.keys() == b.extra.keys()
    for k, v in a.extra.items():
        for x, y in zip(v if isinstance(v, tuple) else (v,), b.extra[k] if isinstance(v, tuple) else (b.extra[k],)):
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("key", CONTINUUM_FIXTURES + CHI_FIXTURES)
def test_prepare_continuum_is_bit_equal(key):
    """Every continuum law of the fixture (and, for a fissile one, its prompt
    and delayed chi spectra), on a cut of the fixture's own grid."""
    jn, tn = j_synth.build(key), t_synth.build(key)
    e_grid = jn.energy[:: max(1, jn.energy.size // 9)]
    seen = set()
    for mt, rxn in jn.reactions.items():
        for i, ed in enumerate(rxn.energy_dists):
            if ed.law == 3:
                continue
            order = 0 if mt in FISSION_MTS else 3
            a = j_pc.prepare_continuum(jn, rxn, ed, e_grid, order)
            b = t_pc.prepare_continuum(tn, tn.reactions[mt], tn.reactions[mt].energy_dists[i], e_grid, order)
            _assert_same_prep(a, b)
            seen.add(a.kind)
    for i, spec in enumerate(jn.delayed_spectra or []):
        fis = next(m for m in FISSION_MTS if m in jn.reactions)
        a = j_pc.prepare_continuum(jn, jn.reactions[fis], spec, e_grid, 0)
        b = t_pc.prepare_continuum(tn, tn.reactions[fis], tn.delayed_spectra[i], e_grid, 0)
        _assert_same_prep(a, b)
    assert seen, f"{key} carries no continuum law"


def test_fixtures_cover_every_prepared_kind():
    kinds = set()
    for key in CONTINUUM_FIXTURES + CHI_FIXTURES:
        nuc = t_synth.build(key)
        for rxn in nuc.reactions.values():
            for ed in rxn.energy_dists:
                if ed.law != 3:
                    kinds.add(t_pc.prepare_continuum(nuc, rxn, ed, nuc.energy[-3:], 1).kind)
    assert kinds == {"lab-analytic", "lab-tabular", "cm-kalbach", "cm-tabular", "cm-nbody"}


def test_angular_moments_are_bit_equal():
    rng = np.random.default_rng(11)
    mu = np.sort(rng.uniform(-1, 1, size=(5, 9)), axis=1)
    mu[:, 0], mu[:, -1] = -1.0, 1.0
    mu[:, 4] = mu[:, 3]  # a step
    pdf = rng.uniform(0.1, 1.0, size=(5, 9))
    for order in (0, 1, 5):
        np.testing.assert_array_equal(t_am.linlin_moments(mu, pdf, order), j_am.linlin_moments(mu, pdf, order))
    r = rng.uniform(0, 1, size=(4, 7))
    a = rng.uniform(0, 6, size=(4, 7))
    a[0, :2] = (0.0, 1e-13)  # the isotropic limit
    np.testing.assert_array_equal(t_am.kalbach_moments(r, a, 5), j_am.kalbach_moments(r, a, 5))


def test_angular_panel_blocks_are_bit_equal():
    jn, tn = j_synth.build("law4nd"), t_synth.build("law4nd")
    e_grid = jn.energy[::7]
    got = list(t_prep.angular_panel_blocks(tn.reactions[91].angular, e_grid))
    ref = list(j_prep.angular_panel_blocks(jn.reactions[91].angular, e_grid))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        for x, y in zip(g, r):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ng,seed", [(12, 0), (47, 1), (361, 2)])
def test_banding_is_bit_equal(ng, seed):
    """plan, partition, window_bounds, support_cm and densify on seeded rows
    whose reach runs from one group to the whole structure."""
    rng = np.random.default_rng(seed)
    bounds = np.geomspace(1e-5, 2e7, ng + 1)
    n = 40
    lo = np.exp(rng.uniform(np.log(1e-6), np.log(1e7), size=n))
    hi = lo * np.exp(rng.uniform(0.0, 8.0, size=n) * (rng.random(n) < 0.8))
    for fn in ("plan", "partition"):
        got, ref = getattr(t_banding, fn)(lo, hi, bounds), getattr(j_banding, fn)(lo, hi, bounds)
        assert (got is None) == (ref is None)
        if got is not None:
            for x, y in zip(got, ref):
                np.testing.assert_array_equal(x, y)
    part = t_banding.partition(lo, hi, bounds)
    if part is not None:
        narrow, b_w, g0 = part
        np.testing.assert_array_equal(
            t_banding.window_bounds(bounds, g0[narrow], b_w), j_banding.window_bounds(bounds, g0[narrow], b_w))
        mom = rng.normal(size=(int(narrow.sum()), 3, b_w))
        np.testing.assert_array_equal(
            t_banding.densify(mom, g0[narrow], ng), j_banding.densify(mom, g0[narrow], ng))
    e = np.exp(rng.uniform(np.log(1e3), np.log(2e7), size=n))
    kn = np.sort(rng.uniform(0.0, 1.0, size=(n, 6)), axis=1) * e[:, None]
    for x, y in zip(t_banding.support_cm(e, 55.3, kn), j_banding.support_cm(e, 55.3, kn)):
        np.testing.assert_array_equal(x, y)


def test_window_knot_bound_and_rungs_equal_the_reference():
    rng = np.random.default_rng(5)
    for awr, ke in ((238.0, 64), (26.0, 32), (1.0, 16)):
        e = np.exp(rng.uniform(np.log(1e5), np.log(2e7), size=6))
        kn = np.sort(rng.uniform(0.0, 1.0, size=(6, ke)), axis=1) * e[:, None]
        assert t_cdrv._window_knot_bound(e, awr, kn) == j_cdrv._window_knot_bound(e, awr, kn)
    for k16 in (16, 64, 128, 256):
        for bound in range(0, k16 + 2):
            assert t_cdrv.quantize_ksel(bound, k16) == j_cdrv.quantize_ksel(bound, k16)


def test_tiles_and_chunk_shrink_with_e_tile():
    """The driver's device-OOM retry halves device.e_tile: the continuum
    tiles and the chunk's byte budget must follow it."""
    from ndpp_tpu_torch.ops import continuum as cont_ops
    from ndpp_tpu_torch.parallel.rows import Placement

    one = Placement(["cpu"])  # the driver's tiles: Placement.plan at the family's cap

    def spans(plan):
        return [(p.start, p.length) for p in plan.pieces]

    assert one.plan(1000, 256, 512).piece_rows == 256
    plan = one.plan(1000, 256, 256)
    assert plan.piece_rows == 128 and spans(plan)[0] == (0, 128) and spans(plan)[-1] == (896, 104)
    assert spans(one.plan(5, 256, 512)) == [(0, 5)]
    full = cont_ops.chunk_for(256, 12, 8, 108, 1557, cont_ops.CHUNK_BUDGET_BYTES)
    half = cont_ops.chunk_for(128, 12, 8, 108, 1557, cont_ops.CHUNK_BUDGET_BYTES // 2)
    assert 1 <= full == half < 1557  # half the rows under half the budget: the same panels, half the bytes
    assert cont_ops.chunk_for(4, 10, 7, 17, 278) == 278  # never more than the panels there are
    assert cont_ops.chunk_for(10**6, 12, 8, 108, 1557) == 1  # never less than one


def test_port_sources_import_neither_jax_nor_the_reference_package():
    """Source-level check over every module of the port and chip_smoke.py
    (tests/test_torch_import.py checks the same at import time)."""
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|ndpp_tpu)(?:\.|\s|$)", re.M)
    files = sorted((ROOT / "ndpp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        hit = pat.search(f.read_text())
        assert hit is None, f"{f.relative_to(ROOT)} imports {hit.group(1)}"
