"""Bound-thermal S(alpha,beta) tables and ops of the port against the reference.

Host side (ACE codec, fixtures, prepare_thermal) is numpy on both sides, so
those comparisons are exact equality. The four ops of ops/thermal.py go
through the jitted reference on the CPU and the port's torch function on the
CPU, on the fixtures' prepared arrays and on seeded incident energies, with
|got - ref| <= 1e-10 |ref| + 1e-13 * (the row's largest |moment|): both sides
are float64 with the same closed forms and differ by summation order only.
"""

import numpy as np
import pytest
import torch

from ndpp_tpu.host import prep_thermal as j_prep
from ndpp_tpu.host.ace import synth as j_synth
from ndpp_tpu.host.ace import thermal as j_thermal
from ndpp_tpu.ops import thermal as j_ops
from ndpp_tpu_torch.host import prep_thermal as t_prep
from ndpp_tpu_torch.host.ace import synth as t_synth
from ndpp_tpu_torch.host.ace import thermal as t_thermal
from ndpp_tpu_torch.interop import thermal_table
from ndpp_tpu_torch.ops import thermal as t_ops

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

TABLES = ["lwtr", "grph"]
ORDER = 3


def _assert_close(got, ref, rtol=1e-10, atol_scale=1e-13):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (ref.ndim - 1))
    bad = np.abs(got - ref) > rtol * np.abs(ref) + atol_scale * scale
    assert not bad.any(), f"{int(bad.sum())} elements differ, worst {np.abs(got - ref).max():.3e}"
    print(f"worst |got - ref| / row scale = {(np.abs(got - ref) / np.where(scale > 0, scale, 1.0)).max():.3e}")


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64)


def _assert_same_table(a, b):
    """Every field of two ThermalTables (of either package) bit-equal."""
    assert (a.name, list(a.zaids), a.awr, a.kT, a.ifeng) == (b.name, list(b.zaids), b.awr, b.kT, b.ifeng)
    np.testing.assert_array_equal(a.inelastic_energy, b.inelastic_energy)
    np.testing.assert_array_equal(a.inelastic_sigma, b.inelastic_sigma)
    ia, ib = a.inelastic, b.inelastic
    if a.ifeng < 2:
        np.testing.assert_array_equal(ia.e_out, ib.e_out)
        np.testing.assert_array_equal(ia.mu, ib.mu)
        np.testing.assert_array_equal(ia.weights(), ib.weights())
    else:
        for f in ("e_out", "pdf", "cdf", "mu"):
            xs, ys = getattr(ia, f), getattr(ib, f)
            assert len(xs) == len(ys)
            for x, y in zip(xs, ys):
                np.testing.assert_array_equal(x, y)
    ea, eb = a.elastic, b.elastic
    assert ea.coherent == eb.coherent
    np.testing.assert_array_equal(ea.energy, eb.energy)
    np.testing.assert_array_equal(ea.sigma, eb.sigma)
    if ea.mu is not None or eb.mu is not None:
        np.testing.assert_array_equal(ea.mu, eb.mu)
    e = np.geomspace(1e-6, 10.0, 37)
    np.testing.assert_array_equal(ea.sigma_at(e), eb.sigma_at(e))


@pytest.mark.parametrize("key", TABLES)
def test_thermal_fixture_round_trips_and_matches_reference(key, tmp_path):
    """The port's fixture equals the reference's; written by the port it is
    the reference's text byte for byte, and parsed back by the port it is
    the reference's parse of the same file, field for field."""
    tab = t_synth.build_thermal(key)
    ref = j_synth.build_thermal(key)
    _assert_same_table(tab, ref)
    assert t_thermal.format_thermal_ascii(tab) == j_thermal.format_thermal_ascii(ref)
    path = t_thermal.write_thermal_ace(tab, tmp_path / f"{key}.ace")
    back = t_thermal.read_thermal_ace(path)
    _assert_same_table(back, j_thermal.read_thermal_ace(path))
    # the file holds 13 significant digits: its text is a fixed point of parse + write
    assert t_thermal.format_thermal_ascii(back) == t_thermal.format_thermal_ascii(tab)
    _assert_same_table(thermal_table(ref), tab)


def test_thermal_parser_rejects_truncated_tables(tmp_path):
    text = t_thermal.format_thermal_ascii(t_synth.build_thermal("grph"))
    with pytest.raises(t_thermal.AceFormatError, match="truncated"):
        t_thermal.parse_thermal_ascii("\n".join(text.splitlines()[:-3]) + "\n")


@pytest.mark.parametrize("key", TABLES)
@pytest.mark.parametrize("order", [0, 5])
def test_prepare_thermal_bit_equal(key, order):
    got = t_prep.prepare_thermal(t_synth.build_thermal(key), order)
    ref = j_prep.prepare_thermal(j_synth.build_thermal(key), order)
    assert (got.kind, got.elastic_kind) == (ref.kind, ref.elastic_kind)
    for f in ("e_in", "sigma_in", "e_knots", "pdf", "am", "e_out", "w_lines", "am_lines", "e_el", "sigma_el",
              "am_el", "bragg_s"):
        x, y = getattr(got, f), getattr(ref, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)


def _bounds(ng, lo=1e-5, hi=10.0):
    return np.geomspace(lo, hi, ng + 1)


@pytest.mark.parametrize("clamped", [False, True])
def test_thermal_continuous_moments_matches_reference(clamped):
    prep = t_prep.prepare_thermal(t_synth.build_thermal("lwtr"), ORDER)
    b = _bounds(24, 1e-4, 0.5)  # the spectra reach past both ends of this window
    if clamped:
        b[0], b[-1] = 0.0, np.inf
    ref = j_ops.thermal_continuous_moments(prep.e_knots, prep.pdf, prep.am, b, ORDER)
    got = t_ops.thermal_continuous_moments(_t(prep.e_knots), _t(prep.pdf), _t(prep.am), _t(b), ORDER)
    assert got.shape == (prep.e_in.size, ORDER + 1, 24)
    _assert_close(got.numpy(), ref)
    if clamped:  # the whole spectrum lands in the window: P0 rows integrate the pdf
        np.testing.assert_allclose(got[:, 0].sum(dim=1).numpy(), 1.0, rtol=1e-12)


@pytest.mark.parametrize("clamp", [True, False])
def test_thermal_discrete_moments_matches_reference(clamp):
    prep = t_prep.prepare_thermal(t_synth.build_thermal("grph"), ORDER)
    b = _bounds(20, 1e-3, 0.05)  # some lines fall outside the window
    ref = j_ops.thermal_discrete_moments(prep.e_out, prep.w_lines, prep.am_lines, b, clamp)
    got = t_ops.thermal_discrete_moments(_t(prep.e_out), _t(prep.w_lines), _t(prep.am_lines), _t(b), clamp)
    _assert_close(got.numpy(), ref)
    if clamp:
        np.testing.assert_allclose(got[:, 0].sum(dim=1).numpy(), 1.0, rtol=1e-14)


def test_coherent_elastic_moments_matches_reference(rng):
    prep = t_prep.prepare_thermal(t_synth.build_thermal("grph"), 5)
    e = np.sort(rng.uniform(1e-4, 0.2, size=29))
    e[:3] = [prep.e_el[0] * 0.5, prep.e_el[0], prep.e_el[3]]  # below the first edge and ON edges
    b = _bounds(16, 1e-4, 0.2)
    ref = j_ops.coherent_elastic_moments(e, prep.e_el, prep.bragg_s, b, 5)
    got = t_ops.coherent_elastic_moments(_t(e), _t(prep.e_el), _t(prep.bragg_s), _t(b), 5)
    _assert_close(got.numpy(), ref)
    assert not got[0].any()  # no edge is active below the first one
    np.testing.assert_array_equal((got[:, 0] != 0).sum(dim=1).numpy()[1:], 1)  # one group per row


def test_incoherent_elastic_placement_matches_reference(rng):
    f = rng.uniform(-1.0, 1.0, size=(17, ORDER + 1))
    b = _bounds(12, 1e-4, 1.0)
    e = np.concatenate([rng.uniform(1e-5, 2.0, size=14), b[[0, 5, 12]]])  # below, on and at the top bound
    ref = j_ops.incoherent_elastic_placement(f, e, b)
    got = t_ops.incoherent_elastic_placement(_t(f), _t(e), _t(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
