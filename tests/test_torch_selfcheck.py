"""The port's accuracy gate (ndpp_tpu_torch/selfcheck.py) and the free-gas
panel-split kernel it holds the production free-gas kernel against.

Small sizes on the CPU: the panel-split kernel at quadrature (8, 8, 8) on
three rows and a 24-group window against the reference (jitted, on the
CPU), at 1e-10 relative plus 1e-13 of the row's scale against the reference
with its Lagrange split evaluated in the port's Legendre basis, and within
the shipped reference's own roundoff (1e-13 + 2 kappa 2^-52 of the row's
scale; at 8 GL nodes kappa is small). The gate definitions and the
production probe batch are held to the reference's bit for bit. The
production shape runs on the card only: chip_smoke.py's selfcheck phase and
the cuda-marked test in tests/test_torch_import.py (that file imports no jax,
which the card's machine lacks).
"""

import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ndpp_tpu import selfcheck as j_sc
from ndpp_tpu.ops import freegas as j_fg
from ndpp_tpu_torch import cli as t_cli
from ndpp_tpu_torch import selfcheck as t_sc
from ndpp_tpu_torch.ops import freegas as t_fg
from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments
from test_torch_freegas import EPS, _assert_close, _legendre_split_cumulants, _split_kappa, exact_split_reference

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

ROOT = Path(__file__).resolve().parents[1]
KT = 0.0253
ORDER = 3
NQ = (8, 8, 8)  # (nq_g, nq_r, nq_c) of the CPU parity runs
_STATIC = ("order", "nq_g", "nq_r", "nq_c", "chunk", "nfill_r", "nfill_c", "ngeo_c", "nfill_y")
_PANELSPLIT_FN = []


def _window(ng=24):
    return np.concatenate([[0.0], np.geomspace(1e-5, 60.0, ng)])


def _reference_panelsplit_exact(*args):
    """The reference's freegas_moments_panelsplit, jitted anew with its
    Lagrange split evaluated in the Legendre basis (no file of the reference
    changes; the shipped function's traces stay the shipped ones)."""
    if not _PANELSPLIT_FN:
        shipped = j_fg.freegas_moments_panelsplit.__wrapped__

        def legendre_split(e, awr, kt, bounds, order, nq_g=10, nq_r=8, nq_c=8, chunk=8, nfill_r=7, nfill_c=7,
                           ngeo_c=8, nfill_y=8):
            return shipped(e, awr, kt, bounds, order, nq_g, nq_r, nq_c, chunk, nfill_r, nfill_c, ngeo_c, nfill_y)

        _PANELSPLIT_FN.append(jax.jit(legendre_split, static_argnames=_STATIC))
    saved = j_fg.lagrange_cumulants
    j_fg.lagrange_cumulants = _legendre_split_cumulants  # read when the function traces a new shape
    try:
        return np.asarray(_PANELSPLIT_FN[0](*args))
    finally:
        j_fg.lagrange_cumulants = saved


def test_production_inputs_are_the_references():
    for tile, k, ng in ((96, 48, 361), (33, 12, 40)):
        e_ref, args_ref = j_sc.production_inputs(tile, k, ng)
        e, args = t_sc.production_inputs(tile, k, ng, device="cpu")
        for got, ref in zip((e, *args), (e_ref, *args_ref)):
            assert got.dtype == torch.float64 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gates_agree_with_the_references():
    rng = np.random.default_rng(5)
    ref = rng.uniform(-1.0, 1.0, size=(6, 4, 9))
    ref[:, :, ::3] *= 1e-3  # elements below 10% of their row's largest
    for scale in (1e-12, 3e-9, 2e-8, 1e-6):
        got = ref + scale * rng.standard_normal(ref.shape)
        assert t_sc._errpair(torch.as_tensor(got), torch.as_tensor(ref)) == j_sc._errpair(got, ref)
        assert t_sc._errpair(got, ref, floor=1e-3) == j_sc._errpair(got, ref, floor=1e-3)
        assert t_sc._family_gate(torch.as_tensor(got), torch.as_tensor(ref)) == j_sc._family_gate(got, ref)
    gates = [t_sc._family_gate(ref + s, ref) for s in (1e-10, 1e-7)]
    assert t_sc._worst(gates) == j_sc._worst(gates)
    assert t_sc._worst(gates)["ok"] is False


@pytest.mark.parametrize("awr", [0.999, 238.0])
def test_pointwise_density_matches_reference(awr):
    """_pointwise_dens at outgoing points on both sides of the elastic point
    and at it, against the reference's under jit."""
    e = np.geomspace(1e-3, 10.0, 3)
    y = np.sqrt(e)[:, None] * np.linspace(0.05, 3.0, 7)[None, :]
    y[:, 3] = np.sqrt(e)
    a, k = np.full(3, awr), np.full(3, KT)

    def inputs(lib, x, xp):
        v = xp.sqrt(x(e))
        aw, kt = x(a), x(k)
        gamma, beta = aw / (aw + 1.0), xp.sqrt(aw / kt)
        inv_beta = 1.0 / beta
        lo = xp.maximum(v - 8.0 * inv_beta, x(np.zeros(3)))
        quad = [x(q) for q in (*lib.gl_nodes_weights(8), *lib.gl_nodes_weights(8))]
        return (x(y), v, aw, gamma, beta, inv_beta, (aw + 1.0) / aw, lo, v + 8.0 * inv_beta,
                x(lib._VR_OFFSETS), x(lib._VCM_OFFSETS), *quad)

    import jax.numpy as jnp

    ref = jax.jit(lambda *z: j_fg._pointwise_dens(*z, ORDER, 7, 7, 8))(*inputs(j_fg, jnp.asarray, jnp))
    got = t_fg._pointwise_dens(*inputs(t_fg, torch.as_tensor, torch), ORDER, 7, 7, 8)
    _assert_close(torch.stack(got, dim=1).numpy(), np.stack([np.asarray(r) for r in ref], axis=1))


@pytest.mark.parametrize("awr", [0.999, 238.0])
def test_panelsplit_matches_reference(awr):
    """Three rows from 1e-3 eV to 10 eV, P3, a 24-group covering window."""
    e = np.geomspace(1e-3, 10.0, 3)
    b = _window()
    got = t_fg.freegas_moments_panelsplit(torch.as_tensor(e), awr, KT, torch.as_tensor(b), ORDER, *NQ).numpy()
    assert got.shape == (3, ORDER + 1, 24)
    np.testing.assert_allclose(got[:, 0].sum(axis=1), 1.0, rtol=1e-13)  # normalized over its window
    _assert_close(got, _reference_panelsplit_exact(e, awr, KT, b, ORDER, *NQ))
    shipped = np.asarray(j_fg.freegas_moments_panelsplit(e, awr, KT, b, ORDER, *NQ))
    _assert_close(got, shipped, atol_scale=1e-13 + 2 * _split_kappa(NQ[0]) * EPS)


def test_panelsplit_does_not_depend_on_the_chunk():
    e = torch.as_tensor(np.geomspace(1e-3, 10.0, 2))
    b = torch.as_tensor(_window(12))
    whole = t_fg.freegas_moments_panelsplit(e, 15.858, KT, b, 2, 4, 4, 4, chunk=t_fg.Y_PANELS)
    for chunk in (1, 3, 8):
        part = t_fg.freegas_moments_panelsplit(e, 15.858, KT, b, 2, 4, 4, 4, chunk=chunk)
        assert torch.equal(part, whole), chunk


def test_panelsplit_chunk_follows_the_budget():
    """The chunk fills the byte budget of the live (T, chunk nq_g, nq_r, C)
    tensors: C = 37 V_cm panels (lo, two graded ladders of 11, 14 unique fill
    fractions, hi) of nq_c nodes at the reference's fill settings."""
    assert t_fg._c_fill(7, 8).size == 14
    per_panel = 8 * 16 * 20 * 37 * 20 * 8 * t_fg._PW_LIVE_NODE_TENSORS
    assert t_fg.panelsplit_chunk_for(8, 16, 20, 20, 7, 8, 39, 3 * per_panel) == 3
    assert t_fg.panelsplit_chunk_for(8, 16, 20, 20, 7, 8, 39, 3 * per_panel - 1) == 2
    assert t_fg.panelsplit_chunk_for(8, 16, 20, 20, 7, 8, 39, 1) == 1
    assert t_fg.panelsplit_chunk_for(1, 4, 4, 4, 7, 8, 39) == 39 == t_fg.y_panels(8) == t_fg.Y_PANELS


def test_sab_kernel_matches_reference_at_the_selfcheck_window():
    """freegas_moments_sab after its machinery was shared with the
    panel-split kernel, on the selfcheck's window (the 361-group structure's
    lowest 256 groups and the catch group), light and heavy."""
    from ndpp_tpu_torch import groups

    b = np.concatenate([[0.0], groups.get("uniform-lethargy-361").bounds[:257]])
    e = np.geomspace(1e-3, 10.0, 4)
    for awr in (0.999, 238.0):
        got = t_fg.freegas_moments_sab(torch.as_tensor(e), awr, KT, torch.as_tensor(b), ORDER).numpy()
        with exact_split_reference() as ref_fn:
            _assert_close(got, ref_fn(e, awr, KT, b, ORDER))


def _small_families(monkeypatch, freegas_awrs=(0.999, 238.0)):
    """The families at CPU size: free-gas on one row (1e-3 eV) of the
    production window with the panel-split kernel at (12, 8, 8) (at (8, 8, 8)
    the reference kernel itself misses the gate, 3.3e-7 at A = 0.999),
    continuum on four rows of 64 groups, chi on four rows."""
    fg = partial(t_sc.check_freegas, rows=1, awrs=freegas_awrs, nq=(12, 8, 8))
    monkeypatch.setitem(t_sc.FAMILIES, "freegas", fg)
    monkeypatch.setitem(t_sc.FAMILIES, "continuum", partial(t_sc.check_continuum, rows=4, ng=64))
    monkeypatch.setitem(t_sc.FAMILIES, "chi", partial(t_sc.check_chi, rows=4))


def test_run_on_cpu_skips_the_kernel_and_passes_every_family(monkeypatch):
    _small_families(monkeypatch)
    before = twobody_group_moments.launches
    report = t_sc.run(tile=64, device="cpu")
    assert report["twobody"] == {"skipped": "the kernel runs only on a CUDA device"}
    assert not any(k.startswith("twobody_") for k in report)
    assert twobody_group_moments.launches == before
    for name in ("freegas", "continuum", "chi"):
        assert report[name]["ok"], (name, report[name])
        assert report[name]["max_abs"] <= 1e-8 and report[name]["seconds"] > 0
    assert report["continuum"]["small_aa_ok"]
    assert report["ok"] and report["failed"] == []
    print(json.dumps(report))


def test_cli_selfcheck_on_cpu_exits_0(monkeypatch, capsys):
    _small_families(monkeypatch, freegas_awrs=(238.0,))
    rc = t_cli.main(["selfcheck", "--device", "cpu", "--tile", "64"])
    out, err = capsys.readouterr()
    report = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and report["ok"]
    assert "two-body leg skipped on cpu: the kernel runs only on a CUDA device" in err


def test_cli_selfcheck_names_a_failing_family(monkeypatch, capsys):
    monkeypatch.setitem(t_sc.FAMILIES, "freegas", partial(t_sc.check_freegas, rows=1, awrs=(0.999,), nq=(8, 8, 8)))
    monkeypatch.setitem(t_sc.FAMILIES, "continuum", partial(t_sc.check_continuum, rows=4, ng=64))
    monkeypatch.setitem(t_sc.FAMILIES, "chi", partial(t_sc.check_chi, rows=4))
    rc = t_cli.main(["selfcheck", "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == 1 and json.loads(out.strip().splitlines()[-1])["failed"] == ["freegas"]
    assert "selfcheck FAILED: freegas:" in err


def test_selfcheck_without_a_card_exits_2():
    """The default device is cuda; with no card visible the gate does not
    run and does not skip quietly: ConfigError, exit 2."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-m", "ndpp_tpu_torch", "selfcheck"], capture_output=True, text=True, timeout=120, env=env,
        cwd=ROOT,
    )
    assert out.returncode == 2, out.stderr
    assert "torch.cuda.is_available() is False" in out.stderr and out.stdout == ""
