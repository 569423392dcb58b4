"""Free-gas op and the free-gas and S(alpha,beta) drivers of the port against the reference.

The same seeded inputs go through the jitted reference on the CPU and through
the port's torch code on the CPU. Tolerance: |got - ref| <= 1e-10 |ref| +
1e-13 * (the row's largest |moment|), as for the continuum ops.

One piece is held differently, and why. Both packages split a y-panel's
integral at a group boundary with the GL-node Lagrange interpolant. The
reference evaluates its antiderivatives A_q(t) from monomial coefficients;
at the free-gas rule's nq_g = 20 nodes those reach 3e4 with alternating
signs (kappa = max_q sum_k |c_qk| = 1.19e5), so the reference's group values
carry up to kappa * 2^-52 = 2.6e-11 of a row's scale in roundoff
(test_lagrange_split_is_exact_where_the_monomial_form_is_not measures
8e-12 in A_q alone). The port evaluates the same polynomials in the
Legendre basis (ops.panelsplit.lagrange_antiderivative_basis), exact to
~4e-15. So the port is held to 1e-10 |ref| + 1e-13 * scale against the
reference with its split evaluated in that basis (exact_split_reference:
the reference's own freegas_moments_sab, re-jitted in this process with a
Legendre-basis lagrange_cumulants; no file of the reference changes), and
to the reference as shipped within its own roundoff, 1e-10 |ref| + (1e-13 +
2 kappa 2^-52) * scale.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ndpp_tpu import config as j_config
from ndpp_tpu import driver as j_driver
from ndpp_tpu import freegas_driver as j_fgd
from ndpp_tpu import thermal_driver as j_thd
from ndpp_tpu.host import unionize as j_unionize
from ndpp_tpu.host.ace import synth as j_synth
from ndpp_tpu.ops import freegas as j_fg
from ndpp_tpu.ops import panelsplit as j_split
from ndpp_tpu_torch import driver as t_driver
from ndpp_tpu_torch import freegas_driver as t_fgd
from ndpp_tpu_torch import thermal_driver as t_thd
from ndpp_tpu_torch.config import BOLTZMANN_EV_PER_K
from ndpp_tpu_torch.host.ace import synth as t_synth
from ndpp_tpu_torch.interop import config_from_dict, thermal_table
from ndpp_tpu_torch.ops import freegas as t_fg
from ndpp_tpu_torch.ops import panelsplit as t_split
from ndpp_tpu_torch.parallel import rows as rows_mod

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

KT = 0.0253  # eV, 293.6 K
ORDER = 3
CPU = torch.device("cpu")
EPS = 2.0**-52


def _split_kappa(nq: int) -> float:
    """max_q sum_k |c_qk| of the reference's monomial antiderivatives."""
    return float(np.abs(j_split.lagrange_antiderivative_coeffs(nq)).sum(axis=1).max())


def _legendre_split_cumulants(edges, pmid_p, phalf_p, gvals, wg, boundaries, npan: int, nq: int):
    """The reference's lagrange_cumulants with A_q(t) in the Legendre basis
    of the port (same panel lookup, same sums, exact antiderivatives)."""
    tt = edges.shape[0]
    totals = phalf_p[..., None] * jnp.sum(gvals * wg[None, None, :, None], axis=2)
    prefix = jnp.cumsum(totals, axis=1) - totals
    b = boundaries if boundaries.ndim == 2 else jnp.broadcast_to(boundaries[None, :], (tt, boundaries.shape[0]))
    pidx = jnp.clip(jnp.sum((edges[:, None, :-1] <= b[:, :, None]).astype(jnp.int32), axis=2) - 1, 0, npan - 1)
    mid_b = jnp.take_along_axis(pmid_p, pidx, axis=1)
    half_b = jnp.take_along_axis(phalf_p, pidx, axis=1)
    nodes_b = jnp.take_along_axis(gvals, pidx[:, :, None, None], axis=1)
    prefix_b = jnp.take_along_axis(prefix, pidx[:, :, None], axis=1)
    t_b = jnp.clip((b - mid_b) / jnp.maximum(half_b, 1e-30), -1.0, 1.0)
    ps = [jnp.ones_like(t_b), t_b]
    for l in range(1, nq):
        ps.append(((2 * l + 1) * t_b * ps[l] - l * ps[l - 1]) / (l + 1))
    d = jnp.stack([t_b + 1.0] + [ps[k + 1] - ps[k - 1] for k in range(1, nq)], axis=-1)
    aq = jnp.sum(d[:, :, None, :] * jnp.asarray(t_split.lagrange_antiderivative_basis(nq))[None, None], axis=3)
    return prefix_b + half_b[..., None] * jnp.sum(aq[..., None] * nodes_b, axis=2)


_LEGENDRE_SPLIT_FN = []


@contextlib.contextmanager
def exact_split_reference():
    """The reference's freegas_moments_sab, jitted anew with its Lagrange split
    evaluated in the Legendre basis, installed where the reference's free-gas
    driver calls it; everything is restored on exit."""
    if not _LEGENDRE_SPLIT_FN:
        shipped = j_fg.freegas_moments_sab.__wrapped__

        # a function object of its own: jax caches traces by the traced
        # function, and the shipped one's traces must stay the shipped ones
        def legendre_split(e, awr, kt, bounds, order, nq_u=24, nq_g=20, chunk=8, nfill_y=8):
            return shipped(e, awr, kt, bounds, order, nq_u, nq_g, chunk, nfill_y)

        _LEGENDRE_SPLIT_FN.append(
            jax.jit(legendre_split, static_argnames=("order", "nq_u", "nq_g", "chunk", "nfill_y"))
        )
    fn = _LEGENDRE_SPLIT_FN[0]
    saved = (j_fg.lagrange_cumulants, j_fgd.freegas_moments_sab)
    j_fg.lagrange_cumulants = _legendre_split_cumulants  # read when fn traces a new shape
    j_fgd.freegas_moments_sab = fn
    try:
        yield fn
    finally:
        j_fg.lagrange_cumulants, j_fgd.freegas_moments_sab = saved


def _row_scale(ref):
    return np.abs(ref).reshape(ref.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (ref.ndim - 1))


def _assert_close(got, ref, rtol=1e-10, atol_scale=1e-13):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    scale = _row_scale(ref)
    err = np.abs(got - ref)
    bad = err > rtol * np.abs(ref) + atol_scale * scale
    worst = (err / np.where(scale > 0, scale, 1.0)).max()
    assert not bad.any(), f"{int(bad.sum())} elements differ, worst {worst:.3e} of the row scale"
    print(f"worst |got - ref| / row scale = {worst:.3e}")
    return worst


def _window(ng=33):
    """A covering window as apply_freegas builds it: a [0, b0) catch group
    and ng - 1 groups from 1e-5 eV to 60 eV (past the reach of 400 kT)."""
    return np.concatenate([[0.0], np.geomspace(1e-5, 60.0, ng)])


def test_lagrange_split_is_exact_where_the_monomial_form_is_not():
    """A_q(t) = int_{-1}^t L_q against its exact value (each Lagrange basis
    polynomial in product form, integrated by a 64-node rule in long double):
    the port's Legendre basis within 2e-14 at 8 and 20 nodes; the reference's
    monomial coefficients, at 20 nodes, within their kappa * 2^-52."""
    xs, ws = (a.astype(np.longdouble) for a in np.polynomial.legendre.leggauss(64))
    t = np.linspace(-1.0, 1.0, 41)
    for nq in (8, 20):
        x = np.polynomial.legendre.leggauss(nq)[0].astype(np.longdouble)
        exact = np.zeros((t.size, nq), dtype=np.longdouble)
        for i, ti in enumerate(t):
            half = (np.longdouble(ti) + 1) / 2
            s = (np.longdouble(ti) - 1) / 2 + half * xs
            for q in range(nq):
                lq = np.prod([(s - x[j]) / (x[q] - x[j]) for j in range(nq) if j != q], axis=0)
                exact[i, q] = half * np.sum(ws * lq)
        tt = torch.as_tensor(t)
        pl = t_split.legendre_all(tt, nq)
        d = torch.cat([(tt + 1.0)[:, None], pl[:, 2:] - pl[:, :-2]], dim=1)
        port = (d @ torch.as_tensor(t_split.lagrange_antiderivative_basis(nq)).T).numpy()
        mono = np.polynomial.polynomial.polyvander(t, nq) @ j_split.lagrange_antiderivative_coeffs(nq).T
        port_err = float(np.abs(port - exact).max())
        mono_err = float(np.abs(mono - exact).max())
        print(f"nq={nq}: Legendre basis {port_err:.3e}, monomial {mono_err:.3e}, kappa {_split_kappa(nq):.4g}")
        assert port_err < 2e-14
        assert mono_err < _split_kappa(nq) * EPS
        np.testing.assert_array_equal(port[-1], np.polynomial.legendre.leggauss(nq)[1])  # A_q(1) = w_q exactly


@pytest.mark.parametrize("awr", [0.999167, 15.858, 238.0])
def test_sab_dens_matches_reference(awr):
    """The scattering-law density at outgoing points on both sides of the
    elastic point, at and near it."""
    e = np.geomspace(1e-4, 400 * KT, 8)
    y = np.sqrt(e)[:, None] * np.linspace(0.05, 3.0, 17)[None, :]
    y[:, 5] = np.sqrt(e)  # the elastic point itself
    a, k = np.full(8, awr), np.full(8, KT)
    ref = jax.jit(lambda *z: j_fg._sab_dens(*z, ORDER, 24))(y, np.sqrt(e), a, k)
    got = t_fg._sab_dens(*(torch.as_tensor(z) for z in (y, np.sqrt(e), a, k)), ORDER)
    _assert_close(torch.stack(got, dim=1).numpy(), np.stack([np.asarray(r) for r in ref], axis=1))


@pytest.mark.parametrize("awr", [0.999167, 15.858, 238.0])
def test_freegas_moments_sab_matches_reference(awr):
    """12 rows from 1e-4 eV to 400 kT, P3, a 33-group covering window."""
    e = np.geomspace(1e-4, 400 * KT, 12)
    b = _window()
    got = t_fg.freegas_moments_sab(torch.as_tensor(e), awr, KT, torch.as_tensor(b), ORDER).numpy()
    assert got.shape == (12, ORDER + 1, 33)
    np.testing.assert_allclose(got[:, 0].sum(axis=1), 1.0, rtol=1e-13)  # normalized over its window
    with exact_split_reference() as ref_fn:
        _assert_close(got, ref_fn(e, awr, KT, b, ORDER))
    shipped = np.asarray(j_fg.freegas_moments_sab(e, awr, KT, b, ORDER))
    _assert_close(got, shipped, atol_scale=1e-13 + 2 * _split_kappa(20) * EPS)


def test_result_does_not_depend_on_chunk():
    e = torch.as_tensor(np.geomspace(1e-3, 400 * KT, 9))
    b = torch.as_tensor(_window(17))
    whole = t_fg.freegas_moments_sab(e, 15.858, KT, b, 5, chunk=t_fg.Y_PANELS)
    for chunk in (1, 3, 8):
        part = t_fg.freegas_moments_sab(e, 15.858, KT, b, 5, chunk=chunk)
        assert torch.equal(part, whole), chunk


def test_chunk_and_tiles_follow_the_budget_and_e_tile():
    """The chunk fills the byte budget and shrinks with it; halving e_tile
    (the OOM retry) halves the free-gas tile as well as the two-body one."""
    per_panel = 256 * 20 * t_fg.U_PANELS * 24 * 8 * t_fg._LIVE_NODE_TENSORS
    assert t_fg.chunk_for(256, 10 * per_panel) == 10
    assert t_fg.chunk_for(256, 5 * per_panel + 1) == 5
    assert t_fg.chunk_for(256, 1) == 1
    assert t_fg.chunk_for(1, 1 << 40) == t_fg.Y_PANELS == 39
    assert rows_mod.tile_for(1000, 256, 512) == 256
    assert rows_mod.tile_for(1000, 256, 256) == 128
    assert rows_mod.tile_for(1000, 512, 256) == 256
    assert rows_mod.tile_for(100, 256, 512) == 100
    assert rows_mod.tile_for(1000, 256, 16) == 16  # floored at 16 rows


def _cfgs(**run):
    cfg = j_config.RunConfig(
        groups="uniform-lethargy-47", legendre_order=ORDER, temperatures=[293.6, 600.0], **run
    )
    cfg.device.e_tile = 64
    cfg.device.max_devices = 1
    cfg.validate()
    return cfg, config_from_dict(cfg.to_dict())


def _nuclide_inputs(key, n_energy, j_cfg, t_cfg):
    """Both packages' nuclide, union grid and 0K scattering_moments output."""
    j_nuc, t_nuc = j_synth.ALL_FIXTURES[key](n_energy), t_synth.ALL_FIXTURES[key](n_energy)
    e_grid = j_unionize.moment_grid(j_nuc.energy)
    gs = j_cfg.group_structure()
    j_base, _, j_el0k = j_driver.scattering_moments(j_nuc, gs, j_cfg, e_grid)
    t_base, _, t_el0k = t_driver.scattering_moments(t_nuc, t_cfg.group_structure(), t_cfg, e_grid, CPU)
    _assert_close(t_base, j_base)
    assert (t_el0k is None) == (j_el0k is None)
    scatter = np.broadcast_to(j_base, (2,) + j_base.shape).copy()
    return j_nuc, t_nuc, e_grid, gs, scatter, j_el0k, t_el0k


@pytest.mark.parametrize(
    "key,n_energy,reuse_elastic,xs_weighting,max_rows",
    [
        ("h1", 50, True, True, 0),
        ("h1", 50, False, False, 0),
        ("fe56", 60, True, False, 0),
        ("o16", 40, False, True, 6),  # the opt-in log-subgrid, lin-log interpolated back
    ],
)
def test_apply_freegas_matches_reference(key, n_energy, reuse_elastic, xs_weighting, max_rows):
    j_cfg, t_cfg = _cfgs(freegas_xs_weighting=xs_weighting)
    j_cfg.device.freegas_max_rows = t_cfg.device.freegas_max_rows = max_rows
    j_nuc, t_nuc, e_grid, gs, scatter, j_el0k, t_el0k = _nuclide_inputs(key, n_energy, j_cfg, t_cfg)
    if reuse_elastic:
        assert j_el0k is not None
    with exact_split_reference():
        ref = j_fgd.apply_freegas(
            scatter.copy(), j_nuc, gs, j_cfg, e_grid, None, None, j_el0k if reuse_elastic else None
        )
    got = t_fgd.apply_freegas(
        scatter.copy(), t_nuc, t_cfg.group_structure(), t_cfg, e_grid, CPU, None, None,
        t_el0k if reuse_elastic else None,
    )
    n_thermal = int(np.searchsorted(e_grid, t_cfg.thermal_cutoff_kt * BOLTZMANN_EV_PER_K * 600.0))
    assert n_thermal > 0 and not np.array_equal(got[1, :n_thermal], scatter[1, :n_thermal])
    np.testing.assert_array_equal(got[:, n_thermal:], scatter[:, n_thermal:])  # above the cutoff: 0K
    _assert_close(got.reshape(-1, *got.shape[2:]), ref.reshape(-1, *ref.shape[2:]))


@pytest.mark.parametrize("key,n_energy,table", [("h1", 50, "lwtr"), ("o16", 40, "grph")])
def test_apply_sab_then_freegas_matches_reference(key, n_energy, table):
    """S(alpha,beta) below the table's e_max, free-gas above it: the order
    of process_nuclide, on both packages' tables (the port's built from the
    reference's fields through interop.thermal_table)."""
    j_cfg, t_cfg = _cfgs()
    j_nuc, t_nuc, e_grid, gs, scatter, j_el0k, t_el0k = _nuclide_inputs(key, n_energy, j_cfg, t_cfg)
    j_tabs = j_thd.match_tables([j_synth.build_thermal(table)], j_cfg.temperatures)
    t_tabs = t_thd.match_tables([thermal_table(j_synth.build_thermal(table))], t_cfg.temperatures)
    ref = j_thd.apply_sab(scatter.copy(), j_nuc, gs, j_cfg, e_grid, j_tabs)
    got = t_thd.apply_sab(scatter.copy(), t_nuc, t_cfg.group_structure(), t_cfg, e_grid, t_tabs, CPU)
    n_sab = int(np.searchsorted(e_grid, t_tabs[0].e_max, side="right"))
    assert 0 < n_sab < e_grid.size and t_thd.sab_e_max(t_tabs) == [t_tabs[0].e_max] * 2
    np.testing.assert_array_equal(got[:, n_sab:], scatter[:, n_sab:])
    _assert_close(got.reshape(-1, *got.shape[2:]), ref.reshape(-1, *ref.shape[2:]))
    with exact_split_reference():
        ref = j_fgd.apply_freegas(ref, j_nuc, gs, j_cfg, e_grid, None, j_thd.sab_e_max(j_tabs), j_el0k)
    got = t_fgd.apply_freegas(
        got, t_nuc, t_cfg.group_structure(), t_cfg, e_grid, CPU, None, t_thd.sab_e_max(t_tabs), t_el0k
    )
    _assert_close(got.reshape(-1, *got.shape[2:]), ref.reshape(-1, *ref.shape[2:]))


def test_freegas_for_and_deck_tables():
    """freegas_for names the nuclides free-gas applies to; a deck's table
    names resolve from the library first, then the built-in fixtures."""
    j_cfg, t_cfg = _cfgs(freegas_for=["8016.80c"])
    t_nuc = t_synth.h1_like(30)
    e_grid = j_unionize.moment_grid(t_nuc.energy)
    scatter = np.zeros((2, e_grid.size, ORDER + 1, 47))
    assert t_fgd.apply_freegas(scatter, t_nuc, t_cfg.group_structure(), t_cfg, e_grid, CPU) is scatter
    assert not scatter.any()
    tabs = t_thd.resolve_tables(["lwtr.20t", "grph.20t"])
    assert [t.name for t in tabs] == ["lwtr.20t", "grph.20t"]
    with pytest.raises(t_thd.ConfigError, match="not found"):
        t_thd.resolve_tables(["zzz.20t"])
    far = t_thd.match_tables(tabs[:1], [293.6, 1200.0])
    assert far == [tabs[0], tabs[0]]
    assert t_thd.sab_e_max([None, tabs[1]]) == [0.0, tabs[1].e_max]
