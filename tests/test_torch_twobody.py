"""Port parity: ndpp_tpu_torch two-body ops vs the JAX reference on the CPU.

The JAX side is the f64 XLA path (jitted), which is what the reference
driver runs on a CPU. The port runs its plain torch inner stage here.

Tolerance: rtol 1e-12, atol 1e-14 on the moments, which are per unit
scatter (P0 rows sum to 1). Both sides are float64 with the same formulas;
the only differences are the order of the q sums (the port multiplies by
`half` after the sum, as the CUDA kernel does) and the cumulative sum of the
group reduction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndpp_tpu import groups
from ndpp_tpu.host.ace import synth
from ndpp_tpu.host.prep import prepare_twobody
from ndpp_tpu.ops import segment as j_segment
from ndpp_tpu.ops import twobody as j_twobody
from ndpp_tpu_torch.interop import twobody_inputs
from ndpp_tpu_torch.ops import segment as t_segment
from ndpp_tpu_torch.ops import twobody as t_twobody

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

RTOL, ATOL = 1e-12, 1e-14
N_GROUPS = 24
BAND = 8


def _prep(fixture: str, mt: int, n_energy: int):
    nuc = synth.ALL_FIXTURES[fixture](n_energy)
    rxn = next(r for r in nuc.scattering_reactions(include_fission=False) if r.mt == mt)
    return prepare_twobody(nuc, rxn, nuc.energy)


def _bounds(per_row: bool, n_rows: int, seed: int):
    """Shared (G+1,) bounds, or random per-row (T, B+1) windows of them."""
    b = groups.uniform_lethargy("ul", N_GROUPS).bounds
    if not per_row:
        return b
    g0 = np.random.default_rng(seed).integers(0, N_GROUPS - BAND + 1, size=n_rows)
    return b[g0[:, None] + np.arange(BAND + 1)[None, :]]


# (fixture, MT, n_energy, per-row windows, clamp, order): h1 is the A ~ 1
# elastic case (E'_lab(-1) ~ 0, the graded ladder's reason); fe56 MT 52 is a
# discrete level whose first rows sit just above threshold.
CASES = [
    ("h1", 2, 24, False, True, 3),
    ("h1", 2, 24, True, False, 5),
    ("fe56", 52, 40, False, False, 0),
    ("fe56", 52, 40, True, True, 5),
    ("o16", 2, 24, False, True, 5),
    ("o16", 51, 24, True, True, 3),
]


@pytest.mark.parametrize("fixture,mt,n_energy,per_row,clamp,order", CASES)
def test_twobody_moments_parity(fixture, mt, n_energy, per_row, clamp, order):
    prep = _prep(fixture, mt, n_energy)
    bounds = _bounds(per_row, prep.e.size, seed=order)
    ref = np.asarray(
        j_twobody.twobody_moments(
            jnp.asarray(prep.e), jnp.asarray(prep.knots), jnp.asarray(prep.pdf), jnp.asarray(bounds),
            prep.c1, prep.c2, prep.awr, order, 16, clamp,
        )
    )
    args = twobody_inputs(prep.e, prep.knots, prep.pdf, bounds, prep.c1, prep.c2, prep.awr, device="cpu")
    out = t_twobody.twobody_moments(*args, order, 16, clamp)
    assert out.dtype == torch.float64 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    if mt == 52:
        assert np.any(ref[0] == 0.0) and np.any(ref[-1] != 0.0)  # threshold rows are covered
    if clamp and not per_row:
        np.testing.assert_allclose(out[:, 0, :].sum(dim=1).numpy(), 1.0, rtol=1e-12)


@pytest.mark.parametrize("per_row", [False, True])
def test_twobody_panels_parity(per_row):
    """The prologue's outputs agree to rounding: the same sort of the same
    edge values, the same panel selection (searchsorted + gather here, a
    masked sum over knots in the reference)."""
    prep = _prep("fe56", 2, 30)
    bounds = _bounds(per_row, prep.e.size, seed=7)
    ref = j_twobody.twobody_panels(
        jnp.asarray(prep.e), jnp.asarray(prep.knots), jnp.asarray(prep.pdf), jnp.asarray(bounds),
        prep.c1, prep.c2, prep.awr, True,
    )
    args = twobody_inputs(prep.e, prep.knots, prep.pdf, bounds, prep.c1, prep.c2, prep.awr, device="cpu")
    out = t_twobody.twobody_panels(*args, True)
    names = ("mid", "half", "a_s", "b_s", "base", "slope", "ecm", "e_safe", "ap1", "valid_e")
    for name, r, o in zip(names, ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-14, atol=1e-15, err_msg=name)


def test_affine_coeffs_duplicated_and_padded_knots():
    """The panel rule at step (duplicated) knots and padded tails matches the
    reference's first-panel rule, including queries outside the knot span."""
    knots = np.array([[-1.0, -0.5, -0.5, 0.2, 1.0, 1.0, 1.0], [-0.8, 0.0, 0.0, 0.0, 0.5, 0.9, 0.9]])
    pdf = np.array([[0.1, 0.3, 0.7, 0.5, 0.9, 0.9, 0.9], [0.2, 0.4, 0.1, 0.6, 0.3, 0.8, 0.8]])
    mid = np.array([[-1.2, -0.75, -0.5, -0.1, 0.2, 0.99, 1.0, 1.3], [-0.9, -0.8, 0.0, 0.25, 0.5, 0.9, 0.95, -0.1]])
    ra, rb = j_twobody._affine_coeffs_rows(jnp.asarray(knots), jnp.asarray(pdf), jnp.asarray(mid))
    ta, tb = t_twobody._affine_coeffs_rows(torch.as_tensor(knots), torch.as_tensor(pdf), torch.as_tensor(mid))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("clamp", [True, False])
def test_segment_group_sum_parity(per_row, clamp):
    """Random sorted values, some exactly ON a boundary (side="right": they
    belong to the upper group) and some outside the group range."""
    rng = np.random.default_rng(11 + 2 * per_row + clamp)
    t, c, s, g = 5, 3, 40, 12
    bounds = np.geomspace(1.0, 1e3, g + 1)
    vals = np.exp(rng.uniform(np.log(0.3), np.log(3e3), size=(t, s)))
    vals[:, :6] = bounds[rng.integers(0, g + 1, size=(t, 6))]  # exact boundary hits
    vals.sort(axis=1)
    m = rng.uniform(-1.0, 1.0, size=(t, c, s)) / s  # moment-sized: |row sums| <= 1
    if per_row:
        g0 = rng.integers(0, g - 4 + 1, size=t)
        b = bounds[g0[:, None] + np.arange(5)[None, :]]
    else:
        b = bounds
    ref = np.asarray(j_segment.segment_group_sum(jnp.asarray(m), jnp.asarray(vals), jnp.asarray(b), clamp))
    out = t_segment.segment_group_sum(torch.as_tensor(m), torch.as_tensor(vals), torch.as_tensor(b), clamp)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_legendre_all_parity():
    from ndpp_tpu.ops.legendre import legendre_all as j_legendre_all
    from ndpp_tpu_torch.ops.legendre import legendre_all as t_legendre_all

    x = np.random.default_rng(5).uniform(-1.0, 1.0, size=(4, 7))
    ref = np.asarray(j_legendre_all(jnp.asarray(x), 10))
    np.testing.assert_allclose(t_legendre_all(torch.as_tensor(x), 10).numpy(), ref, rtol=1e-14, atol=1e-15)
