"""The reference's cross-check functions, ported: the free-gas kink-panel
kernel, the pointwise kernel and the sigma_eff validation hook
(ops/freegas.py), and the closed-form integrals of the analytic fission
spectra (ops/chi.py), each held against its JAX function on seeded inputs.

Tolerances, with what each is measured against:
  - freegas_moments: |got - ref| <= 1e-10 |ref| + 1e-12 * (the row's largest
    |moment|). Its inner integral is a closed-form Laurent polynomial whose
    terms cancel (powers of 1/lo up to L - 2 against the log term), so both
    sides carry ~1e-13 of the row's scale in roundoff (8.4e-14 seen at A =
    15.86, P3), ten times the pointwise kernel's;
  - freegas_moments_pointwise: 1e-10 |ref| + 1e-13 * row scale, the bar of
    tests/test_torch_freegas.py;
  - freegas_sigma_eff_ratio: rtol 1e-13; both sides against the analytic
    Doppler ratio at rtol 1e-6 (the rule's own error);
  - chi closed forms: |got - ref| <= 1e-13 |ref| + 1e-15 * (the spectrum's
    complete integral, the complement at 0). The integrals below the peak
    are small differences of erf terms: the absolute floor is what the
    cancellation leaves of the complete integral.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndpp_tpu.ops import chi as j_chi
from ndpp_tpu.ops import freegas as j_fg
from ndpp_tpu_torch.ops import chi as t_chi
from ndpp_tpu_torch.ops import freegas as t_fg
from test_torch_freegas import _assert_close

torch.set_num_threads(1)

KT = 0.0253
ORDER = 3
AWRS = [0.99917, 15.858]  # hydrogen (the largest up-scatter) and oxygen
BOUNDS = np.geomspace(1e-5, 20.0, 9)  # 8 groups over the thermal reach


def _energies(seed):
    rng = np.random.default_rng(seed)
    return np.sort(np.exp(rng.uniform(np.log(1e-3), np.log(2.0), 4)))


def _t(x):
    return torch.as_tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("awr", AWRS)
def test_freegas_moments_matches_reference(awr, clamp):
    e = _energies(1)
    ref = np.asarray(j_fg.freegas_moments(jnp.asarray(e), awr, KT, jnp.asarray(BOUNDS), ORDER, clamp=clamp))
    got = t_fg.freegas_moments(_t(e), awr, KT, _t(BOUNDS), ORDER, clamp=clamp)
    _assert_close(got.numpy(), ref, atol_scale=1e-12)
    if clamp:  # every outgoing energy lands in some group
        np.testing.assert_allclose(got[:, 0, :].sum(dim=1).numpy(), 1.0, rtol=1e-12)


@pytest.mark.parametrize("awr", AWRS)
def test_freegas_moments_pointwise_matches_reference(awr):
    e = _energies(2)[::2]  # two rows: the kernel's (v_r, V_cm) quadrature per y node is the cost here
    window = np.concatenate([[0.0], BOUNDS])  # finite and covering, as the op asks
    ref = np.asarray(j_fg.freegas_moments_pointwise(jnp.asarray(e), awr, KT, jnp.asarray(window), ORDER))
    got = t_fg.freegas_moments_pointwise(_t(e), awr, KT, _t(window), ORDER, chunk=5)  # chunk: no effect
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("awr", AWRS)
def test_freegas_sigma_eff_ratio_matches_reference_and_the_analytic_ratio(awr):
    e = _energies(3)
    ref = np.asarray(j_fg.freegas_sigma_eff_ratio(jnp.asarray(e), awr, KT))
    got = t_fg.freegas_sigma_eff_ratio(_t(e), awr, KT).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13)
    x = np.sqrt(awr * e / KT)
    exact = (1.0 + 0.5 / x**2) * np.vectorize(math.erf)(x) + np.exp(-(x**2)) / (np.sqrt(np.pi) * x)
    np.testing.assert_allclose(got, exact, rtol=1e-6)


@pytest.mark.parametrize("clamp", [True, False])
def test_effective_sqrt_bounds_matches_reference(clamp):
    ref = np.asarray(j_fg._effective_sqrt_bounds(jnp.asarray(BOUNDS), clamp))
    np.testing.assert_array_equal(t_fg._effective_sqrt_bounds(_t(BOUNDS), clamp).numpy(), ref)


@pytest.mark.parametrize(
    "name,comp", [("_maxwell", "_maxwell_comp"), ("_evap", "_evap_comp"), ("_watt", "_watt_comp")]
)
@pytest.mark.parametrize("kind", ["integral", "comp"])
def test_chi_closed_forms_match_reference(name, comp, kind):
    rng = np.random.default_rng(4)
    x = np.concatenate([[0.0, 1e-3], np.exp(rng.uniform(np.log(1e2), np.log(3e7), 30))])
    theta = rng.uniform(1e5, 2e6, x.size)  # eV: Maxwell/evaporation temperatures, Watt's a
    extra = (rng.uniform(1e-6, 4e-6, x.size),) if name == "_watt" else ()  # Watt's b (1/eV)
    args = (x, theta, *extra)
    fn = comp if kind == "comp" else f"{name}_integral"
    ref = np.asarray(getattr(j_chi, fn)(*map(jnp.asarray, args)))
    got = getattr(t_chi, fn)(*map(_t, args)).numpy()
    total = np.asarray(getattr(t_chi, comp)(_t(np.zeros_like(x)), *map(_t, args[1:])))  # the complete integral
    assert np.isfinite(got).all() and (got >= 0).all()
    bad = np.abs(got - ref) > 1e-13 * np.abs(ref) + 1e-15 * total
    assert not bad.any(), (np.abs(got - ref) / total).max()
    # integral + complement = the complete integral
    other = getattr(t_chi, f"{name}_integral" if kind == "comp" else comp)(*map(_t, args)).numpy()
    np.testing.assert_allclose(got + other, total, rtol=1e-12)
