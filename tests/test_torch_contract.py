"""What the CUDA route of the two-body kernel relies on, checked on the CPU.

The kernel itself compiles and runs only on the card. These tests hold the
Python side to the C source it calls (the ctypes signature, the limits the
kernel is compiled with), hold chip_smoke.py's bound and bench inputs to the
wrapper's contract, and cover the wrapper's edge cases on the CPU.
"""

import re
import types

import ctypes
import numpy as np
import pytest
import torch

import chip_smoke
from ndpp_tpu_torch.ops import twobody_inner as inner_mod
from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments, twobody_group_moments_ref

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


def _c_entry_params() -> list[str]:
    src = inner_mod._SRC.read_text()
    sig = re.search(r'extern "C" int twobody_group_launch\((.*?)\)\s*\{', src, re.S)
    assert sig, "twobody_group_launch not found in the kernel source"
    return [" ".join(p.split()[:-1]) for p in sig.group(1).replace("\n", " ").split(",")]


def test_ctypes_signature_matches_the_c_entry_point():
    """A pointer passed where the C side takes an int (or the reverse) is cut
    or misread only on the card; hold bind()'s argtypes to the source."""
    params = _c_entry_params()
    fake = types.SimpleNamespace(twobody_group_launch=types.SimpleNamespace())
    fn = inner_mod.bind(fake).twobody_group_launch
    assert len(fn.argtypes) == len(params) == 18
    for param, argtype in zip(params, fn.argtypes):
        expected = ctypes.c_void_p if param.endswith("*") else C_TYPES[param.replace("const ", "")]
        assert argtype is expected, (param, argtype)
    assert fn.restype is ctypes.c_int


def test_wrapper_limits_match_the_kernel_source():
    src = inner_mod._SRC.read_text()
    assert int(re.search(r"constexpr int kMaxNq = (\d+);", src).group(1)) == inner_mod.MAX_NQ
    cases = sorted(int(c) for c in re.findall(r"case (\d+): launch_nq<\1>", src))
    assert cases == list(range(inner_mod.MAX_ORDER + 1))
    assert "launch<L, 16>" in src  # the deck default nq has its unrolled instance


@pytest.mark.parametrize("t,s", [(0, 7), (4, 0)])
def test_group_moments_of_empty_inputs(t, s):
    rng = np.random.default_rng(t + s)
    panels = [torch.as_tensor(rng.uniform(0.1, 0.5, size=(t, s))) for _ in range(4)]
    kin = torch.as_tensor(rng.uniform(1.0, 2.0, size=(t, 4)))
    valid_e = torch.ones(t, dtype=torch.bool)
    bounds = torch.as_tensor(np.geomspace(1.0, 10.0, 6))
    out = twobody_group_moments(*panels, kin, valid_e, bounds, 3, 8, True)
    assert out.shape == (t, 4, 5) and out.dtype == torch.float64
    assert not out.any()


def test_bound_counts_what_the_data_needs():
    """chip_smoke.bound on a hand-counted case: row 0 above threshold with two
    live subintervals (one outside the table), row 1 below threshold."""
    mid = torch.tensor([[-0.5, 0.0, 0.5], [-0.5, 0.0, 0.5]], dtype=torch.float64)
    half = torch.tensor([[0.1, 0.0, 0.2], [0.1, 0.1, 0.1]], dtype=torch.float64)
    kin = torch.tensor([[2.0, 1.0, 1.0, 0.5], [2.0, 1.0, 1.0, 0.5]], dtype=torch.float64)
    valid_e = torch.tensor([True, False])
    bounds = torch.tensor([1.0, 2.0, 2.4], dtype=torch.float64)  # E'_lab(mid) of row 0: 1.5, 2.0, 2.5
    args = (mid, half, half.clone(), half.clone(), kin, valid_e, bounds)
    order, nq = 2, 4
    nbytes = 2 * 4 * 8 + 2 + 3 * 8 + 1 * 3 * 8 + 3 * 2 * 8 + 2 * (order + 1) * 2 * 8
    per_node = 15 + 2 + 6 * (order - 1)
    for clamp, inside in ((True, 2), (False, 1)):
        flops = inside * (nq * per_node + 2 * (order + 1)) + 2 * 2
        ms, side = chip_smoke.bound(args, order, nq, clamp)
        expect_b, expect_f = nbytes / chip_smoke.HBM_BYTES_PER_S, flops / chip_smoke.FP64_FLOPS_PER_S
        assert ms == pytest.approx(max(expect_b, expect_f) * 1e3, rel=1e-12)
        assert side == ("bytes" if expect_b >= expect_f else "operations")


@pytest.mark.parametrize("band,clamp", [(0, True), (chip_smoke.BAND, True), (0, False)])
def test_chip_smoke_inputs_fit_the_kernel_contract(band, clamp):
    """The kernel phase's inputs, built on the CPU at a few rows, pass the
    wrapper's checks and give the plain version's result."""
    args = chip_smoke.bench_inputs(torch.device("cpu"), band, clamp, n_rows=12)
    mid, half, a_s, b_s, kin, valid_e, bounds = args
    assert mid.shape[0] == kin.shape[0] == valid_e.shape[0] == 12
    assert bounds.shape == ((12, band + 1) if band else (chip_smoke.KERNEL_SHAPE["groups"] + 1,))
    elab = kin[:, 0:1] + kin[:, 1:2] * mid
    assert bool((elab[:, 1:] >= elab[:, :-1]).all())  # non-decreasing: each group is one run
    out = twobody_group_moments(*args, 2, 8, clamp)
    torch.testing.assert_close(out, twobody_group_moments_ref(*args, 2, 8, clamp), rtol=0, atol=0)
