"""The port's band subsets and their dispatch (ndpp_tpu_torch/banding.py).

banding.subsets splits a dispatch set into its banded (narrow) rows and its
dense (wide) rows; banding.dispatch runs an op over each subset on one or
more shards and densifies what comes back into the caller's rows.
"""

from __future__ import annotations

import numpy as np
import pytest

from ndpp_tpu_torch import banding, groups
from ndpp_tpu_torch.parallel import rows as rows_mod


def _narrow_wide_rows():
    """Rows 0 and 2 span a few groups of the 361-group structure, row 1 all of it."""
    bounds = groups.get("uniform-lethargy-361").bounds
    lo = np.array([1e3, bounds[1], 2e5])
    hi = np.array([2e3, bounds[-2], 3e5])
    return bounds, banding.partition(lo, hi, bounds)


def test_band_subsets_split_narrow_from_wide_rows():
    bounds, part = _narrow_wide_rows()
    ng = bounds.size - 1
    (nidx, b_w, g0, win), (didx, gw, g0_dense, win_dense) = banding.subsets(part, 3, bounds)
    assert nidx.tolist() == [0, 2] and didx.tolist() == [1]
    assert b_w < ng and g0.tolist() == part[2][[0, 2]].tolist()
    np.testing.assert_array_equal(win, banding.window_bounds(bounds, g0, b_w))
    assert (gw, g0_dense, win_dense) == (ng, None, None)
    # every row narrow: the banded subset alone
    narrow_only = (np.ones(3, bool), part[1], part[2])
    assert [s[0].tolist() for s in banding.subsets(narrow_only, 3, bounds)] == [[0, 1, 2]]


def test_band_subsets_without_a_partition_are_one_dense_subset():
    bounds = groups.get("uniform-lethargy-361").bounds
    ((idx, gw, g0, win),) = banding.subsets(None, 5, bounds)
    assert idx.tolist() == list(range(5)) and gw == bounds.size - 1 and g0 is None and win is None


@pytest.mark.parametrize("nd", [1, 4])
def test_band_dispatch_densifies_each_subset_into_out(nd):
    """A toy op returns each group's lower boundary over the window it is
    handed: banded rows land inside their window, dense rows everywhere."""
    bounds, part = _narrow_wide_rows()
    place = rows_mod.Placement(["cpu"] * nd)
    shared = place.put_replicated(bounds)
    out = np.full((3, 2, bounds.size - 1), np.nan)
    windows = []

    def op(piece, x, win):
        windows.append(None if win is None else tuple(win.shape))
        lower = shared[piece.k][:-1].expand(piece.length, -1) if win is None else win[:, :-1]
        return (x[:, :, None] * lower[:, None, :]).contiguous()

    banding.dispatch(place, part, bounds, 16, 512, out, op, np.ones((3, 2)), family="toy")
    b_w, g0 = part[1], part[2]
    for r in (0, 2):
        want = np.zeros(bounds.size - 1)
        want[g0[r] : g0[r] + b_w] = bounds[g0[r] : g0[r] + b_w]
        np.testing.assert_array_equal(out[r], np.stack([want, want]))
    np.testing.assert_array_equal(out[1], np.stack([bounds[:-1]] * 2))
    assert None in windows and any(w is not None and w[1] == b_w + 1 for w in windows)
