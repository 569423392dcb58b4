"""The work a hand kernel's calls need, counted from the problem: the rows,
their angular tables, the group structure and the quadrature the algorithm
needs for those inputs. Never from the kernel's launch arguments, so a later
implementation of the same call is held to the same work.

Each input byte is read once and each output moment written once; where a
row's result is zero outside a band of groups, only the band is counted.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def peaks_for(device_name: str) -> dict:
    for key, val in PEAKS.items():
        if key != "about" and key in device_name:
            return val
    raise KeyError(f"no peaks for device {device_name!r} in benchmark/peaks.json")


def bound_seconds(flops: float, nbytes: float, peaks: dict) -> tuple[float, str]:
    """The least time the card could take: the larger of the two sides."""
    t_mem = nbytes / peaks["hbm_bytes_per_s"]
    t_ops = flops / peaks["fp64_flops_per_s"]
    return (t_ops, "fp64") if t_ops >= t_mem else (t_mem, "bytes")


def twobody_row_work(e, knots, pdf, c1, c2, awr, bounds, order: int, nq: int, clamp: bool):
    """(flops, bytes) of the two-body group moments of these rows.

    A row above threshold integrates p(mu) P_l(mu_lab) over [-1, 1] cut at
    its pdf's interior knots and at the group boundaries its lab energies
    cross: S = 1 + knots + boundaries panels, nq nodes each. Per node 15
    flops of kinematics, pdf and weight (an FMA 2, a min, max or rsqrt 1),
    2 for P_1 and 6 for each Bonnet step after it; per panel 2(L+1) to scale
    and sum and 2 for its lab energy. Bytes: e, c1, c2, awr and the row's
    knots and pdf values read, the (L+1) x band moments written, where the
    band is the groups the row reaches. A row below threshold is zero: its
    e is read and nothing written."""
    e = np.asarray(e, dtype=np.float64)
    knots = np.asarray(knots, dtype=np.float64)
    pdf = np.asarray(pdf, dtype=np.float64)
    ecm = c2 * (e - c1)
    live = ecm > 0
    ecm = np.where(live, ecm, 0.0)
    base = ecm + e / (awr + 1.0) ** 2
    slope = 2.0 * np.sqrt(e * ecm) / (awr + 1.0)
    inner = bounds[1:-1] if clamp else bounds
    n_brk = np.searchsorted(inner, base + slope, side="left") - np.searchsorted(inner, base - slope, side="right")
    n_brk = np.maximum(n_brk, 0)
    new_knot = np.ones_like(knots, dtype=bool)
    new_knot[:, 1:] = knots[:, 1:] != knots[:, :-1]
    k_inner = ((knots > -1.0) & (knots < 1.0) & new_knot).sum(axis=1)
    real = np.ones_like(knots, dtype=bool)
    real[:, 1:] = (knots[:, 1:] != knots[:, :-1]) | (pdf[:, 1:] != pdf[:, :-1])
    k_real = real.sum(axis=1)
    panels = np.where(live, 1 + k_inner + n_brk, 0)
    per_node = 15 + (2 + 6 * (order - 1) if order >= 1 else 0)
    flops = float(np.sum(panels * (nq * per_node + 2 * (order + 1) + 2)))
    nbytes = float(8 * (4 * e.size + np.sum(np.where(live, 2 * k_real + (order + 1) * (n_brk + 1), 0))))
    return flops, nbytes


def twobody_call_work(preps, bounds, order: int, nq: int, clamp: bool) -> tuple[float, float]:
    """Work of one pooled two-body dispatch (its TwoBodyPrepared rows)."""
    flops = nbytes = 0.0
    for p in preps:
        f, b = twobody_row_work(p.e, p.knots, p.pdf, p.c1, p.c2, p.awr, bounds, order, nq, clamp)
        flops += f
        nbytes += b
    return flops, nbytes
