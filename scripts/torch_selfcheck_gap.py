"""Where selfcheck's two-body gap comes from: the kernel and its plain
version, each against an exact sum of the same subinterval moments.

    python scripts/torch_selfcheck_gap.py [--device cuda|cpu] [--tile 2048] [--out FILE]

On selfcheck's production batch (ndpp_tpu_torch.selfcheck.production_inputs:
2048 rows, K 48, P5, 361 groups, nq 16) it computes the subinterval moments
of the plain inner stage (twobody_inner_ref, float64 on the device) and sums
them into their groups on the host in long double (np.add.at, the group of
each live subinterval as segment_group_sum assigns it, clamp on). That sum
has no roundoff of its own beyond the inner stage's, so it shows how much
of the kernel-vs-plain difference each side brings: the kernel's segmented
scan or the plain version's differences of cumulative sums. Errors are
selfcheck's metric (max abs, and max relative to max(|exact|, 1e-6)). The
worst element of kernel against plain is located by its row's AWR, level
kinematics (c1 != 0) and pdf kind (smooth, step, peaked by row % 3), and the
worst relative difference is also given for each of those classes.

On cuda it runs the hand-written kernel; on cpu only the plain version (a
rehearsal: no device number). Prints one JSON line; --out keeps a copy.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ndpp_tpu_torch.driver import resolve_device  # noqa: E402
from ndpp_tpu_torch.ops.segment import effective_bounds  # noqa: E402
from ndpp_tpu_torch.ops.twobody import twobody_panels  # noqa: E402
from ndpp_tpu_torch.ops.twobody_inner import (  # noqa: E402
    twobody_group_moments,
    twobody_group_moments_ref,
    twobody_inner_ref,
)
from ndpp_tpu_torch.selfcheck import PROD_NQ, PROD_ORDER, production_inputs  # noqa: E402

FLOOR = 1e-6
KINDS = ("smooth", "step", "peaked")


def exact_group_sums(m, mid, half, kin, valid_e, bounds) -> np.ndarray:
    """(T, L+1, G) long-double sums of the live subintervals' moments m
    (T, L+1, S) into the group of E'_lab(mid), clamp on."""
    elab = (kin[:, 0:1] + kin[:, 1:2] * mid).contiguous()
    eff = effective_bounds(bounds, True)
    g = (torch.searchsorted(eff.contiguous(), elab, right=True) - 1).clamp_(0, bounds.shape[-1] - 2)
    live = ((half > 0) & valid_e[:, None]).cpu().numpy()
    m_h = m.cpu().numpy().astype(np.longdouble)
    g_h = g.cpu().numpy()
    t, lp1, _ = m_h.shape
    out = np.zeros((t, lp1, bounds.shape[-1] - 1), dtype=np.longdouble)
    rows, cols = np.nonzero(live)
    for l in range(lp1):
        np.add.at(out[:, l, :], (rows, g_h[rows, cols]), m_h[rows, l, cols])
    return out


def errs(got: np.ndarray, ref: np.ndarray) -> dict:
    a = np.abs(got.astype(np.longdouble) - ref)
    r = a / np.maximum(np.abs(ref), FLOOR)
    return {"max_abs": float(a.max()), "max_rel": float(r.max())}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tile", type=int, default=2048)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    dev = resolve_device(args.device)
    order, nq = PROD_ORDER, PROD_NQ
    e0, (knots, pdf, bounds, c1, c2, awr) = production_inputs(args.tile, device=dev)
    mid, half, a_s, b_s, base, slope, ecm, e_safe, ap1, valid_e = twobody_panels(
        e0, knots, pdf, bounds, c1, c2, awr, True
    )
    kin = torch.stack([base, slope, torch.sqrt(ecm), torch.sqrt(e_safe) / ap1], dim=1)
    call = (mid, half, a_s, b_s, kin, valid_e, bounds, order, nq, True)
    plain = twobody_group_moments_ref(*call).cpu().numpy()
    exact = exact_group_sums(twobody_inner_ref(mid, half, a_s, b_s, kin, order, nq), mid, half, kin, valid_e, bounds)
    report = {
        "device": str(dev),
        "shape": {"tile": args.tile, "order": order, "groups": bounds.shape[0] - 1, "nq": nq, "S": mid.shape[1]},
        "plain_vs_exact": errs(plain, exact),
    }
    if dev.type == "cuda":
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        kernel = twobody_group_moments(*call).cpu().numpy()
        report["kernel_vs_exact"] = errs(kernel, exact)
        report["kernel_vs_plain"] = errs(kernel, plain.astype(np.longdouble))
        rel = np.abs(kernel - plain) / np.maximum(np.abs(plain), FLOOR)
        t, l, g = np.unravel_index(np.argmax(rel), rel.shape)
        awr_h, c1_h = awr.cpu().numpy(), c1.cpu().numpy()
        report["worst"] = {
            "row": int(t), "l": int(l), "g": int(g), "awr": float(awr_h[t]), "level": bool(c1_h[t] != 0.0),
            "pdf": KINDS[t % 3], "plain": float(plain[t, l, g]), "kernel": float(kernel[t, l, g]),
            "exact": float(exact[t, l, g]), "row_p0_sum": float(plain[t, 0].sum()),
        }
        by_row = rel.reshape(rel.shape[0], -1).max(axis=1)
        rows = np.arange(rel.shape[0])
        classes = {
            "awr_below_2": awr_h < 2.0, "awr_2_and_above": awr_h >= 2.0,
            "level_c1_nonzero": c1_h != 0.0, "elastic_c1_zero": c1_h == 0.0,
            **{f"pdf_{k}": rows % 3 == i for i, k in enumerate(KINDS)},
        }
        report["kernel_vs_plain_max_rel_by_class"] = {k: float(by_row[m].max()) for k, m in classes.items()}
    line = json.dumps(report)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
