"""Time the port's two-body kernel of an earlier checkout beside this one's, on one card.

    python3 scripts/torch_twobody_ab.py --parent DIR [--out FILE]

DIR is a checkout whose ndpp_tpu_torch/csrc/twobody_inner.cu still has the
inner-only entry point ``twobody_inner_launch`` (the kernel that wrote the
(T, L+1, S) subinterval moments, before the group reduction was fused into
it). It builds that source with this checkout's nvcc flags and, at
chip_smoke.py's bench shape (2048 fe56 rows, P5, 361 groups, nq 16) and at
the deck's tile size (the first 512 of those rows, on the same table and on
per-row B = 32 windows), checks that the old route (inner kernel, then the
torch epilogue ``twobody_scatter``) and the fused kernel give the same group
moments, then times with CUDA events around CUDA-graph replays, in turns:

  - ``old_inner``: the old inner kernel alone;
  - ``old_path``:  the old inner kernel followed by the torch epilogue;
  - ``fused``:     this checkout's ``twobody_group_moments``.

It prints one JSON line (also written to --out, if given) with the medians
in ms per shape, the card's name and power limit. It needs a CUDA card and
nvcc, and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (bench inputs and timing in turns)


def old_inner_kernel(parent: Path, build_dir: Path):
    """The parent's inner-only kernel as a callable (mid, half, a_s, b_s, kin,
    order, nq) -> (T, L+1, S), launched on the current stream."""
    import torch

    from ndpp_tpu_torch.ops import twobody_inner as inner_mod
    from ndpp_tpu_torch.utils.build import nvcc
    from ndpp_tpu_torch.ops.legendre import gl_nodes_weights

    src = parent / "ndpp_tpu_torch" / "csrc" / "twobody_inner.cu"
    if "twobody_inner_launch" not in src.read_text():
        raise SystemExit(f"{src} has no twobody_inner_launch entry point")
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / "twobody_inner_parent.so"
    flags = [f for f in inner_mod._NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([nvcc(), *flags, "-o", str(lib_path), str(src)], check=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.twobody_inner_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gl = {}

    def run(mid, half, a_s, b_s, kin, order, nq):
        if nq not in gl:
            gl[nq] = [torch.as_tensor(x, dtype=torch.float64, device=mid.device) for x in gl_nodes_weights(nq)]
        xq, wq = gl[nq]
        t, s = mid.shape
        out = torch.empty((t, order + 1, s), dtype=torch.float64, device=mid.device)
        rc = fn(
            *(x.data_ptr() for x in (mid, half, a_s, b_s, kin, xq, wq)), nq, t, s, order, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"parent twobody_inner_launch failed with cudaError {rc}")
        return out

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="checkout holding the inner-only kernel")
    ap.add_argument("--out", type=Path, help="also write the JSON line to this file")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_twobody_ab: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments, twobody_scatter

    order, nq = chip_smoke.KERNEL_SHAPE["order"], chip_smoke.KERNEL_SHAPE["nq"]
    old = old_inner_kernel(a.parent.resolve(), ROOT / "build" / "ab")
    rec = {"card": smi, "order": order, "nq": nq, "shapes": []}
    for rows, band in ((chip_smoke.KERNEL_SHAPE["rows"], 0), (512, 0), (512, chip_smoke.BAND)):
        args = chip_smoke.bench_inputs(torch.device("cuda", 0), band, True, rows)
        mid, half, a_s, b_s, kin, valid_e, bounds = args

        def old_inner(args=args):
            return old(*args[:5], order, nq)

        def old_path(args=args):
            mid, half, a_s, b_s, kin, valid_e, bounds = args
            return twobody_scatter(old_inner(args), mid, half, kin[:, 0], kin[:, 1], valid_e, bounds, True)

        def fused(args=args):
            return twobody_group_moments(*args, order, nq, True)

        new, ref = fused(), old_path()
        torch.cuda.synchronize()
        ms = chip_smoke.time_turns({"old_inner": old_inner, "old_path": old_path, "fused": fused})
        rec["shapes"].append({
            "rows": rows, "subintervals": mid.shape[1], "groups": bounds.shape[-1] - 1, "banded": band > 0,
            "max_abs_fused_vs_old_path": float((new - ref).abs().max()), "ms": ms,
        })
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
