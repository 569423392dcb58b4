"""Where the fused two-body kernel's time goes, by ablation, on one card.

    python3 scripts/torch_twobody_ablation.py [--out FILE]

Builds ndpp_tpu_torch/csrc/twobody_inner.cu as it is and copies of it with
one part taken out or swapped (edits of the source text; each must apply,
or the script stops), then times every build at chip_smoke.py's bench shape
(2048 fe56 rows, P5, nq 16) on the dense 361-group table and on per-row
B = 32 windows, by CUDA events around CUDA-graph replays, in turns:

  - ``kernel``:          the source as it is;
  - ``no_quadrature``:   a live subinterval contributes h*a+b, no GL sum;
  - ``no_classify``:     every live subinterval goes to group 0 or 1;
  - ``no_zero_fill``:    neither rows below threshold nor empty groups are
                         written (only the run sums);
  - ``cuda_rsqrt``:      CUDA's rsqrt (with its slow-path branch) in place
                         of the branch-free one;
  - ``row_blocks``:      consecutive rows in one block instead of rows
                         interleaved over blocks.

Only ``kernel`` is checked against the plain version; the others compute
something else and exist to be timed. It prints one JSON line (also written
to --out, if given) with the medians in ms and the card's name and power
limit. It needs a CUDA card and nvcc, and exits non-zero without one.
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

# name -> [(text in the kernel source, replacement)]
ABLATIONS = {
    "kernel": [],
    "no_quadrature": [(
        "      if (g >= 0 && g < n_groups) quadrature<L, NQ>(m, h, a, b, k, nq, rule, v);",
        "      v[0] = h * a + b;",
    )],
    "no_classify": [(
        "      g = group_of(__dadd_rn(k.base, __dmul_rn(k.slope, m)), bounds_row, n_groups, clamp != 0);",
        "      g = m > 0.0 ? 1 : 0;",
    )],
    "no_zero_fill": [
        ("    for (int i = lane; i < (L + 1) * n_groups; i += 32) orow[i] = 0.0;\n", ""),
        ("  unsigned pending = __ballot_sync(kFull, lo < hi);", "  return;\n  unsigned pending = __ballot_sync(kFull, lo < hi);"),
        ("    for (int g = max(carry_g + 1, 0) + lane; g < n_groups; g += 32) orow[l * n_groups + g] = 0.0;", "    ;"),
    ],
    "cuda_rsqrt": [("* rsqrt_normal(elab)", "* rsqrt(elab)")],
    "row_blocks": [(
        "  const int t = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;",
        "  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);",
    )],
}


def build_all(build_dir: Path) -> dict:
    from ndpp_tpu_torch.ops import twobody_inner as inner_mod
    from ndpp_tpu_torch.utils.build import nvcc

    src = inner_mod._SRC.read_text()
    flags = [f for f in inner_mod._NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the kernel source no longer holds {old.strip()!r} once")
            text = text.replace(old, new)
        cu = build_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [nvcc(), *flags, "-o", str(build_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():  # one nvcc per source, all started together
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{err[-4000:]}")
    return {name: build_dir / f"{name}.so" for name in ABLATIONS}


def launcher(path: Path, args, order: int, nq: int, clamp: bool):
    """A call of the group kernel in the library at `path` on `args`."""
    import torch

    from ndpp_tpu_torch.ops.legendre import gl_nodes_weights
    from ndpp_tpu_torch.ops.twobody_inner import bind

    fn = bind(ctypes.CDLL(str(path))).twobody_group_launch
    mid, half, a_s, b_s, kin, valid_e, bounds = args
    t, s = mid.shape
    ng = bounds.shape[-1] - 1
    xq, wq = gl_nodes_weights(nq)
    stride = 0 if bounds.dim() == 1 else bounds.stride(0)
    ptrs = [x.data_ptr() for x in (mid, half, a_s, b_s, kin, valid_e.view(torch.uint8), bounds)]

    def run():
        out = torch.empty((t, order + 1, ng), dtype=torch.float64, device=mid.device)
        rc = fn(*ptrs, stride, ng, int(clamp), order, nq, xq.ctypes.data, wq.ctypes.data, t, s, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{path.name}: launch failed with cudaError {rc}")
        return out

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the JSON line to this file")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_twobody_ablation: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments_ref

    libs = build_all(ROOT / "build" / "ablation")
    order, nq, clamp = chip_smoke.KERNEL_SHAPE["order"], chip_smoke.KERNEL_SHAPE["nq"], True
    rec = {"card": smi, "order": order, "nq": nq, "ms": {}}
    for label, band in (("dense", 0), (f"banded_B{chip_smoke.BAND}", chip_smoke.BAND)):
        args = chip_smoke.bench_inputs(torch.device("cuda", 0), band, clamp)
        fns = {name: launcher(path, args, order, nq, clamp) for name, path in libs.items()}
        err = float((fns["kernel"]() - twobody_group_moments_ref(*args, order, nq, clamp)).abs().max())
        if err > chip_smoke.ATOL:
            raise SystemExit(f"{label}: the kernel as built here is off its plain version by {err}")
        rec["ms"][label] = chip_smoke.time_turns(fns)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
