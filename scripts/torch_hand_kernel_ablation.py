"""Where the free-gas and CM kernels' redesign gains, by ablation, on one card.

    python3 scripts/torch_hand_kernel_ablation.py --parent DIR [--out FILE]

DIR holds an earlier checkout's ndpp_tpu_torch/csrc/freegas_sab.cu and
cm_pointwise.cu with their first launch contracts (the kernels of fb7093a,
one lane per point, no lanes argument); unpack them with
``git archive fb7093a ndpp_tpu_torch/csrc | tar -x -C DIR``. The script builds
those, this checkout's sources as they are, and copies of them with one
design choice taken back (edits of the source text; each must apply, or the
script stops), all with this checkout's nvcc flags and in parallel. Each
edited copy is timed at one lane a point:

  free-gas (csrc/freegas_sab.cu):
    - ``earlier``:    the earlier kernel;
    - ``no_table``:   every u-panel takes one exp per node (no fixed-ladder table);
    - ``lane_table``: each lane takes the table on its own table panels, not
                      only when its whole warp does (the two node loops then
                      split warps);
    - ``no_rsqrt``:   1/sqrt(d) by a square root and a division, not rsqrt;
    - ``unroll1``:    the node loops not unrolled (4 times as they are);
  CM (csrc/cm_pointwise.cu):
    - ``earlier``:    the earlier kernel;
    - ``divisions``:  mu_lab, mu_cm, t_e and t_m by divisions, as in the earlier kernel;
    - ``no_buckets``: 11 sums for every order (the L = 10 instance);
    - ``no_bounds``:  __launch_bounds__ without its blocks per SM;
    - ``unroll4``:    the node loop unrolled 4 times (not at all as it is);
  both: ``G=1`` (this checkout, one lane per point) and ``kernel`` (this
  checkout, the lanes its wrapper chooses; on tiles where that is 1 the two
  are the same build).

On chip_smoke.py's tiles (free-gas: 256 and 7 h1 rows at 293.6 K, P5; CM:
the kalbach, law61cm and nbody tiles at 256 and 16 rows, P5) it checks each
build against the plain version (|k - p| <= 1e-12 max_row |p|) and times
them all by CUDA events around CUDA-graph replays, in turns. It prints one
JSON line (also written to --out, if given) with the medians in ms, each
build's registers for the P5 instance (ptxas) and build seconds, and the
card's name and power limit. It needs a CUDA card and nvcc, and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (tiles, timing in turns, ptxas parsing)

FG_EDITS = {
    "no_table": [("    const bool table_panel = k0 >= 0 && k1 == k0 + 1;", "    const bool table_panel = false;")],
    "lane_table": [("    const bool warp_table = __all_sync(0xffffffffu, table_panel || !live);",
                    "    const bool warp_table = table_panel;")],
    "no_rsqrt": [("  const double r = rsqrt_normal(d);", "  const double r = 1.0 / sqrt(d);")],
    "unroll1": [("#pragma unroll 4\n  for (int j = 0; j < kNqU / G; ++j) {  // node loop",
                 "#pragma unroll 1\n  for (int j = 0; j < kNqU / G; ++j) {  // node loop")],
}
CM_EDITS = {
    "divisions": [
        ("clip((n.wps2 - x) * n.inv_lab, -1.0, 1.0)", "clip((n.wps2 - x) / n.lab_den, -1.0, 1.0)"),
        ("(n.wms2 - x) * rcp_normal(fmax(n.two_s * y, 1e-30))", "(n.wms2 - x) / fmax(n.two_s * y, 1e-30)"),
        ("clip((x - ek0) * inv_ekw, 0.0, 1.0)", "clip((x - ek0) / ek_w, 0.0, 1.0)"),
        ("clip((mu - mk0) * inv_mkw, 0.0, 1.0)", "clip((mu - mk0) / mk_w, 0.0, 1.0)"),
    ],
    "no_buckets": [("  const int lb = bucket(p.order);", "  const int lb = kMaxL;")],
    "no_bounds": [("__launch_bounds__(kThreads, min_blocks(ANG, NBODY, LB, G))", "__launch_bounds__(kThreads)")],
    "unroll4": [("#pragma unroll 1  // node loop", "#pragma unroll 4  // node loop")],
}


def edited(src: Path, edits, out: Path) -> Path:
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"ablation edit does not apply to {src.name}: {old!r}")
        text = text.replace(old, new)
    out.write_text(text)
    return out


def load(path: Path, fn_name: str, argtypes) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="directory holding the earlier ndpp_tpu_torch/csrc")
    ap.add_argument("--out", type=Path, help="also write the JSON line to this file")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_hand_kernel_ablation: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    from ndpp_tpu_torch.ops import continuum as cont_ops
    from ndpp_tpu_torch.ops import freegas as fg
    from ndpp_tpu_torch.ops.legendre import gl_nodes_weights
    from ndpp_tpu_torch.utils.build import NVCC_FLAGS, build_cuda, build_dir

    work = build_dir() / "ablation"
    work.mkdir(parents=True, exist_ok=True)
    sources = {("fg", "earlier"): a.parent / "ndpp_tpu_torch" / "csrc" / "freegas_sab.cu",
               ("cm", "earlier"): a.parent / "ndpp_tpu_torch" / "csrc" / "cm_pointwise.cu",
               ("fg", "this"): fg._SRC, ("cm", "this"): cont_ops._SRC}  # this checkout's, as the wrappers build them
    for name, edits in FG_EDITS.items():
        sources[("fg", name)] = edited(fg._SRC, edits, work / f"freegas_sab_{name}.cu")
    for name, edits in CM_EDITS.items():
        sources[("cm", name)] = edited(cont_ops._SRC, edits, work / f"cm_pointwise_{name}.cu")
    with ThreadPoolExecutor(len(sources)) as ex:
        futures = {key: ex.submit(build_cuda, src, NVCC_FLAGS) for key, src in sources.items()}
        built = {key: f.result() for key, f in futures.items()}

    fg_new = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7
    fg_old = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7
    cm_new = ([ctypes.c_void_p] * 9 + [ctypes.c_double] + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3
              + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    cm_old = ([ctypes.c_void_p] * 9 + [ctypes.c_double] + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3
              + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    libs = {}
    for (kind, name), (path, _) in built.items():
        new = name != "earlier"
        libs[(kind, name)] = load(path, "freegas_sab_launch" if kind == "fg" else "cm_inner_launch",
                                  (fg_new if new else fg_old) if kind == "fg" else (cm_new if new else cm_old))

    def through(kind, name, call):
        """call() with the wrapper's library swapped for the build (kind, name)."""
        mod, attr = (fg, "_sab_library") if kind == "fg" else (cont_ops, "_cm_library")
        saved = getattr(mod, attr)
        setattr(mod, attr, lambda: libs[(kind, name)])
        try:
            return call()
        finally:
            setattr(mod, attr, saved)

    def fg_earlier(pm, ph, v, awr, kt, order):
        tt, npan = pm.shape
        out = torch.empty((tt, npan, fg.NQ_G, order + 1), dtype=torch.float64, device=pm.device)
        xg, _ = gl_nodes_weights(fg.NQ_G)
        xu, wu = gl_nodes_weights(fg.NQ_U)
        rc = libs[("fg", "earlier")].freegas_sab_launch(
            *(x.data_ptr() for x in (pm, ph, v, awr, kt)), tt, npan, fg.NQ_G, order,
            *(x.ctypes.data for x in (xg, xu, wu, fg._SAB_ULAD, fg._SAB_CLAD)), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier freegas_sab_launch: cudaError {rc}")
        return out

    def cm_earlier(w, s, yk, e_knots, payload, mu_knots, mu_pdf, emax, c_norm, expo, order, nq_y, angular, energy, ksel):
        tt, nw = w.shape
        ke = yk.shape[1]
        out = torch.empty((tt, nw, order + 1), dtype=torch.float64, device=w.device)
        xy, wy = gl_nodes_weights(nq_y)
        staged = ctypes.c_int(0)
        rc = libs[("cm", "earlier")].cm_inner_launch(
            *(0 if x is None else x.data_ptr() for x in (w, s, yk, e_knots, payload, mu_knots, mu_pdf, emax, c_norm)),
            float(expo), tt, nw, ke, 0 if mu_knots is None else mu_knots.shape[0], ksel if 0 < ksel < ke else ke,
            cont_ops.ANGULAR.index(angular), cont_ops.ENERGY.index(energy), order, nq_y, xy.ctypes.data,
            wy.ctypes.data, out.data_ptr(), ctypes.byref(staged), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier cm_inner_launch: cudaError {rc}")
        return out

    dev = torch.device("cuda", 0)
    order = chip_smoke.KERNEL_SHAPE["order"]
    times, errors, lanes = {}, {}, {}
    for n_rows in (chip_smoke.FREEGAS_ROWS, chip_smoke.FREEGAS_DECK_ROWS):
        e, awr, kt, window = chip_smoke.freegas_inputs(dev, n_rows)
        v = torch.sqrt(e).contiguous()
        a_r, k_r = fg._per_row(awr, e).contiguous(), fg._per_row(kt, e).contiguous()
        panels = {}

        def gvals(pm, ph):
            panels.update(pm=pm, ph=ph)
            return fg.sab_density_ref(pm, ph, v, a_r, k_r, order)

        fg._outgoing_panelsplit(e, v, a_r, k_r, window, order, fg.NQ_G, fg.NFILL_Y, gvals)
        args = (panels["pm"], panels["ph"], v, a_r, k_r, order)
        g = fg.sab_lanes(n_rows, args[0].shape[1], torch.cuda.get_device_properties(dev).multi_processor_count)
        fns = {"earlier": lambda: fg_earlier(*args)}
        fns.update({name: (lambda nm=name: through("fg", nm, lambda: fg.sab_density(*args, lanes=1)))
                    for name in FG_EDITS})
        fns["G=1"] = lambda: fg.sab_density(*args, lanes=1)
        if g != 1:
            fns["kernel"] = lambda: fg.sab_density(*args, lanes=g)
        tile = f"freegas@{n_rows}"
        ref = fg.sab_density_ref(*args)
        errors[tile] = {name: chip_smoke.row_rel_err(fn(), ref) for name, fn in fns.items()}
        times[tile] = chip_smoke.time_turns(fns, n=5, reps=3)
        lanes[tile] = g
        print(f"[ablation] {tile} G={g}: " + json.dumps({"ms": times[tile], "err": errors[tile]}), flush=True)
    for n_rows in (chip_smoke.CM_ROWS, chip_smoke.CM_DECK_ROWS):
        for fixture, (args, chunk) in chip_smoke.cm_tiles(dev, n_rows).items():
            g = cont_ops.cm_lanes(n_rows, args[0].shape[1], torch.cuda.get_device_properties(dev).multi_processor_count)
            fns = {"earlier": lambda a=args: cm_earlier(*a)}
            fns.update({name: (lambda nm=name, a=args: through("cm", nm, lambda: cont_ops.cm_inner_moments(*a, lanes=1)))
                        for name in CM_EDITS})
            fns["G=1"] = lambda a=args: cont_ops.cm_inner_moments(*a, lanes=1)
            if g != 1:
                fns["kernel"] = lambda a=args, g=g: cont_ops.cm_inner_moments(*a, lanes=g)
            tile = f"{fixture}@{n_rows}"
            ref = cont_ops.cm_inner_moments_ref(*args, chunk=chunk)
            errors[tile] = {name: chip_smoke.row_rel_err(fn(), ref) for name, fn in fns.items()}
            times[tile] = chip_smoke.time_turns(fns, n=5, reps=3)
            lanes[tile] = g
            print(f"[ablation] {tile} G={g}: " + json.dumps({"ms": times[tile], "err": errors[tile]}), flush=True)

    registers = {}
    for (kind, name), (path, seconds) in built.items():
        hot = [i for i in chip_smoke.ptxas_instances(path)
               if (i["kernel"] == "freegas_sab_kernel" and i["args"][0] == order)
               or (i["kernel"] == "cm_inner_kernel" and (len(i["args"]) == 3 or i["args"][3] == 5))]
        spills = {",".join(map(str, i["args"])): i["spill_bytes"] for i in chip_smoke.ptxas_instances(path)
                  if i["spill_bytes"]}
        registers[f"{kind}:{name}"] = {
            "build_s": seconds, "spills_by_instance": spills,
            "p5": {",".join(map(str, i["args"])): [i["registers"], chip_smoke.resident_warps(i["registers"])]
                   for i in hot},
        }
    bad = {t: {n: e for n, e in errs.items() if not e <= chip_smoke.HAND_RTOL} for t, errs in errors.items()}
    bad = {t: v for t, v in bad.items() if v}
    rec = {"card": smi, "timing": "cuda_graph_replay_x5_l2_warm", "ms": times, "max_rel_row_err": errors,
           "lanes": lanes, "registers_and_warps_per_sm": registers, "disagree": bad}
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
