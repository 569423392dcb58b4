#!/usr/bin/env python
"""Library-scale run of the PyTorch/CUDA port (counterpart of scripts/scale_demo.py).

Builds a synthetic library with the port's own ACE writers (the 16 named
fixtures, then parametrized stress nuclides up to --nuclides, and the
bound-thermal tables), then runs the whole pipeline twice at the reference's
headline shape (P5, 361 groups, two temperatures, S(alpha,beta) on H-1):

  pass 1 (cold): the first pass of the process, which pays the CUDA
         kernel's build or load and every torch op's first use;
  pass 2 (warm): the same deck into a fresh output, in the same process.

Both passes run in ONE child process with the sweep watchdog armed
(device.watchdog_minutes). On a stall the watchdog exits the child with
utils.watchdog.EXIT_STALL (stack dump on stderr) and this supervisor
restarts it with --resume until both passes complete or --max-restarts is
spent; completed passes skip through the resume bookkeeping. Fewer than 16
--nuclides takes the first fixtures in name order.

Prints one ``SCALE {json}`` line per pass (wall, nuclides done and
quarantined, moments and moments/s, phase seconds, kernel launches, the
device) and a ``SCALE_SUMMARY {json}`` line; exits 3 if any nuclide was
quarantined. The library is ASCII by default (--format hdf5 needs h5py).
Usage:

    python3 scripts/torch_scale_demo.py [--nuclides 300] [--temps 293.6 600.0]
        [--order 5] [--groups uniform-lethargy-361] [--device cuda]
        [--max-devices 0] [--format ascii|hdf5] [--workdir build/torch_scale]
        [--e-tile 512] [--cold-only] [--resume] [--watchdog-minutes 25]
        [--max-restarts 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the sweep runs the tree this script sits in

from ndpp_tpu_torch.utils.watchdog import EXIT_STALL  # noqa: E402


def build_library(workdir: Path, n_total: int) -> Path:
    """The named fixtures, (n_total - 16) stress nuclides and the thermal
    tables under `workdir`, with their xsdir (kept across calls)."""
    from ndpp_tpu_torch.host.ace import synth
    from ndpp_tpu_torch.host.ace.thermal import write_thermal_ace
    from ndpp_tpu_torch.host.ace.write import write_ace

    workdir.mkdir(parents=True, exist_ok=True)
    xsdir = workdir / "xsdir"
    marker = workdir / f".complete_{n_total}"
    if xsdir.exists() and marker.exists():
        print(f"library already built in {workdir}", flush=True)
        return xsdir
    t0 = time.perf_counter()
    lines = []
    for key in sorted(synth.ALL_FIXTURES)[:n_total]:
        nuc = synth.build(key)
        p = write_ace(nuc, workdir / f"{key}.ace")
        lines.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    for i in range(max(n_total - len(lines), 0)):
        nuc = synth.stress_nuclide(i)
        p = write_ace(nuc, workdir / f"stress{i:03d}.ace")
        lines.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    for key in sorted(synth.THERMAL_FIXTURES):
        tab = synth.build_thermal(key)
        p = write_thermal_ace(tab, workdir / f"{key}.ace")
        lines.append(f"{tab.name} {tab.awr:.6f} {Path(p).name} 0 1 1 0")
    xsdir.write_text("directory\n" + "\n".join(lines) + "\n")
    for stale in workdir.glob(".complete_*"):
        stale.unlink()
    marker.touch()
    print(f"built {len(lines)}-entry library in {time.perf_counter() - t0:.1f} s -> {xsdir}", flush=True)
    return xsdir


def make_cfg(args, xsdir: Path, which: str, resume: bool):
    from ndpp_tpu_torch.config import RunConfig

    cfg = RunConfig(
        nuclides=[],  # every non-thermal entry of the index
        library=str(xsdir),
        groups=args.groups,
        legendre_order=args.order,
        temperatures=list(args.temps),
        sab={"1001.80c": ["lwtr.20t"]},
    )
    cfg.output.path = str(Path(args.workdir) / f"library_{which}.{'txt' if args.format == 'ascii' else 'h5'}")
    cfg.output.format = args.format
    cfg.device.watchdog_minutes = args.watchdog_minutes
    cfg.device.e_tile = args.e_tile
    cfg.device.max_devices = args.max_devices
    cfg.resume = resume
    cfg.validate()
    return cfg


def run_passes(args, passes: list[str], resume: bool) -> int:
    """Child mode: every pass in THIS process, one after the other. The armed
    watchdog may exit it with EXIT_STALL; on the supervisor's resumed
    restart, complete passes skip through in seconds."""
    import torch

    from ndpp_tpu_torch import driver
    from ndpp_tpu_torch.ops.continuum import cm_inner_moments
    from ndpp_tpu_torch.ops.freegas import sab_density
    from ndpp_tpu_torch.ops.twobody_inner import twobody_group_moments
    from ndpp_tpu_torch.utils import log as log_mod

    log_mod.setup(level=20)
    xsdir = build_library(Path(args.workdir), args.nuclides)
    device_name = torch.cuda.get_device_name(0) if args.device.startswith("cuda") else "cpu"
    rc = 0
    for which in passes:
        cfg = make_cfg(args, xsdir, which, resume)
        twobody_group_moments.launches = sab_density.launches = cm_inner_moments.launches = 0
        t0 = time.perf_counter()
        m = driver.run(cfg, device=args.device)
        wall = time.perf_counter() - t0
        row = {
            "pass": which,
            "wall_s": wall,
            "nuclides_done": m.nuclides_done,
            "quarantined": m.nuclides_quarantined,
            "moments": m.moments_computed,
            "moments_per_sec": m.moments_computed / max(wall, 1e-9),
            "padding_efficiency": m.padding_efficiency,
            "kernel_launches": twobody_group_moments.launches,
            "sab_density_launches": sab_density.launches,
            "cm_inner_launches": cm_inner_moments.launches,
            "device_mem_highwater_bytes": m.device_mem_highwater_bytes,
            "device": args.device,
            "device_name": device_name,
            "phase_seconds": {k: round(v, 3) for k, v in m.phase_seconds.items()},
        }
        print("SCALE " + json.dumps(row), flush=True)
        if m.nuclides_quarantined:
            rc = 3
    return rc


def supervise(args, passes: list[str], argv: list[str]) -> dict:
    """Parent mode: every pass in one child, restarted with --resume on a
    watchdog stall until done or --max-restarts is spent."""
    restarts = 0
    resume = args.resume
    rows: list[dict] = []
    t0 = time.perf_counter()
    while True:
        cmd = [sys.executable, __file__, *argv, "--child", ",".join(passes)]
        if resume:
            cmd.append("--resume")
        child = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
        assert child.stdout is not None
        for line in child.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            if line.startswith("SCALE "):
                rows.append(json.loads(line[len("SCALE ") :]))
        rc = child.wait()
        if rc == EXIT_STALL and restarts < args.max_restarts:
            restarts += 1
            resume = True
            print(f"SUPERVISOR: watchdog stall (exit {EXIT_STALL}) - restart {restarts}/{args.max_restarts} "
                  "with --resume", flush=True)
            continue
        break
    return {
        "rc": rc,
        "restarts": restarts,
        "wall_s_total": time.perf_counter() - t0,
        "nuclides_done_total": sum(r.get("nuclides_done", 0) for r in rows),
        "quarantined_total": sum(r.get("quarantined", 0) for r in rows),
        "segments": rows,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nuclides", type=int, default=300)
    ap.add_argument("--temps", type=float, nargs="+", default=[293.6, 600.0])
    ap.add_argument("--order", type=int, default=5)
    ap.add_argument("--groups", default="uniform-lethargy-361")
    ap.add_argument("--device", default="cuda", help="cuda (the first --max-devices cards), cuda:k or cpu")
    ap.add_argument("--max-devices", type=int, default=0, help="device.max_devices: cards the rows spread over (0 = all)")
    ap.add_argument("--format", default="ascii", choices=["ascii", "hdf5"])
    ap.add_argument("--workdir", default=str(ROOT / "build" / "torch_scale"))
    ap.add_argument("--e-tile", type=int, default=512)
    ap.add_argument("--cold-only", action="store_true")
    ap.add_argument("--resume", action="store_true", help="resume the cold pass")
    ap.add_argument("--watchdog-minutes", type=float, default=25.0)
    ap.add_argument("--max-restarts", type=int, default=20)
    ap.add_argument("--child", default=None, help="(internal) child mode: run these passes in-process")
    args = ap.parse_args()

    if args.child is not None:
        return run_passes(args, args.child.split(","), args.resume)

    # the child's argv from the parsed args (the supervisor owns --resume and --child)
    argv = [
        "--nuclides", str(args.nuclides),
        "--temps", *[str(t) for t in args.temps],
        "--order", str(args.order),
        "--groups", args.groups,
        "--device", args.device,
        "--max-devices", str(args.max_devices),
        "--format", args.format,
        "--workdir", args.workdir,
        "--e-tile", str(args.e_tile),
        "--watchdog-minutes", str(args.watchdog_minutes),
    ]
    build_library(Path(args.workdir), args.nuclides)  # once, host only
    passes = ["cold"] if args.cold_only else ["cold", "warm"]
    row = supervise(args, passes, argv)
    rc = row["rc"] if row["rc"] != 0 else (3 if row["quarantined_total"] else 0)
    print("SCALE_SUMMARY " + json.dumps(row), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
