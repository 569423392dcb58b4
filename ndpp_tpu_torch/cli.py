"""Command-line interface of the port (counterpart of ndpp_tpu/cli.py).

    python -m ndpp_tpu_torch run -c deck.toml [--device cuda|cpu] [-o key=value ...]
                                   [--workers N] [--debug-nans]
    python -m ndpp_tpu_torch fixtures --out DIR     synthetic ACE library (with thermal tables) + xsdir
    python -m ndpp_tpu_torch compare A B [--rtol 1e-8]
    python -m ndpp_tpu_torch merge DST SRC...      merge shard HDF5 libraries (needs h5py)
    python -m ndpp_tpu_torch info LIB              library summary (ASCII, or HDF5 with h5py)
    python -m ndpp_tpu_torch selfcheck [--device cuda|cpu] [--tile --order --nq]
    python -m ndpp_tpu_torch groups [NAME | import FILE [--name N] [--dir D]]

Installed, the same commands run as ``ndpp-torch``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ndpp_tpu_torch import config as config_mod
from ndpp_tpu_torch import groups as groups_mod
from ndpp_tpu_torch.utils import log as log_mod
from ndpp_tpu_torch.utils.errors import NdppError
from ndpp_tpu_torch.version import __version__


def _cmd_run(args) -> int:
    from ndpp_tpu_torch import driver

    cfg = config_mod.load(args.config)
    if args.override:
        config_mod.apply_overrides(cfg, args.override)
    if args.resume:
        cfg.resume = True
    if args.profile:
        cfg.device.profile = True
    if args.workers > 1:
        from ndpp_tpu_torch.parallel.nuclides import run_workers

        summary = run_workers(cfg, args.workers, device=args.device, debug_nans=args.debug_nans)
        print(json.dumps(summary))
        return 0 if all(rc == 0 for rc in summary["worker_rcs"].values()) else 3
    metrics = driver.run(cfg, device=args.device, debug_nans=args.debug_nans)
    print(metrics.json_line())
    return 0 if metrics.nuclides_quarantined == 0 else 3


def _cmd_merge(args) -> int:
    from ndpp_tpu_torch.io.library import merge_libraries

    n = merge_libraries(args.dst, args.srcs)
    print(f"merged {n} nuclides from {len(args.srcs)} shard(s) -> {args.dst}")
    return 0


def _cmd_fixtures(args) -> int:
    from ndpp_tpu_torch.host.ace import synth
    from ndpp_tpu_torch.host.ace.thermal import write_thermal_ace
    from ndpp_tpu_torch.host.ace.write import write_ace

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    lines = []
    for key in sorted(synth.ALL_FIXTURES):
        nuc = synth.build(key)
        path = out / f"{key}.ace"
        write_ace(nuc, path)
        lines.append(f"{nuc.name} {nuc.awr:.6f} {path.name} 0 1 1 0")
        print(f"wrote {path} ({nuc.name})")
    for i in range(args.stress):
        nuc = synth.stress_nuclide(i)
        path = out / f"stress{i:03d}.ace"
        write_ace(nuc, path)
        lines.append(f"{nuc.name} {nuc.awr:.6f} {path.name} 0 1 1 0")
        print(f"wrote {path} ({nuc.name}, NE={nuc.energy.size}, A={nuc.awr:.1f})")
    for key in sorted(synth.THERMAL_FIXTURES):
        tab = synth.build_thermal(key)
        path = out / f"{key}.ace"
        write_thermal_ace(tab, path)
        lines.append(f"{tab.name} {tab.awr:.6f} {path.name} 0 1 1 0")
        print(f"wrote {path} ({tab.name}, thermal)")
    (out / "xsdir").write_text("directory\n" + "\n".join(lines) + "\n")
    print(f"wrote {out / 'xsdir'} ({len(lines)} entries)")
    return 0


def _cmd_compare(args) -> int:
    from ndpp_tpu_torch.io.library import compare

    report = compare(args.a, args.b, rtol=args.rtol, atol=args.atol)
    worst = sorted(
        ((k, v) for k, v in report["datasets"].items() if "max_rel" in v),
        key=lambda kv: -kv[1]["max_rel"],
    )
    for k, v in worst[: args.top]:
        status = "ok " if v["ok"] else "FAIL"
        print(f"{status} {k}: max_rel={v['max_rel']:.3e} max_abs={v['max_abs']:.3e}")
    for m in report["missing"]:
        print(f"MISSING {m}")
    print(f"match={report['match']} (rtol={args.rtol})")
    return 0 if report["match"] else 1


def _cmd_info(args) -> int:
    import numpy as np

    from ndpp_tpu_torch.io.library import is_hdf5

    if not is_hdf5(args.library):
        from ndpp_tpu_torch.io.library import read_ascii

        datasets, attrs = read_ascii(args.library)
        print(f"format {attrs.get('format_version')} (ASCII) written by {attrs.get('generator')}")
        gb = datasets.get("/group_structure/bounds")
        print(f"groups: {attrs.get('group_structure_name')} ({gb.size - 1 if gb is not None else '?'} groups)")
        print(f"legendre_order: {attrs.get('legendre_order')}")
        print(f"temperatures: {[float(t) for t in datasets.get('/temperatures', [])]}")
        nucs = sorted({k.split("/")[2] for k in datasets if k.startswith("/nuclides/")})
        print(f"nuclides ({len(nucs)}):")
        for name in nucs:
            ne = datasets[f"/nuclides/{name}/energy"].size
            shape = datasets[f"/nuclides/{name}/scatter"].shape
            chi = " chi" if f"/nuclides/{name}/chi_prompt" in datasets else ""
            print(f"  {name:<14s} NE={ne:<7d} scatter{shape}{chi}")
        if "metrics" in attrs:
            print("metrics:", json.dumps(attrs["metrics"]))
        return 0

    import h5py

    with h5py.File(args.library, "r") as f:
        print(f"format {f.attrs.get('format_version')} written by ndpp-tpu {f.attrs.get('ndpp_tpu_version')}")
        gsg = f["group_structure"]
        print(f"groups: {gsg.attrs.get('name')} ({gsg['bounds'].shape[0] - 1} groups)")
        print(f"legendre_order: {f.attrs.get('legendre_order')}")
        print(f"temperatures: {list(np.asarray(f['temperatures']))}")
        nucs = f["nuclides"]
        print(f"nuclides ({len(nucs)}):")
        for name in sorted(nucs):
            g = nucs[name]
            ne = g["energy"].shape[0]
            shape = g["scatter"].shape
            chi = " chi" if "chi_prompt" in g else ""
            done = "complete" if g.attrs.get("complete") else "INCOMPLETE"
            print(f"  {name:<14s} NE={ne:<7d} scatter{shape}{chi} [{done}]")
        if "metrics" in f:
            print("metrics:", f["metrics"][()].decode() if isinstance(f["metrics"][()], bytes) else f["metrics"][()])
    return 0


def _cmd_selfcheck(args) -> int:
    from ndpp_tpu_torch import selfcheck

    report = selfcheck.run(tile=args.tile, order=args.order, nq=args.nq, device=args.device)
    print(json.dumps(report))
    for name in report["failed"]:
        leg = {k: v for k, v in report.items() if k.startswith("twobody_")} if name == "twobody" else report[name]
        print(f"selfcheck FAILED: {name}: {json.dumps(leg)}", file=sys.stderr)
    if "twobody" in report:
        print(f"selfcheck: two-body leg skipped on {report['device']}: {report['twobody']['skipped']}", file=sys.stderr)
    return 1 if report["failed"] else 0


def _cmd_groups(args) -> int:
    if args.name == "import":
        if not args.file:
            print("usage: ndpp-torch groups import <boundary-file> [--name NAME] [--dir DIR]")
            return 2
        g = groups_mod.import_table(args.file, args.import_name, args.import_dir)
        dest = groups_mod.user_groups_dir() if args.import_dir is None else args.import_dir
        print(f"imported '{g.name}': {g.ng} groups -> {dest}")
        for k, v in g.meta.items():
            print(f"  {k}: {v}")
        print(f"use it in a deck as: groups = \"{g.name}\"")
        return 0
    if args.name:
        g = groups_mod.get(args.name)
        print(f"# {g.name}: {g.ng} groups, checksum {g.checksum()}")
        for k, v in g.meta.items():
            print(f"# {k}: {v}")
        for b in g.bounds:
            print(f"{b:.12e}")
    else:
        for name in groups_mod.names():
            g = groups_mod.get(name)
            print(f"{name:<24s} {g.ng:>4d} groups  [{g.emin:.3e}, {g.emax:.3e}] eV")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="ndpp-torch", description="nuclear-data preprocessor on PyTorch/CUDA")
    p.add_argument("--version", action="version", version=f"ndpp-tpu-torch {__version__}")
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run preprocessing from an input deck")
    pr.add_argument("-c", "--config", required=True)
    pr.add_argument("-o", "--override", action="append", default=[], metavar="KEY=VALUE")
    pr.add_argument(
        "--device", default="cuda", help="cuda (default; raises without a card) or cpu (plain torch kernels)"
    )
    pr.add_argument("--resume", action="store_true", help="skip nuclides already complete in the output")
    pr.add_argument("--profile", action="store_true", help="write a torch.profiler chrome trace")
    pr.add_argument(
        "--debug-nans", action="store_true",
        help="check every family's results for NaN/Inf where they land; quarantine the nuclide naming the family",
    )
    pr.add_argument(
        "--workers",
        type=int,
        default=1,
        help="nuclide-axis process parallelism: N shard subprocesses (one card each) + HDF5 merge; needs h5py",
    )
    pr.set_defaults(fn=_cmd_run)

    pm = sub.add_parser("merge", help="merge shard HDF5 libraries into one (needs h5py)")
    pm.add_argument("dst")
    pm.add_argument("srcs", nargs="+")
    pm.set_defaults(fn=_cmd_merge)

    pf = sub.add_parser("fixtures", help="generate the synthetic ACE fixture library")
    pf.add_argument("--out", required=True)
    pf.add_argument("--stress", type=int, default=0, help="add N parametrized stress nuclides")
    pf.set_defaults(fn=_cmd_fixtures)

    pc = sub.add_parser("compare", help="compare two moment libraries (HDF5 or ASCII, any mix)")
    pc.add_argument("a")
    pc.add_argument("b")
    pc.add_argument("--rtol", type=float, default=1e-8)
    pc.add_argument("--atol", type=float, default=0.0)
    pc.add_argument("--top", type=int, default=20)
    pc.set_defaults(fn=_cmd_compare)

    pi = sub.add_parser("info", help="summarize a moment library (ASCII, or HDF5 with h5py)")
    pi.add_argument("library")
    pi.set_defaults(fn=_cmd_info)

    ps = sub.add_parser(
        "selfcheck",
        help="accuracy gate: the two-body kernel against its plain version and every family against an "
        "independent path, at production shapes",
    )
    ps.add_argument("--tile", type=int, default=2048)
    ps.add_argument("--order", type=int, default=5)
    ps.add_argument("--nq", type=int, default=16)
    ps.add_argument(
        "--device", default="cuda", help="cuda (default; raises without a card) or cpu (families only)"
    )
    ps.set_defaults(fn=_cmd_selfcheck)

    pg = sub.add_parser("groups", help="list group structures / dump boundaries / import a table")
    pg.add_argument("name", nargs="?", help="structure name to dump, or 'import'")
    pg.add_argument("file", nargs="?", help="boundary file for 'import' (one eV boundary per line)")
    pg.add_argument("--name", dest="import_name", default=None, help="installed name for 'import'")
    pg.add_argument("--dir", dest="import_dir", default=None, help="install dir (default NDPP_GROUPS_DIR)")
    pg.set_defaults(fn=_cmd_groups)

    args = p.parse_args(argv)
    log_mod.setup(level=10 if args.verbose else 20)
    try:
        return args.fn(args)
    except NdppError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
