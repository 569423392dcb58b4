"""All sixteen synthetic fixtures through both packages on the CPU, libraries compared.

    JAX_PLATFORMS=cpu python3 scripts/torch_parity_fixtures.py [--groups NAME] [--order L] [--out FILE]

Writes the fixture library (every entry of host/ace/synth.ALL_FIXTURES), runs
one deck over all of it (free-gas off) through the reference
(``ndpp_tpu.driver.run``, HDF5) and through the port
(``ndpp_tpu_torch.driver.run(cfg, device="cpu")``, ASCII), and holds the
port's library to the reference's with the reference's comparator at rtol
1e-8 and the smallest atol of 1e-14, 1e-13, 1e-12 that matches. It prints one
JSON line: nuclides done and quarantined on each side, the atol that held,
and per dataset kind the largest absolute difference. Exit code 1 if a
nuclide is quarantined or no atol up to 1e-12 matches. It needs jax (on the
CPU) and h5py, so it runs where the tests run, not on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", default="uniform-lethargy-47")
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--out", type=Path, help="also write the JSON line to this file")
    a = ap.parse_args()

    from ndpp_tpu import config as j_config
    from ndpp_tpu import driver as j_driver
    from ndpp_tpu.host.ace import synth
    from ndpp_tpu.host.ace.write import write_ace
    from ndpp_tpu.io.library import compare
    from ndpp_tpu_torch import driver as t_driver
    from ndpp_tpu_torch.interop import config_from_dict

    with tempfile.TemporaryDirectory(prefix="ndpp_parity_") as work:
        work = Path(work)
        lines, names = [], []
        for key in synth.ALL_FIXTURES:
            nuc = synth.build(key)
            p = write_ace(nuc, work / f"{key}.ace")
            lines.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
            names.append(nuc.name)
        (work / "xsdir").write_text("directory\n" + "\n".join(lines) + "\n")
        cfg = j_config.RunConfig(
            nuclides=names, library=str(work / "xsdir"), groups=a.groups, legendre_order=a.order,
            freegas_for=["none"],
        )
        cfg.output.path = str(work / "ref.h5")
        cfg.device.max_devices = 1
        cfg.device.watchdog_minutes = 0
        cfg.validate()
        ref = j_driver.run(cfg)
        port_cfg = config_from_dict(cfg.to_dict())
        port_cfg.output.path = str(work / "port.txt")
        port_cfg.output.format = "ascii"
        got = t_driver.run(port_cfg, device="cpu")
        held = None
        for atol in (1e-14, 1e-13, 1e-12):
            report = compare(work / "ref.h5", work / "port.txt", rtol=1e-8, atol=atol)
            if report["match"]:
                held = atol
                break
    worst: dict[str, float] = {}
    for path, v in report["datasets"].items():
        kind = path.rsplit("/", 1)[-1]
        worst[kind] = max(worst.get(kind, 0.0), v.get("max_abs", float("inf")))
    rec = {
        "fixtures": len(names), "groups": a.groups, "order": a.order,
        "reference": {"done": ref.nuclides_done, "quarantined": ref.nuclides_quarantined},
        "port_cpu": {"done": got.nuclides_done, "quarantined": got.nuclides_quarantined},
        "rtol": 1e-8, "atol_that_matches": held, "missing": report["missing"], "max_abs_by_dataset": worst,
    }
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0 if held is not None and got.nuclides_quarantined == 0 and got.nuclides_done == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())
