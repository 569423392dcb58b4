"""A thermal deck through both packages and through the port's command line.

Two temperatures, free-gas on every nuclide (the default, freegas_for = []),
S(alpha,beta) tables assigned to h1 (lwtr.20t: continuous inelastic,
incoherent elastic) and o16 (grph.20t: discrete inelastic, Bragg edges;
there is no carbon fixture). The reference (``ndpp_tpu.driver.run`` on the
CPU, its free-gas group split in the Legendre basis as
tests/test_torch_freegas.py explains) writes HDF5; the port
(``ndpp_tpu_torch.driver.run(cfg, device="cpu")``) writes ASCII; the
reference's comparator holds them to rtol 1e-8, atol 1e-14.
"""

import numpy as np
import pytest
import torch

from ndpp_tpu import config as j_config
from ndpp_tpu import driver as j_driver
from ndpp_tpu.host.ace import synth as j_synth
from ndpp_tpu.host.ace.thermal import write_thermal_ace
from ndpp_tpu.host.ace.write import write_ace
from ndpp_tpu.io.library import compare, read_ascii
from ndpp_tpu_torch import cli as t_cli
from ndpp_tpu_torch import driver as t_driver
from ndpp_tpu_torch.host.ace import synth as t_synth
from ndpp_tpu_torch.host.ace import thermal as t_thermal
from ndpp_tpu_torch.interop import config_from_dict

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

NUCLIDES = ["1001.80c", "8016.80c", "26056.80c"]
SAB = {"1001.80c": ["lwtr.20t"], "8016.80c": ["grph.20t"]}
ATOL = 1e-14


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """h1, o16 and fe56 at reduced n_energy, and both thermal tables."""
    out = tmp_path_factory.mktemp("thermlib")
    entries = []
    for key, n in [("h1", 50), ("o16", 40), ("fe56", 60)]:
        nuc = j_synth.ALL_FIXTURES[key](n)
        p = write_ace(nuc, out / f"{key}.ace")
        entries.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    for key in j_synth.THERMAL_FIXTURES:
        tab = j_synth.build_thermal(key)
        p = write_thermal_ace(tab, out / f"{key}.ace")
        entries.append(f"{tab.name} {tab.awr:.6f} {p.name} 0 1 1 0")
    (out / "xsdir").write_text("directory\n" + "\n".join(entries) + "\n")
    return out


def _cfg(lib, path):
    cfg = j_config.RunConfig(
        nuclides=NUCLIDES, library=str(lib / "xsdir"), groups="uniform-lethargy-47", legendre_order=3,
        temperatures=[293.6, 600.0], sab=SAB,
    )
    cfg.output.path = str(path)
    cfg.device.e_tile = 64
    cfg.device.max_devices = 1
    cfg.device.watchdog_minutes = 0
    cfg.validate()
    return cfg


def test_thermal_deck_matches_reference_library(library, tmp_path):
    from test_torch_freegas import exact_split_reference

    ref_cfg = _cfg(library, tmp_path / "ref.h5")
    assert ref_cfg.freegas_for == []
    with exact_split_reference():
        ref = j_driver.run(ref_cfg)
    port_cfg = config_from_dict(ref_cfg.to_dict())
    port_cfg.output.path = str(tmp_path / "port.txt")
    port_cfg.output.format = "ascii"
    got = t_driver.run(port_cfg, device="cpu")
    assert (got.nuclides_done, got.nuclides_quarantined) == (3, 0) == (ref.nuclides_done, ref.nuclides_quarantined)
    assert got.moments_computed == ref.moments_computed
    assert {"dispatch.freegas", "wait.freegas", "dispatch.sab", "wait.sab"} <= set(got.phase_seconds)

    report = compare(tmp_path / "ref.h5", tmp_path / "port.txt", rtol=1e-8, atol=ATOL)
    assert report["match"], report
    max_abs = max(v["max_abs"] for k, v in report["datasets"].items() if k.endswith("/scatter"))
    print(f"thermal deck, port vs reference: max_abs={max_abs:.3e} over {len(report['datasets'])} datasets")

    datasets, _ = read_ascii(tmp_path / "port.txt")
    for name in NUCLIDES:
        sc = datasets[f"/nuclides/{name}/scatter"]
        sig = datasets[f"/nuclides/{name}/sigma_scatter"]
        assert sc.shape[0] == 2 and np.isfinite(sc).all()
        # the two temperatures differ below the thermal cutoff, agree above it
        assert not np.array_equal(sc[0], sc[1])
        np.testing.assert_allclose(sc[:, sig > 0, 0, :].sum(axis=2), 1.0, rtol=1e-10)


def test_cli_fixtures_and_default_deck_runs(library, tmp_path):
    """`fixtures` writes both thermal tables with their xsdir lines; decks
    with default settings and with run.sab run through the command line."""
    lib = tmp_path / "fix"
    assert t_cli.main(["fixtures", "--out", str(lib)]) == 0
    xsdir = (lib / "xsdir").read_text()
    for key in t_synth.THERMAL_FIXTURES:
        tab = t_synth.build_thermal(key)
        assert f"{tab.name} {tab.awr:.6f} {key}.ace 0 1 1 0" in xsdir
        back = t_thermal.read_thermal_ace(lib / f"{key}.ace")
        assert t_thermal.format_thermal_ascii(back) == t_thermal.format_thermal_ascii(tab)

    outs = []
    for tag, extra in (("default", ""), ("sab", '\n[run.sab]\n"1001.80c" = ["lwtr.20t"]\n')):
        deck = tmp_path / f"{tag}.toml"
        out = tmp_path / f"{tag}.txt"
        deck.write_text(
            f'[run]\nnuclides = ["1001.80c"]\nlibrary = "{library / "xsdir"}"\nlegendre_order = 1\n'
            f'temperatures = [293.6, 600.0]\n{extra}[output]\npath = "{out}"\nformat = "ascii"\n'
            "[device]\ne_tile = 32\nwatchdog_minutes = 0\n"
        )
        assert t_cli.main(["run", "-c", str(deck), "--device", "cpu"]) == 0
        outs.append(read_ascii(out)[0]["/nuclides/1001.80c/scatter"])
    assert outs[0].shape == outs[1].shape and not np.array_equal(outs[0], outs[1])
