"""The whole two-body slice: one deck through both packages, libraries compared.

The reference (ndpp_tpu.driver.run, f64 XLA path on the CPU) writes HDF5;
the port (ndpp_tpu_torch.driver.run on the CPU, plain torch inner stage)
writes ASCII; the reference's format-agnostic comparator holds them to the
1e-8 product bar (BASELINE.json:5), rtol 1e-8, with atol 1e-14.

Why an atol: both sides are float64 with the same formulas and differ in
summation order only (max abs difference ~4e-16 on moments whose P0 rows sum
to 1), but some elements are themselves at roundoff level -- e.g. P3 moments
of near-isotropic low-energy rows, ~1e-15, the result of cancellation in the
Gauss-Legendre sum and of differences of O(1) cumulative sums. No two
implementations agree on those in relative terms (the reference's own dd
path is held to its f64 path with atol 1e-12, tests/test_pallas.py).
"""

import numpy as np
import pytest
import torch

from ndpp_tpu import config as j_config
from ndpp_tpu import driver as j_driver
from ndpp_tpu.host.ace import synth
from ndpp_tpu.host.ace.write import write_ace
from ndpp_tpu.io.library import compare, read_ascii
from ndpp_tpu_torch import cli as t_cli
from ndpp_tpu_torch import driver as t_driver
from ndpp_tpu_torch.interop import config_from_dict

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

NUCLIDES = ["1001.80c", "26056.80c", "8016.80c"]
ATOL = 1e-14


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """h1, fe56 and o16 at reduced n_energy, plus a continuum (kalbach) and a
    fissile (u235) nuclide."""
    out = tmp_path_factory.mktemp("torchlib")
    entries = []
    for key, n in [("h1", 50), ("fe56", 60), ("o16", 40), ("kalbach", None), ("u235", None)]:
        nuc = synth.ALL_FIXTURES[key](n) if n else synth.build(key)
        p = write_ace(nuc, out / f"{key}.ace")
        entries.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    (out / "xsdir").write_text("directory\n" + "\n".join(entries) + "\n")
    return out


def _cfg(lib, path, **run):
    cfg = j_config.RunConfig(
        nuclides=run.pop("nuclides", NUCLIDES),
        library=str(lib / "xsdir"),
        groups="uniform-lethargy-47",
        legendre_order=3,
        freegas_for=run.pop("freegas_for", ["none"]),
        **run,
    )
    cfg.output.path = str(path)
    cfg.device.e_tile = 64
    cfg.device.max_devices = 1
    cfg.device.watchdog_minutes = 0
    cfg.validate()
    return cfg


def test_slice_matches_reference_library(library, tmp_path):
    ref_cfg = _cfg(library, tmp_path / "ref.h5")
    ref = j_driver.run(ref_cfg)
    port_cfg = config_from_dict(ref_cfg.to_dict())
    port_cfg.output.path = str(tmp_path / "port.txt")
    port_cfg.output.format = "ascii"
    got = t_driver.run(port_cfg, device="cpu")
    assert (got.nuclides_done, got.nuclides_quarantined) == (3, 0) == (ref.nuclides_done, ref.nuclides_quarantined)
    assert got.moments_computed == ref.moments_computed

    report = compare(tmp_path / "ref.h5", tmp_path / "port.txt", rtol=1e-8, atol=ATOL)
    assert report["match"], report
    scatter = {k: v for k, v in report["datasets"].items() if k.endswith("/scatter")}
    assert len(scatter) == 3
    max_rel = max(v["max_rel"] for v in scatter.values())
    max_abs = max(v["max_abs"] for v in scatter.values())
    print(f"port vs reference scatter: max_rel={max_rel:.3e} max_abs={max_abs:.3e}")
    assert max_abs < 2e-15  # measured 4.4e-16 on the CPU

    datasets, attrs = read_ascii(tmp_path / "port.txt")
    assert attrs["generator"].startswith("ndpp-tpu-torch")
    sc = datasets["/nuclides/26056.80c/scatter"]
    sig = datasets["/nuclides/26056.80c/sigma_scatter"]
    p0 = sc[0, :, 0, :].sum(axis=1)
    np.testing.assert_allclose(p0[sig > 0], 1.0, rtol=1e-10)


def test_unported_families_fail_loudly(library, tmp_path):
    """No family is refused any more: the continuum and fissile nuclides of
    the library, once quarantined as not yet ported, run
    (tests/test_torch_continuum_pipeline.py holds their values to the
    reference), and so do the free-gas and S(alpha,beta) decks once refused
    before the sweep (test_thermal_configurations_match_reference)."""
    assert not hasattr(t_driver, "_check_ported")
    cfg = config_from_dict(_cfg(library, tmp_path / "q.txt", nuclides=["40090.80k", "92235.80c"]).to_dict())
    cfg.output.format = "ascii"
    got = t_driver.run(cfg, device="cpu")
    assert (got.nuclides_done, got.nuclides_quarantined) == (2, 0)


@pytest.mark.parametrize(
    "kw",
    [{"freegas_for": []}, {"freegas_for": ["1001.80c"]}, {"sab": {"1001.80c": ["lwtr.20t"]}}],
    ids=["freegas-default", "freegas-h1", "sab-h1"],
)
def test_thermal_configurations_match_reference(library, tmp_path, kw):
    """The three decks the port refused before free-gas and S(alpha,beta)
    were ported run and match the reference library at rtol 1e-8, atol 1e-14
    (the sab deck keeps free-gas off; lwtr.20t is not in the library and
    resolves to the built-in fixture). The reference's free-gas op runs with
    its group split in the Legendre basis (tests/test_torch_freegas.py says
    why); everything else of it runs as shipped."""
    from test_torch_freegas import exact_split_reference

    ref_cfg = _cfg(library, tmp_path / "ref.h5", **kw)
    with exact_split_reference():
        ref = j_driver.run(ref_cfg)
    port_cfg = config_from_dict(ref_cfg.to_dict())
    port_cfg.output.path = str(tmp_path / "port.txt")
    port_cfg.output.format = "ascii"
    got = t_driver.run(port_cfg, device="cpu")
    assert (got.nuclides_done, got.nuclides_quarantined) == (3, 0) == (ref.nuclides_done, ref.nuclides_quarantined)
    assert got.moments_computed == ref.moments_computed > 0
    report = compare(tmp_path / "ref.h5", tmp_path / "port.txt", rtol=1e-8, atol=ATOL)
    assert report["match"], report
    print("max_abs", max(v["max_abs"] for v in report["datasets"].values()))


def test_cli_run_and_device_rule(library, tmp_path, capsys):
    import torch

    deck = tmp_path / "deck.toml"
    deck.write_text(
        f'[run]\nnuclides = ["1001.80c"]\nlibrary = "{library / "xsdir"}"\nlegendre_order = 1\n'
        f'freegas_for = ["none"]\n[output]\npath = "{tmp_path / "cli.txt"}"\nformat = "ascii"\n'
        "[device]\ne_tile = 32\nwatchdog_minutes = 0\n"
    )
    assert t_cli.main(["run", "-c", str(deck), "--device", "cpu"]) == 0
    assert t_cli.main(["compare", str(tmp_path / "cli.txt"), str(tmp_path / "cli.txt")]) == 0
    if not torch.cuda.is_available():
        # an explicit CUDA run without a card is an error, never a CPU run
        assert t_cli.main(["run", "-c", str(deck), "--device", "cuda"]) == 2
        assert "torch.cuda.is_available() is False" in capsys.readouterr().err
