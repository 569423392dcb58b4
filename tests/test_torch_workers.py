"""Nuclide-axis process parallelism of the port (ndpp_tpu_torch/parallel/nuclides.py)
and the HDF5 merge and ASCII twin it relies on (ndpp_tpu_torch/io/library.py).

Two shard workers over a two-nuclide deck (h1, o16; free-gas off, P3, 47
groups) on the CPU. The merged library matches the port's single-process
library at rtol 1e-12 (as tests/test_pipeline.py holds the reference's) and
the reference's single-process library, built from the same deck, at rtol
1e-8 with atol 1e-14 (the atol of tests/test_torch_pipeline.py: elements at
roundoff level). The ASCII twin matches the merged HDF5 exactly. Worker
environments on cuda are read from a stand-in for subprocess.Popen, so no
process is started for them.
"""

import json
import os
import shutil
import sys
from pathlib import Path

import h5py
import pytest
import torch

from ndpp_tpu import config as j_config
from ndpp_tpu import driver as j_driver
from ndpp_tpu.host.ace import synth
from ndpp_tpu.host.ace.write import write_ace
from ndpp_tpu_torch import cli as t_cli
from ndpp_tpu_torch import config as t_config
from ndpp_tpu_torch import driver as t_driver
from ndpp_tpu_torch.interop import config_from_dict
from ndpp_tpu_torch.io.library import compare, merge_libraries, write_ascii_from_hdf5
from ndpp_tpu_torch.parallel import nuclides as nuclides_mod
from ndpp_tpu_torch.utils.errors import ConfigError

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other

ROOT = Path(__file__).resolve().parents[1]
NUCLIDES = ["1001.80c", "8016.80c"]


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    out = tmp_path_factory.mktemp("workerlib")
    entries = []
    for key, n in [("h1", 50), ("o16", 40)]:
        nuc = synth.ALL_FIXTURES[key](n)
        p = write_ace(nuc, out / f"{key}.ace")
        entries.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    (out / "xsdir").write_text("directory\n" + "\n".join(entries) + "\n")
    return out


def _ref_cfg(lib, path):
    cfg = j_config.RunConfig(
        nuclides=list(NUCLIDES), library=str(lib / "xsdir"), groups="uniform-lethargy-47", legendre_order=3,
        freegas_for=["none"],
    )
    cfg.output.path = str(path)
    cfg.device.e_tile = 64
    cfg.device.max_devices = 1
    cfg.device.watchdog_minutes = 0
    cfg.validate()
    return cfg


def _port_cfg(lib, path, fmt="hdf5"):
    cfg = config_from_dict(_ref_cfg(lib, path).to_dict())
    cfg.output.format = fmt
    return cfg


@pytest.fixture(scope="module")
def single(library, tmp_path_factory):
    """The port's single-process library of the deck (HDF5)."""
    cfg = _port_cfg(library, tmp_path_factory.mktemp("single") / "single.h5")
    metrics = t_driver.run(cfg, device="cpu")
    assert (metrics.nuclides_done, metrics.nuclides_quarantined) == (2, 0)
    return Path(cfg.output.path)


def _assert_match(report):
    assert report["match"], report["missing"] or {k: v for k, v in report["datasets"].items() if not v.get("ok")}


def test_two_workers_merge_to_both_single_process_libraries(library, single, tmp_path):
    cfg = _port_cfg(library, tmp_path / "merged.h5", fmt="both")  # exercises the post-merge ASCII twin
    summary = nuclides_mod.run_workers(cfg, 2, device="cpu", env_extra={"PYTHONPATH": str(ROOT)}, timeout_s=300)
    assert summary["worker_rcs"] == {0: 0, 1: 0}, (tmp_path / "merged.shard0.log").read_text()
    assert summary["merged_nuclides"] == 2 and len(summary["shards"]) == 2
    for i, name in enumerate(NUCLIDES):  # round-robin shards, one nuclide each
        with h5py.File(tmp_path / f"merged.shard{i}.h5") as f:
            assert list(f["nuclides"]) == [name]
    _assert_match(compare(cfg.output.path, single, rtol=1e-12))

    ref_cfg = _ref_cfg(library, tmp_path / "ref.h5")
    ref = j_driver.run(ref_cfg)
    assert (ref.nuclides_done, ref.nuclides_quarantined) == (2, 0)
    report = compare(cfg.output.path, ref_cfg.output.path, rtol=1e-8, atol=1e-14)
    _assert_match(report)
    print("merged vs reference: max_abs", max(v["max_abs"] for v in report["datasets"].values()))

    twin = tmp_path / "merged.txt"
    _assert_match(compare(cfg.output.path, twin, rtol=0.0, atol=0.0))


def test_cli_workers_with_ascii_output(library, single, tmp_path, capsys, monkeypatch):
    """run --workers 2 --device cpu with format='ascii': the HDF5 merge moves
    beside the ASCII path, which receives the twin."""
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    deck = tmp_path / "deck.toml"
    deck.write_text(
        f'[run]\nnuclides = {NUCLIDES!r}\nlibrary = "{library / "xsdir"}"\ngroups = "uniform-lethargy-47"\n'
        f'legendre_order = 3\nfreegas_for = ["none"]\n[output]\npath = "{tmp_path / "lib.txt"}"\nformat = "ascii"\n'
        "[device]\ne_tile = 64\nwatchdog_minutes = 0\n"
    )
    assert t_cli.main(["run", "-c", str(deck), "--device", "cpu", "--workers", "2"]) == 0
    assert '"merged_nuclides": 2' in capsys.readouterr().out
    assert (tmp_path / "lib.h5").exists()
    _assert_match(compare(tmp_path / "lib.txt", single, rtol=1e-12))


def test_merge_skips_incomplete_groups_and_later_sources_win(single, tmp_path, capsys):
    shard = tmp_path / "shard_crashed.h5"
    shutil.copy(single, shard)
    with h5py.File(shard, "a") as f:
        f["nuclides/8016.80c"].attrs["complete"] = 0
        del f["nuclides/8016.80c/scatter"]  # a crashed writer may leave datasets missing
    merged = tmp_path / "merged.h5"
    assert merge_libraries(merged, [shard]) == 1
    with h5py.File(merged) as f:
        assert sorted(f["nuclides"]) == ["1001.80c"]

    later = tmp_path / "later.h5"
    shutil.copy(single, later)
    with h5py.File(later, "a") as f:
        f["nuclides/1001.80c/sigma_scatter"][0] = 123.0
    assert t_cli.main(["merge", str(merged), str(shard), str(later)]) == 0
    assert "merged 3 nuclides from 2 shard(s)" in capsys.readouterr().out
    with h5py.File(merged) as f:
        assert sorted(f["nuclides"]) == NUCLIDES
        assert f["nuclides/1001.80c/sigma_scatter"][0] == 123.0
    n = write_ascii_from_hdf5(shard, tmp_path / "twin.txt")
    assert n == 1  # the twin holds complete nuclides only


def test_merge_refuses_differing_headers(single, tmp_path):
    other = tmp_path / "other.h5"
    shutil.copy(single, other)
    with h5py.File(other, "a") as f:
        f["temperatures"][0] = 600.0
    with pytest.raises(ValueError, match="differs"):
        merge_libraries(tmp_path / "m.h5", [single, other])
    with pytest.raises(ValueError, match="no source"):
        merge_libraries(tmp_path / "m.h5", [])


class _FakePopen:
    started: list = []

    def __init__(self, cmd, env=None, stdout=None, stderr=None):
        self.cmd, self.env = cmd, env
        _FakePopen.started.append(self)

    def wait(self, timeout=None):
        return 0


def test_cuda_workers_get_one_card_each(library, tmp_path, monkeypatch):
    for key in [k for k in os.environ if k.startswith("TPU_") or k == "CUDA_VISIBLE_DEVICES"]:
        monkeypatch.delenv(key)
    _FakePopen.started = []
    monkeypatch.setattr(nuclides_mod.subprocess, "Popen", _FakePopen)
    cfg = _port_cfg(library, tmp_path / "m.h5")
    cfg.resume = True
    summary = nuclides_mod.run_workers(cfg, 3, device="cuda")
    assert summary["merged_nuclides"] == 0 and summary["worker_rcs"] == {0: 0, 1: 0, 2: 0}
    assert len(_FakePopen.started) == 3
    for i, p in enumerate(_FakePopen.started):
        assert p.env["CUDA_VISIBLE_DEVICES"] == str(i)
        assert not any(k.startswith("TPU_") for k in p.env)
        assert "NDPP_FORCE_CPU_DEVICES" not in p.env
        assert p.cmd[:4] == [sys.executable, "-m", "ndpp_tpu_torch", "run"]
        assert p.cmd[-3:] == ["--device", "cuda", "--resume"]
        deck = t_config.load(p.cmd[5])
        assert deck.shard == f"{i}/3" and deck.output.format == "hdf5"
        assert deck.output.path == str(tmp_path / f"m.shard{i}.h5")
    # the caller's cards are handed out one to a worker; a worker past the
    # end of the list gets none (it exits 2), never a card another one holds
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,7")
    _FakePopen.started = []
    nuclides_mod.run_workers(cfg, 3, device="cuda")
    assert [p.env["CUDA_VISIBLE_DEVICES"] for p in _FakePopen.started] == ["5", "7", ""]


def test_workers_pass_debug_nans_on(library, tmp_path, monkeypatch):
    _FakePopen.started = []
    monkeypatch.setattr(nuclides_mod.subprocess, "Popen", _FakePopen)
    deck = tmp_path / "deck.json"
    deck.write_text(json.dumps(nuclides_mod._worker_deck(_port_cfg(library, tmp_path / "m.h5"), 0, 1, tmp_path / "m.h5")))
    rc = t_cli.main(["run", "-c", str(deck), "--device", "cpu", "--workers", "2", "--debug-nans"])
    assert rc == 0 and len(_FakePopen.started) == 2
    for p in _FakePopen.started:
        assert p.cmd[-3:] == ["--device", "cpu", "--debug-nans"]
    _FakePopen.started = []
    nuclides_mod.run_workers(_port_cfg(library, tmp_path / "m.h5"), 2, device="cpu")
    assert all("--debug-nans" not in p.cmd for p in _FakePopen.started)


def test_workers_refuse_a_profiled_run(library, tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a worker was started")

    monkeypatch.setattr(nuclides_mod.subprocess, "Popen", refuse)
    cfg = _port_cfg(library, tmp_path / "m.h5")
    cfg.device.profile = True
    with pytest.raises(ConfigError, match="profile"):
        nuclides_mod.run_workers(cfg, 2, device="cpu")
    assert not list(tmp_path.iterdir())


def test_workers_need_h5py_before_any_worker_starts(library, tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a worker was started")

    monkeypatch.setattr(nuclides_mod.subprocess, "Popen", refuse)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ConfigError, match="h5py"):
        nuclides_mod.run_workers(_port_cfg(library, tmp_path / "m.h5"), 2, device="cpu")
    assert not list(tmp_path.iterdir())
