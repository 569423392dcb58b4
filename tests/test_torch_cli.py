"""The rest of the port's CLI against the reference's: info, groups,
groups import, the native ACE tokenizer, and run --debug-nans.

Both CLIs read the same files here, so their output lines are compared as
text; the one line that names the generator and its version differs by
design (a port library says ndpp-tpu-torch).
"""

import json

import numpy as np
import pytest
import torch

from ndpp_tpu import cli as j_cli
from ndpp_tpu import groups as j_groups
from ndpp_tpu import native as j_native
from ndpp_tpu.host.ace import synth
from ndpp_tpu.host.ace.write import format_ascii, write_ace
from ndpp_tpu_torch import cli as t_cli
from ndpp_tpu_torch import driver as t_driver
from ndpp_tpu_torch import native as t_native
from ndpp_tpu_torch.parallel import rows as rows_mod
from ndpp_tpu_torch.utils.errors import NdppError

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    out = tmp_path_factory.mktemp("clilib")
    entries = []
    for key, n in [("h1", 40), ("u235", None)]:
        nuc = synth.ALL_FIXTURES[key](n) if n else synth.build(key)
        p = write_ace(nuc, out / f"{key}.ace")
        entries.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    (out / "xsdir").write_text("directory\n" + "\n".join(entries) + "\n")
    return out


def _deck(tmp_path, library, path, fmt="both", nuclides=("1001.80c", "92235.80c"), freegas="none"):
    deck = tmp_path / f"deck_{path.stem}.toml"
    deck.write_text(
        f'[run]\nnuclides = {list(nuclides)!r}\nlibrary = "{library / "xsdir"}"\ngroups = "uniform-lethargy-47"\n'
        f'legendre_order = 2\nfreegas_for = ["{freegas}"]\n[output]\npath = "{path}"\nformat = "{fmt}"\n'
        "[device]\ne_tile = 64\nwatchdog_minutes = 0\n"
    )
    return deck


def _run_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out.splitlines()


def test_info_prints_the_references_lines(library, tmp_path, capsys):
    lib = tmp_path / "lib.h5"
    assert t_cli.main(["run", "-c", str(_deck(tmp_path, library, lib)), "--device", "cpu"]) == 0
    capsys.readouterr()
    for path in (lib, tmp_path / "lib.txt"):
        got = _run_cli(t_cli.main, ["info", str(path)], capsys)
        ref = _run_cli(j_cli.main, ["info", str(path)], capsys)
        assert got[0] == ref[0] and "ndpp-tpu" in got[0]  # the generator line: the file's own
        assert got[1:] == ref[1:]
        assert "nuclides (2):" in got
        assert any(line.strip().startswith("92235.80c") and line.endswith("chi" + ("" if path.suffix == ".txt" else " [complete]")) for line in got)
    assert "ndpp-tpu-torch" in got[0]  # ASCII: written by the port


def test_info_on_ascii_needs_no_h5py(library, tmp_path, capsys, monkeypatch):
    lib = tmp_path / "only.txt"
    deck = _deck(tmp_path, library, lib, fmt="ascii", nuclides=("1001.80c",))
    assert t_cli.main(["run", "-c", str(deck), "--device", "cpu"]) == 0
    capsys.readouterr()
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    lines = _run_cli(t_cli.main, ["info", str(lib)], capsys)
    assert lines[2:4] == ["legendre_order: 2", "temperatures: [293.6]"] and "nuclides (1):" in lines


def test_groups_list_dump_and_import_match_the_reference(tmp_path, capsys, monkeypatch):
    src = tmp_path / "my-table.txt"
    rng = np.random.default_rng(3)
    vals = np.sort(rng.uniform(1e-4, 2e7, 30))
    src.write_text("# a user table\n" + "\n".join(f"{v:.9e}," for v in vals[::-1]) + f"\n{vals[4]:.9e}\n")
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"

    got = _run_cli(t_cli.main, ["groups", "import", str(src), "--name", "mine-29", "--dir", str(t_dir)], capsys)
    g_ref = j_groups.import_table(src, "mine-29", j_dir)
    assert (t_dir / "mine-29.txt").read_bytes() == (j_dir / "mine-29.txt").read_bytes()
    assert f"imported 'mine-29': {g_ref.ng} groups -> {t_dir}" == got[0]
    assert f"  boundaries_sha256_16: {g_ref.checksum()}" in got

    monkeypatch.setenv("NDPP_GROUPS_DIR", str(t_dir))
    for argv in (["groups"], ["groups", "mine-29"], ["groups", "uniform-lethargy-361"]):
        got = _run_cli(t_cli.main, argv, capsys)
        ref = _run_cli(j_cli.main, argv, capsys)
        assert got == ref, argv
    assert any(line.startswith("mine-29 ") and " 29 groups" in line for line in _run_cli(t_cli.main, ["groups"], capsys))
    assert t_cli.main(["groups", "import"]) == 2


def test_tokenizer_matches_numpy_and_the_reference(monkeypatch):
    text = format_ascii(synth.build("fe56"))
    xss_text = "\n".join(text.splitlines()[12:])  # the XSS block, after the 2 header and 10 IZAW/NXS/JXS lines
    got = t_native.tokenize_floats(xss_text)
    np.testing.assert_array_equal(got, np.array(xss_text.split(), dtype=np.float64))
    np.testing.assert_array_equal(got, j_native.tokenize_floats(xss_text))
    assert got.size == 4361 and t_native.build().parent.name == "ndpp_tpu_torch"  # NXS(1) of fe56
    np.testing.assert_array_equal(t_native.tokenize_floats(b" 1.5D+02\n-2e-3\t7 "), [150.0, -2e-3, 7.0])
    with pytest.raises(ValueError):  # a token strtod refuses goes to numpy for the message
        t_native.tokenize_floats("1.0 abc 2.0")
    monkeypatch.setenv("NDPP_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(t_native, "library", lambda: pytest.fail("the switch must keep the native path off"))
    np.testing.assert_array_equal(t_native.tokenize_floats(xss_text), got)


def test_first_use_from_many_threads_builds_once(tmp_path, monkeypatch):
    """The driver parses on prefetch threads: eight threads that start the
    tokenizer's first use together (no library built yet) all get it, and
    one build lands in the build directory."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(t_native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(t_native, "_LIB", [])
    start = threading.Barrier(8)

    def first_use(i):
        start.wait(timeout=60)
        return t_native.tokenize_floats(f"{i} 2.5 -1e3")

    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(first_use, range(8), timeout=300))
    for i, got in enumerate(results):
        np.testing.assert_array_equal(got, [i, 2.5, -1e3])
    assert [p.name for p in (tmp_path / "build").iterdir()] == [t_native.build().name]


def test_failed_tokenizer_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text('extern "C" long long ndpp_tokenize( {\n')
    monkeypatch.setattr(t_native, "_SRC", bad)
    monkeypatch.setattr(t_native, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(NdppError, match=r"(?s)g\+\+ failed.*error: expected"):
        t_native.build()
    assert not list((tmp_path / "build").iterdir())


def _nan_twobody(*args, **kw):
    e = args[0]
    return torch.full((e.shape[0], args[7] + 1, args[3].shape[-1] - 1), float("nan"), dtype=torch.float64)


@pytest.mark.parametrize("debug_nans", [True, False])
def test_debug_nans_names_family_and_nuclide(library, tmp_path, capsys, monkeypatch, debug_nans):
    """A NaN from the two-body op: with --debug-nans the nuclide is
    quarantined with the family and its name (exit 3); without it nothing is
    checked and the NaN reaches the library."""
    monkeypatch.setattr(t_driver, "twobody_moments", _nan_twobody)
    lib = tmp_path / "nan.txt"
    deck = _deck(tmp_path, library, lib, fmt="ascii", nuclides=("1001.80c",))
    argv = ["run", "-c", str(deck), "--device", "cpu"] + (["--debug-nans"] if debug_nans else [])
    rc = t_cli.main(argv)
    out, err = capsys.readouterr()
    metrics = json.loads(out.strip().splitlines()[-1])
    assert rows_mod.debug_nans is False  # the switch lasts one run
    if debug_nans:
        assert rc == 3 and metrics["nuclides_quarantined"] == 1
        assert "quarantined 1001.80c: non-finite twobody result" in err and "for 1001.80c" in err
    else:
        assert rc == 0 and metrics["nuclides_quarantined"] == 0 and "nan" in lib.read_text().lower()


def test_debug_nans_raises_ndpp_error_per_nuclide(monkeypatch):
    """The freegas family's op returns a NaN: process_nuclide's caller
    raises NdppError naming the family and the nuclide."""
    from ndpp_tpu_torch import freegas_driver
    from ndpp_tpu_torch.config import RunConfig
    from ndpp_tpu_torch.host.ace import synth as t_synth

    def nan_freegas(e, awr, kt, bounds, order, **kw):
        return torch.full((e.shape[0], order + 1, bounds.shape[0] - 1), float("nan"), dtype=torch.float64)

    monkeypatch.setattr(freegas_driver, "freegas_moments_sab", nan_freegas)
    cfg = RunConfig(groups="uniform-lethargy-47", legendre_order=2)
    cfg.validate()
    nuc = t_synth.h1_like(30)
    monkeypatch.setattr(rows_mod, "debug_nans", True)
    with pytest.raises(NdppError, match="non-finite freegas result .* for 1001.80c"):
        t_driver._process_with_oom_retry(nuc, cfg.group_structure(), cfg, torch.device("cpu"), None)
