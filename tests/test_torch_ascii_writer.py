"""The ASCII writer's two paths write the same bytes.

`AsciiLibraryWriter._write_array` formats value lines with the native
formatter (native/ascii_format.cpp) when it builds, and with the Python loop
of f"{v:26.17E}" without g++, after a failed build, or under
NDPP_TPU_NO_NATIVE=1. Each case here writes one array both ways and compares
the files byte for byte; a small deck's library is compared whole and read
back exactly; and the fallback writes the same bytes, logs why once and is
counted in the run's metrics.
"""

import logging
import shutil
import sys
from decimal import Decimal

import numpy as np
import pytest
import torch

from ndpp_tpu_torch import driver as t_driver
from ndpp_tpu_torch import native
from ndpp_tpu_torch.config import RunConfig
from ndpp_tpu_torch.groups import GroupStructure
from ndpp_tpu_torch.host.ace import synth
from ndpp_tpu_torch.host.ace.write import write_ace
from ndpp_tpu_torch.io import library as lib_mod
from ndpp_tpu_torch.io.library import AsciiLibraryWriter, read_ascii
from ndpp_tpu_torch.utils import log as log_mod

torch.set_num_threads(1)

CHUNK = lib_mod._CHUNK
GS = GroupStructure(name="three", bounds=np.array([1e-5, 0.625, 1e5, 2e7]))


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def log_messages():
    """The messages the port's logger emits during the test."""
    logger = log_mod.get()
    rec = _Messages()
    logger.addHandler(rec)
    yield rec.messages
    logger.removeHandler(rec)


def _bits(*patterns: int) -> np.ndarray:
    return np.array(patterns, dtype=np.uint64).view(np.float64)


def _ties() -> np.ndarray:
    """Values whose exact decimal expansion has 19 significant digits, the
    last a 5: %.17E keeps 18, so each is a tie, rounded to even. Both
    parities of the 18th digit are present."""
    found = {0: [], 1: []}
    for n in range(20, 90):
        for k in range(1, 64, 2):
            v = k * 2.0**-n
            digits = Decimal(v).as_tuple().digits
            if len(digits) == 19:
                found[digits[17] % 2].append(v)
    assert found[0] and found[1]
    return np.array(found[0][:20] + found[1][:20])


def _rounding() -> np.ndarray:
    """Values whose 18th significant digit rounds, up or down, and ties."""
    one = np.nextafter(1.0, [2.0, 0.0])
    return np.concatenate([[0.1, 0.2, 0.3, 1 / 3, 2 / 3, 9.999999999999999e22, 0.9999999999999999], one, _ties()])


def _exponents() -> np.ndarray:
    """Exponents of 1, 2 and 3 digits, both signs, on values of both signs."""
    e = np.array([0, 1, 5, 9, 10, 42, 99, 100, 123, 299, 307, 308], dtype=np.float64)
    mags = np.concatenate([1.25 * 10.0**e, 1.25 * 10.0**-e, [1e-320, 3e-315]])
    return np.concatenate([mags, -mags])


CASES = {
    "signed_zero_nan_inf": np.concatenate([
        [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf],
        _bits(0x7FF8000000000000, 0xFFF8000000000000, 0x7FF0000000000001, 0xFFFFFFFFFFFFFFFF, 0x7FF4000000000000),
    ]),
    "subnormal_and_extremes": np.array([
        5e-324, -5e-324, 1e-310, -1e-310, np.finfo(np.float64).max, -np.finfo(np.float64).max,
        np.finfo(np.float64).tiny, np.nextafter(np.finfo(np.float64).tiny, 0.0), 2.225073858507201e-308,
    ]),
    "rounding_and_ties": _rounding(),
    "exponent_digits": _exponents(),
    "random_bit_patterns": np.random.default_rng(20261018).integers(0, 2**64, size=100_000, dtype=np.uint64).view(np.float64),
    **{f"size_{n}": np.random.default_rng(n).standard_normal(n) * 10.0 ** np.random.default_rng(n + 1).integers(-30, 30, n)
       for n in (0, 1, 3, 4, 5, CHUNK - 1, CHUNK, CHUNK + 1)},
    "scatter_4d": np.random.default_rng(7).standard_normal((2, 37, 6, 11)),
    "non_contiguous_view": np.random.default_rng(8).standard_normal((3, 40, 6, 12))[:, ::3, 1:5, ::-2].transpose(0, 2, 1, 3),
    "float32": np.arange(-7, 9).astype(np.float32) / 3,
    "int64": np.arange(-7, 9, dtype=np.int64) * 123456789012345,
}


def _write(tmp_path, name: str, arr: np.ndarray, native_on: bool, monkeypatch) -> tuple[bytes, AsciiLibraryWriter]:
    """The whole file of a writer that wrote its header and then `arr`."""
    if native_on:
        monkeypatch.delenv("NDPP_TPU_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("NDPP_TPU_NO_NATIVE", "1")
    w = AsciiLibraryWriter(tmp_path / f"{name}.txt", GS, 1, [293.6, 600.0])
    w._write_array(arr)
    w.fh.close()
    return (tmp_path / f"{name}.txt").read_bytes(), w


@pytest.mark.parametrize("case", list(CASES))
def test_native_and_python_paths_write_the_same_bytes(tmp_path, monkeypatch, case):
    arr = CASES[case]
    got, wn = _write(tmp_path, "native", arr, True, monkeypatch)
    want, wp = _write(tmp_path, "python", arr, False, monkeypatch)
    assert wn._formatter is not None and wp._formatter is None
    assert got == want
    assert (wn.values_native, wn.values_python) == (GS.ng + 1 + arr.size, 0)
    assert (wp.values_native, wp.values_python) == (0, GS.ng + 1 + arr.size)
    body = got.split(b"\n", 5)[5]  # after the header's five lines: the bounds, then the array
    lines = body.splitlines()
    assert all(len(line) == 26 * 4 for line in lines[:-1]) and 0 < len(lines[-1]) <= 26 * 4
    back = np.array(body.split(), dtype=np.float64)[GS.ng + 1 :]
    vals = np.asarray(arr, dtype=np.float64).ravel()
    nan = np.isnan(vals)
    assert np.array_equal(np.isnan(back), nan) and back[~nan].tobytes() == vals[~nan].tobytes()


def _deck(tmp_path, keys=("h1", "fe56", "u235"), n=30):
    lib = tmp_path / "lib"
    lib.mkdir()
    lines = []
    for key in keys:
        nuc = synth.ALL_FIXTURES[key](n)
        p = write_ace(nuc, lib / f"{key}.ace")
        lines.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    (lib / "xsdir").write_text("directory\n" + "\n".join(lines) + "\n")
    return lib / "xsdir"


def _run(xsdir, out):
    cfg = RunConfig(library=str(xsdir), groups="uniform-lethargy-47", legendre_order=1, freegas_for=["none"])
    cfg.output.path = str(out)
    cfg.output.format = "ascii"
    cfg.validate()
    m = t_driver.run(cfg, device="cpu")
    assert m.nuclides_quarantined == 0
    return m


def _without_metrics(raw: bytes) -> bytes:
    """The library without its metrics line (wall seconds and the counters differ by run)."""
    return b"\n".join(line for line in raw.split(b"\n") if not line.startswith(b"metrics "))


def test_library_of_a_small_deck_is_byte_equal_and_reads_back_exactly(tmp_path, monkeypatch, log_messages):
    xsdir = _deck(tmp_path)
    written = []
    write = AsciiLibraryWriter.write_nuclide
    monkeypatch.setattr(AsciiLibraryWriter, "write_nuclide", lambda self, res: (written.append(res), write(self, res))[1])
    monkeypatch.delenv("NDPP_TPU_NO_NATIVE", raising=False)
    m_native = _run(xsdir, tmp_path / "native.txt")
    monkeypatch.setenv("NDPP_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_FORMATTER_OFF_LOGGED", False)
    log_messages.clear()
    m_python = _run(xsdir, tmp_path / "python.txt")
    assert sum(m.startswith("native formatter off") for m in log_messages) == 1

    assert m_native.nuclides_done == m_python.nuclides_done == 3
    assert m_native.ascii_values_native > 0 and m_native.ascii_values_python == 0
    assert (m_python.ascii_values_native, m_python.ascii_values_python) == (0, m_native.ascii_values_native)
    assert m_native.to_dict()["ascii_values_native"] == m_native.ascii_values_native
    native_raw = (tmp_path / "native.txt").read_bytes()
    assert _without_metrics(native_raw) == _without_metrics((tmp_path / "python.txt").read_bytes())

    datasets, attrs = read_ascii(tmp_path / "native.txt")
    assert attrs["metrics"]["ascii_values_python"] == 0
    assert len(written) == 6 and any(res.chi_prompt is not None for res in written)
    for res in written[:3]:
        keys = ["energy", "temperatures", "scatter", "sigma_scatter"] + [k for k in lib_mod._OPTIONAL_SETS if getattr(res, k) is not None]
        for key in keys:
            want = np.asarray(getattr(res, key), dtype=np.float64)
            got = datasets[f"/nuclides/{res.name}/{key}"]
            assert got.shape == want.shape and got.tobytes() == want.tobytes(), (res.name, key)


def _hide_gxx(tmp_path, monkeypatch):
    empty = tmp_path / "bin"
    empty.mkdir()
    (empty / "python3").symlink_to(sys.executable)
    monkeypatch.setenv("PATH", str(empty))
    assert shutil.which("g++") is None


def _failing_source(tmp_path, monkeypatch):
    bad = tmp_path / "src" / "ascii_format.cpp"
    bad.parent.mkdir()
    bad.write_text('extern "C" unsigned long ndpp_format_values( {\n')
    monkeypatch.setattr(native, "_FORMAT_SRC", bad)


@pytest.mark.parametrize("cause", ["gxx_hidden", "build_fails"])
def test_writer_without_the_formatter_writes_the_same_bytes(tmp_path, monkeypatch, log_messages, cause):
    monkeypatch.delenv("NDPP_TPU_NO_NATIVE", raising=False)
    arr = np.concatenate([CASES["signed_zero_nan_inf"], CASES["scatter_4d"].ravel()[:1001]])
    want, wn = _write(tmp_path, "native", arr, True, monkeypatch)
    assert wn._formatter is not None
    xsdir = _deck(tmp_path, keys=("h1",))
    built = _run(xsdir, tmp_path / "built.txt")
    assert built.ascii_values_native > 0 and built.ascii_values_python == 0  # the native share is 100%

    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "nobuild")  # no library built before
    monkeypatch.setattr(native, "_LIB", {})
    (_hide_gxx if cause == "gxx_hidden" else _failing_source)(tmp_path, monkeypatch)
    log_messages.clear()
    got, wp = _write(tmp_path, "fallback", arr, True, monkeypatch)
    assert wp._formatter is None and got == want
    fallback = _run(xsdir, tmp_path / "fallback.txt")
    assert fallback.ascii_values_native == 0 and fallback.ascii_values_python == built.ascii_values_native
    assert _without_metrics((tmp_path / "fallback.txt").read_bytes()) == _without_metrics((tmp_path / "built.txt").read_bytes())
    assert native._LIB[native._FORMAT_SRC] is None  # tried once, not again for every writer
    reason = "g++ not found" if cause == "gxx_hidden" else "g++ failed"
    warned = [m for m in log_messages if m.startswith("native formatter unavailable")]
    assert len(warned) == 1 and reason in warned[0], log_messages
