"""The port's multi-device layer on the CPU: the row split of driver.run over
several shards (parallel.rows.Placement) and the ('nuclide', 'e') mesh
(parallel.mesh), held to one shard and to the reference's 8 virtual devices.

Tolerances:
  - four shards against one: rtol 1e-13, atol 1e-16, the reference's own
    bound for its 8-device run against 1 (tests/test_pipeline.py). Every op
    is per row, so a row's result does not depend on the shard boundaries
    beyond roundoff;
  - the port's 4-shard run against the reference's 8-device run: the library
    bar, rtol 1e-8, atol 1e-14 on per-unit-scatter moments, with the
    reference's free-gas group split evaluated in the Legendre basis
    (test_torch_freegas.exact_split_reference: the split as shipped differs
    by its own roundoff, up to 2.6e-11 of a row's scale);
  - mesh: two-body at rtol 1e-12, atol 1e-14 (test_torch_twobody.py),
    free-gas at 1e-10 |ref| + 1e-13 of the row's scale against the
    Legendre-split reference (test_torch_freegas.py), chi fractions at rtol
    1e-12, atol 1e-15 (exact per-panel integrals on both sides).
"""

import logging

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as ge
from ndpp_tpu import config as j_config
from ndpp_tpu import driver as j_driver
from ndpp_tpu.ops import freegas as j_fg
from ndpp_tpu.parallel import mesh as j_mesh
from ndpp_tpu_torch import driver as t_driver
from ndpp_tpu_torch.config import RunConfig
from ndpp_tpu_torch.host.ace import synth
from ndpp_tpu_torch.host.ace.thermal import write_thermal_ace
from ndpp_tpu_torch.host.ace.write import write_ace
from ndpp_tpu_torch.io.library import compare
from ndpp_tpu_torch.parallel import mesh as t_mesh
from ndpp_tpu_torch.parallel import rows as rows_mod
from ndpp_tpu_torch.utils import log as log_mod
from test_torch_freegas import _assert_close, exact_split_reference

torch.set_num_threads(1)

SHARD_RTOL, SHARD_ATOL = 1e-13, 1e-16
LIB_RTOL, LIB_ATOL = 1e-8, 1e-14
FOUR_CPUS = ["cpu"] * 4
# every family: two-body (all), S(alpha,beta) on h1, free-gas (all),
# continuum (kalbach), chi (u235)
DECK = {"h1": 40, "o16": 40, "kalbach": 40, "u235": 40}


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def log_messages():
    """The messages the port's logger emits during the test (its stream
    handler may hold a capture stream of an earlier test)."""
    logger = log_mod.get()
    rec = _Messages()
    logger.addHandler(rec)
    yield rec.messages
    logger.removeHandler(rec)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    lib = tmp_path_factory.mktemp("shardlib")
    lines = []
    for key, n in DECK.items():
        nuc = synth.ALL_FIXTURES[key](n)
        p = write_ace(nuc, lib / f"{key}.ace")
        lines.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    tab = synth.build_thermal("lwtr")
    p = write_thermal_ace(tab, lib / "lwtr.ace")
    lines.append(f"{tab.name} {tab.awr:.6f} {p.name} 0 1 1 0")
    (lib / "xsdir").write_text("directory\n" + "\n".join(lines) + "\n")
    return lib


def _deck(cls, lib, out, nuclides=None):
    cfg = cls(
        nuclides=nuclides or [],
        library=str(lib / "xsdir"),
        groups="uniform-lethargy-47",
        legendre_order=2,
        temperatures=[293.6],
        sab={"1001.80c": ["lwtr.20t"]},
    )
    cfg.output.path = str(out)
    cfg.device.e_tile = 64  # several tiles per dispatch set, so pieces of every shard
    cfg.validate()
    return cfg


def test_tile_for_and_the_plan_cut_every_tile_into_contiguous_slices():
    assert rows_mod.tile_for(1000, 256, 512, 4) == 1000  # 250 rows per device
    assert rows_mod.tile_for(5000, 256, 512, 4) == 1024  # the cap per device
    assert rows_mod.tile_for(5000, 256, 256, 4) == 512  # scales with e_tile (the OOM retry)
    assert rows_mod.tile_for(3, 256, 512, 4) == 4
    place = rows_mod.Placement(["cpu"] * 3)
    plan = place.plan(100, 16, 512)
    assert plan.piece_rows == 16
    covered = sorted((p.start, p.length) for p in plan.pieces)
    assert [s for s, _ in covered] == list(np.cumsum([0] + [n for _, n in covered[:-1]]))
    assert sum(n for _, n in covered) == 100
    # three tiles of 48, 48 and 4 rows; each piece knows the rows of its whole tile
    assert [p.tile for p in plan.pieces] == [48] * 6 + [4] * 2
    rows = np.arange(100.0)[:, None] * np.ones(3)
    held = plan.put(rows)
    for k, sl, start, length, _ in plan.pieces:
        np.testing.assert_array_equal(held[k][sl].numpy(), rows[start : start + length])
    one = rows_mod.Placement(["cpu"]).plan(100, 16, 512)
    assert [(p.start, p.length) for p in one.pieces] == [(s, min(16, 100 - s)) for s in range(0, 100, 16)]
    assert one.put(rows)[0].shape == (100, 3)
    # a placement of one device has no stream of its own: the current stream
    assert rows_mod.Placement(["cpu", "cpu"]).streams == (None, None)


def _toy_dispatch(nd: int, rows: np.ndarray, out: np.ndarray, pending: list, seen: list) -> rows_mod.RowPlan:
    """A toy op over a plan of nd CPU shards at 16 rows a tile: each result
    row is its operand row scaled by a replicated table (read as
    table[piece.k]) plus its own row number (from piece.start and
    piece.length), so it depends on the row alone, not on the shard."""
    place = rows_mod.Placement(["cpu"] * nd)
    plan = place.plan(rows.shape[0], 16, 512)
    table = place.put_replicated(np.array([3.0]))

    def op(piece, x, nothing):
        seen.append((piece, nothing))
        at = torch.arange(piece.start, piece.start + piece.length, dtype=torch.float64)
        return x * table[piece.k] + at[:, None]

    plan.dispatch(op, out, pending, rows, None)
    return plan


@pytest.mark.parametrize("nd", [1, 4])
def test_dispatch_fills_out_with_the_same_bytes_on_one_and_four_shards(nd):
    rows = np.random.default_rng(3).uniform(-1.0, 1.0, (100, 5))
    want = rows * 3.0 + np.arange(100.0)[:, None]
    out, pending, seen = np.zeros_like(rows), [], []
    plan = _toy_dispatch(nd, rows, out, pending, seen)
    assert [piece for piece, _ in seen] == plan.pieces  # every piece once, in pieces order
    assert {piece.k for piece, _ in seen} == set(range(nd))
    assert [(b is out, start, length) for b, start, length, _ in pending] == [
        (True, p.start, p.length) for p in plan.pieces
    ]
    plan.place.land(pending, "toy")
    assert out.tobytes() == want.tobytes()


@pytest.mark.parametrize("nd", [1, 4])
def test_dispatch_hands_a_none_operand_to_the_op_as_none(nd):
    seen = []
    _toy_dispatch(nd, np.ones((40, 2)), np.zeros((40, 2)), [], seen)
    assert seen and all(nothing is None for _, nothing in seen)


def test_dispatch_appends_to_pending_and_does_not_land():
    earlier = (np.zeros((1, 2)), 0, 1, torch.ones(1, 2, dtype=torch.float64))
    out, pending = np.full((40, 2), -7.0), [earlier]
    plan = _toy_dispatch(4, np.ones((40, 2)), out, pending, [])
    assert pending[0] is earlier and len(pending) == 1 + len(plan.pieces)
    assert (out == -7.0).all()  # nothing landed: the caller's land does that
    assert (earlier[0] == 0.0).all()


def test_resolve_placement():
    assert t_driver.resolve_placement("cpu").devices == (torch.device("cpu"),)
    assert t_driver.resolve_placement(FOUR_CPUS, 1).nd == 4  # a sequence is taken as given
    place = rows_mod.Placement(["cpu"])
    assert t_driver.resolve_placement(place) is place
    if not torch.cuda.is_available():
        with pytest.raises(Exception, match="cuda"):
            t_driver.resolve_placement("cuda")


def test_four_shard_run_matches_one_shard(library, tmp_path, log_messages):
    """driver.run over four CPU shards against one, every family on."""
    outs = {}
    for tag, device in (("one", "cpu"), ("four", FOUR_CPUS)):
        cfg = _deck(RunConfig, library, tmp_path / f"{tag}.h5")
        m = t_driver.run(cfg, device=device)
        assert m.nuclides_done == len(DECK) and m.nuclides_quarantined == 0
        outs[tag] = cfg.output.path
    assert log_messages.count("row-sharded dispatch over 4 devices") == 1
    report = compare(outs["four"], outs["one"], rtol=SHARD_RTOL, atol=SHARD_ATOL)
    assert report["match"], {k: v for k, v in report["datasets"].items() if not v.get("ok")}
    assert any(k.endswith("/chi_total") for k in report["datasets"])


def test_four_shard_run_matches_the_reference_on_eight_devices(library, tmp_path):
    """The port over four CPU shards against the reference's run over its 8
    virtual devices (device.max_devices = 8), one small h1 deck with S(a,b)
    and free-gas."""
    assert jax.device_count() == 8
    j_cfg = _deck(j_config.RunConfig, library, tmp_path / "ref.h5", ["1001.80c"])
    j_cfg.device.max_devices = 8
    with exact_split_reference():
        assert j_driver.run(j_cfg).nuclides_done == 1
    t_cfg = _deck(RunConfig, library, tmp_path / "port.h5", ["1001.80c"])
    assert t_driver.run(t_cfg, device=FOUR_CPUS).nuclides_done == 1
    report = compare(t_cfg.output.path, j_cfg.output.path, rtol=LIB_RTOL, atol=LIB_ATOL)
    assert report["match"], {k: v for k, v in report["datasets"].items() if not v.get("ok")}


def test_auto_mesh_makes_the_reference_split():
    for n, shape in ((8, (2, 4)), (4, (2, 2)), (6, (2, 3)), (1, (1, 1))):
        mesh = t_mesh.auto_mesh(["cpu"] * n)
        assert mesh.shape == shape == j_mesh.auto_mesh(jax.devices()[:n]).devices.shape
        assert mesh.axis_names == ("nuclide", "e") and mesh.place.nd == n
    assert t_mesh.auto_mesh(["cpu"] * 8, n_nuclide=4).shape == (4, 2)
    with pytest.raises(ValueError):
        t_mesh.auto_mesh(["cpu"] * 6, n_nuclide=4)


@pytest.fixture(scope="module")
def meshes():
    return t_mesh.auto_mesh(["cpu"] * 8), j_mesh.auto_mesh(jax.devices())


def _batch(meshes):
    pn, pe = meshes[0].shape
    return ge._example_batch(2 * pn, 4 * pe)


def test_sharded_twobody_matches_the_reference(meshes):
    t_m, j_m = meshes
    e, knots, pdf, bounds, c1, c2, awr = _batch(meshes)
    arrays = {"e": e, "knots": knots, "pdf": pdf, "c1": c1, "c2": c2, "awr": awr}
    jp = j_mesh.place_batch(j_m, arrays)
    ref = np.asarray(j_mesh.sharded_twobody_moments(
        j_m, jp["e"], jp["knots"], jp["pdf"], jax.numpy.asarray(bounds), jp["c1"], jp["c2"], jp["awr"], order=3, nq=8,
    ))
    tp = t_mesh.place_batch(t_m, arrays)
    assert tp["e"].blocks[5].shape == (2, 4) and tp["awr"].blocks[5].shape == (2,)
    got = t_mesh.sharded_twobody_moments(
        t_m, tp["e"], tp["knots"], tp["pdf"], bounds, tp["c1"], tp["c2"], tp["awr"], order=3, nq=8
    )
    assert got.shape == ref.shape == (e.shape[0], e.shape[1], 4, bounds.size - 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-14)
    # host arrays work as well as placed blocks
    again = t_mesh.sharded_twobody_moments(t_m, e, knots, pdf, bounds, c1, c2, awr, order=3, nq=8)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_sharded_freegas_matches_the_reference(meshes, monkeypatch):
    t_m, j_m = meshes
    e, *_, awr = _batch(meshes)
    e_th = e * 1e-5  # the example energies (1e2-1e6 eV) moved into the thermal range
    bounds = np.concatenate([[0.0], np.geomspace(1e-4, 1e2, 13)])  # finite, covering
    with exact_split_reference() as fn:
        monkeypatch.setattr(j_fg, "freegas_moments_sab", fn)  # what the reference's mesh function imports
        ref = np.asarray(j_mesh.sharded_freegas_moments(j_m, jax.numpy.asarray(e_th), jax.numpy.asarray(awr), 0.0253,
                                                        jax.numpy.asarray(bounds), 2))
    got = t_mesh.sharded_freegas_moments(t_m, e_th, awr, 0.0253, bounds, 2)
    assert got.shape == ref.shape == (e.shape[0], e.shape[1], 3, bounds.size - 1)
    _assert_close(got.numpy().reshape(-1, 3, bounds.size - 1), ref.reshape(-1, 3, bounds.size - 1))


def test_sharded_chi_matches_the_reference(meshes):
    t_m, j_m = meshes
    _, knots, pdf, bounds, *_ = _batch(meshes)
    e_knots = (knots + 1.0) * 5e6  # the example's mu knots as outgoing energies, 0-1e7 eV
    p = pdf / 5e6
    ref = np.asarray(j_mesh.sharded_chi_fractions(j_m, jax.numpy.asarray(e_knots), jax.numpy.asarray(p),
                                                  jax.numpy.asarray(bounds)))
    got = t_mesh.sharded_chi_fractions(t_m, e_knots, p, bounds)
    assert got.shape == ref.shape == knots.shape[:2] + (bounds.size - 1,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got.numpy().sum(axis=-1), 1.0, rtol=1e-12)
