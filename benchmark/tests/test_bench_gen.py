"""The benchmark's deck generator on the CPU: the same seed gives the same
ACE files byte for byte, another seed another deck of the same sizes, and
the port's parser reads back exactly the records the reference uses. The
two-body deck is the one it was before the generator took continuum and
fission entries, byte for byte."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.gen import deck as deck_mod
from benchmark.tests.small_decks import continuum_fission

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 12345


def _cell(config: str, traffic: str):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    tr = json.loads((ROOT / "benchmark" / "workloads" / f"{traffic}.json").read_text())
    return cfg, tr


CELLS = [("xmas172-p5-structural", "xmas172-structural")]


def _files(d: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("config,traffic", CELLS)
def test_same_seed_same_bytes(tmp_path, config, traffic):
    cfg, tr = _cell(config, traffic)
    deck_mod.write(deck_mod.build(cfg, tr, SEED), tmp_path / "a")
    deck_mod.write(deck_mod.build(cfg, tr, SEED), tmp_path / "b")
    assert _files(tmp_path / "a") == _files(tmp_path / "b")


@pytest.mark.parametrize("config,traffic", CELLS)
def test_other_seed_other_deck_same_sizes(config, traffic):
    cfg, tr = _cell(config, traffic)
    a, b = deck_mod.build(cfg, tr, SEED), deck_mod.build(cfg, tr, SEED + 1)
    assert sorted(a.nuclides) == sorted(b.nuclides)
    for name, nuc in a.nuclides.items():
        other = b.nuclides[name]
        assert nuc.energy.size == other.energy.size  # the seed never changes a size
        assert sorted(nuc.reactions) == sorted(other.reactions)
    assert any(not np.array_equal(n.sigma_el, b.nuclides[k].sigma_el) for k, n in a.nuclides.items())


@pytest.mark.parametrize("config,traffic", CELLS)
def test_ace_files_parse_back_to_the_records(tmp_path, config, traffic):
    parse = pytest.importorskip("ndpp_tpu_torch.host.ace.parse")
    cfg, tr = _cell(config, traffic)
    deck = deck_mod.build(cfg, tr, SEED)
    deck_mod.write(deck, tmp_path)
    for name, nuc in deck.nuclides.items():
        back = parse.read_ace(tmp_path / f"{name}.ace", name_hint=name)
        assert (back.awr, back.kT, back.zaid) == (nuc.awr, nuc.kT, nuc.zaid)
        for key in ("energy", "sigma_el"):
            assert np.array_equal(getattr(back, key), getattr(nuc, key)), key
        assert sorted(back.reactions) == sorted(nuc.reactions)
        pairs = [(nuc.elastic_angular, back.elastic_angular)]
        for mt, rxn in nuc.reactions.items():
            got = back.reactions[mt]
            assert got.q == rxn.q and got.threshold_idx == rxn.threshold_idx
            assert np.array_equal(got.sigma, rxn.sigma)
            pairs.append((rxn.angular, got.angular))
        for mine, theirs in pairs:
            if mine is None:
                continue
            assert np.array_equal(mine.energies, theirs.energies)
            for t1, t2 in zip(mine.tables, theirs.tables):
                assert np.array_equal(t1.mu, t2.mu) and np.array_equal(t1.pdf, t2.pdf)


# sha256 over (file name, bytes) of the xmas172-structural deck's files, in
# name order, as the two-body-only generator wrote them
TWOBODY_DIGESTS = {2**31 + 12345: "752c8ef2eeb47aad6c8953bb2e256f674f870dc9a7ebb7b61ecb4af4d1684377",
                   3500000101: "9cdad6de2064840836aada32ad0d294b8e6dc63d1b6de084e959b31ef1858fb6"}


@pytest.mark.parametrize("seed", sorted(TWOBODY_DIGESTS))
def test_twobody_deck_is_unchanged(tmp_path, seed):
    cfg, tr = _cell("xmas172-p5-structural", "xmas172-structural")
    deck_mod.write(deck_mod.build(cfg, tr, seed), tmp_path)
    h = hashlib.sha256()
    for name, data in _files(tmp_path).items():
        h.update(name.encode())
        h.update(data)
    assert h.hexdigest() == TWOBODY_DIGESTS[seed]


def _same(a, b, where):
    """Records equal field by field, arrays bit for bit."""
    if a is None or b is None:
        assert a is None and b is None, where
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{k}]")
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            if f != "raw":
                _same(getattr(a, f), getattr(b, f, None), f"{where}.{f}")
    else:
        assert a == b, (where, a, b)


def test_continuum_and_fission_files_parse_back_to_the_records(tmp_path):
    """Every record a continuum or fission entry adds (law tables, Kalbach
    parameters, angular tables, analytic spectra, N-body data, nu, precursors,
    delayed spectra) reads back bit for bit through the port's parser."""
    parse = pytest.importorskip("ndpp_tpu_torch.host.ace.parse")
    _, cfg, tr = continuum_fission()
    deck = deck_mod.build(cfg, tr, SEED)
    deck_mod.write(deck, tmp_path)
    laws = set()
    for name, nuc in deck.nuclides.items():
        back = parse.read_ace(tmp_path / f"{name}.ace", name_hint=name)
        assert sorted(back.reactions) == sorted(nuc.reactions)
        for mt, rxn in nuc.reactions.items():
            got = back.reactions[mt]
            for f in ("q", "frame", "multiplicity", "threshold_idx", "angular_in_dlw"):
                assert getattr(got, f) == getattr(rxn, f), (name, mt, f)
            _same(rxn.sigma, got.sigma, f"{name} MT={mt} sigma")
            if rxn.angular is not None:
                _same(rxn.angular.energies, got.angular.energies, f"{name} MT={mt} AND")
                for t1, t2 in zip(rxn.angular.tables, got.angular.tables):
                    _same((t1.mu, t1.pdf, t1.cdf), (t2.mu, t2.pdf, t2.cdf), f"{name} MT={mt} AND table")
            assert len(got.energy_dists) == len(rxn.energy_dists)
            for ed, ged in zip(rxn.energy_dists, got.energy_dists):
                laws.add(ed.law)
                _same((ed.applicability.x, ed.applicability.y), (ged.applicability.x, ged.applicability.y),
                      f"{name} MT={mt} applicability")
                _same(ed.data, ged.data, f"{name} MT={mt} law {ed.law}")
        for k in ("nu_prompt", "nu_delayed", "nu_total"):
            mine, theirs = getattr(nuc, k), getattr(back, k)
            if mine is None:
                assert theirs is None
            else:
                _same((mine.tab.x, mine.tab.y), (theirs.tab.x, theirs.tab.y), f"{name} {k}")
        assert len(back.precursors) == len(nuc.precursors)
        for p1, p2 in zip(nuc.precursors, back.precursors):
            assert p1.decay_const == p2.decay_const
            _same((p1.probability.x, p1.probability.y), (p2.probability.x, p2.probability.y), f"{name} precursor")
        for ed, ged in zip(nuc.delayed_spectra, back.delayed_spectra):
            _same(ed.data, ged.data, f"{name} delayed")
    assert laws >= {3, 4, 9, 11, 44, 61, 66}


def test_continuum_sizes_come_from_the_entry():
    _, cfg, tr = continuum_fission()
    a, b = deck_mod.build(cfg, tr, SEED), deck_mod.build(cfg, tr, SEED + 1)
    for name, nuc in a.nuclides.items():
        other = b.nuclides[name]
        assert nuc.energy.size == other.energy.size and sorted(nuc.reactions) == sorted(other.reactions)
        for mt, rxn in nuc.reactions.items():
            for ed, ed2 in zip(rxn.energy_dists, other.reactions[mt].energy_dists):
                if ed.data.tables is not None:
                    assert [t.e_out.size for t in ed.data.tables] == [t.e_out.size for t in ed2.data.tables]
        assert len(nuc.precursors) == len(other.precursors)
