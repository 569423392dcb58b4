"""The benchmark's deck generator on the CPU: the same seed gives the same
ACE files byte for byte, another seed another deck of the same sizes, and
the port's parser reads back exactly the records the reference uses."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.gen import deck as deck_mod

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
