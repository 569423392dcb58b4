"""A cell's deck from its configuration, its traffic file and the seed.

The configuration (benchmark/configs/<config>.json) holds the catalog of
nuclides the deployment's library stands for, each with its sizes; the
traffic file (benchmark/workloads/<cell>.json) names the catalog entries of
the deck, in sweep order, and its S(alpha,beta) assignments. The seed draws
every value, and never a size nor the order of the sweep: every seed gives
the same work, and each pass starts with the same nuclide.
The port gets only the ACE files and the xsdir written here; the reference
keeps the records in memory.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import ace_values, synth
from .records import Nuclide
from .write import write_ace


@dataclass
class Deck:
    nuclides: dict[str, Nuclide]  # ACE name -> records, in sweep order
    stand_in: dict[str, str]  # ACE name -> catalog key
    xsdir: Path | None = None

    @property
    def order(self) -> list[str]:
        return list(self.nuclides)


def _rng(seed: int, key: str) -> np.random.Generator:
    """One stream per catalog entry, so adding an entry moves no other."""
    return np.random.default_rng([int(seed) % (1 << 63), zlib.crc32(key.encode())])


def build(config: dict, traffic: dict, seed: int, keys=None, n_base: int | None = None) -> Deck:
    """The deck's records: the traffic's catalog entries, in its order.
    keys and n_base: a warm-up deck of those entries on smaller grids (the
    same reactions, laws and tables, so the same code and kernels)."""
    catalog = config["catalog"]
    nuclides, stand_in = {}, {}
    for key in keys or traffic["deck"]:
        spec = dict(catalog[key])
        if n_base is not None:
            spec["n_base"], spec["resonances"] = n_base, 0
        name = f"{spec['zaid']}.80c"
        nuclides[name] = ace_values.nuclide(synth.twobody_nuclide(name, spec, _rng(seed, key)))
        stand_in[name] = key
    return Deck(nuclides=nuclides, stand_in=stand_in)


def write(deck: Deck, outdir: Path) -> Path:
    """Every nuclide as an ACE file under outdir, and the xsdir that lists
    them."""
    outdir.mkdir(parents=True, exist_ok=True)
    lines = []
    for name, nuc in deck.nuclides.items():
        p = write_ace(nuc, outdir / f"{name}.ace")
        lines.append(f"{nuc.name} {nuc.awr:.6f} {p.name} 0 1 1 0")
    deck.xsdir = outdir / "xsdir"
    deck.xsdir.write_text("directory\n" + "\n".join(lines) + "\n")
    return deck.xsdir
