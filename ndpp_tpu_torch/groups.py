"""Energy group structures.

The reference names its structures in the input deck (47-group coarse,
XMAS-172, SHEM-361; SURVEY.md section 8.4, BASELINE.json configs). The exact
published boundary tables are NOT bundled with the repo and are NOT reconstructed
from memory (SURVEY.md section 8.4: do not fabricate). Instead:

  - ``uniform-lethargy-{47,172,361}``: synthetic, exactly reproducible
    stand-ins with the right group counts, used by tests/benchmarks. They are
    deliberately named so they cannot be mistaken for the published structures.
  - user-supplied boundaries via a file (one boundary per line, eV) or an
    explicit list in the config — this is how the published tables are used
    once their boundary data is available to the user.

Conventions: boundaries are stored ascending in energy (eV). Group ``g``
(0-based, ascending) spans ``[bounds[g], bounds[g+1])``. Writers may flip to
the transport convention (group 1 = highest energy) at output time; the HDF5
schema records the convention explicitly (docs/format.md).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ndpp_tpu_torch.utils.errors import ConfigError

# Standard-ish energy span for the synthetic structures: 1e-5 eV .. 2e7 eV
# (the conventional ENDF thermal floor and a 20 MeV ceiling).
_SYNTH_EMIN_EV = 1.0e-5
_SYNTH_EMAX_EV = 2.0e7


@dataclass(frozen=True)
class GroupStructure:
    """An energy group structure: ``ng`` groups bounded by ``ng+1`` ascending boundaries (eV)."""

    name: str
    bounds: np.ndarray = field(repr=False)  # shape (ng+1,), float64, ascending, eV
    # Provenance from an imported table's '# key: value' header (source
    # path, source_sha256, imported date, ...) — echoed into library
    # metadata so every output names where its boundaries came from.
    meta: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self) -> None:
        b = np.asarray(self.bounds, dtype=np.float64)
        if b.ndim != 1 or b.size < 2:
            raise ConfigError(f"group structure '{self.name}': need >=2 boundaries")
        if not np.all(np.diff(b) > 0):
            raise ConfigError(f"group structure '{self.name}': boundaries must be strictly ascending")
        if b[0] <= 0:
            raise ConfigError(f"group structure '{self.name}': boundaries must be positive energies (eV)")
        object.__setattr__(self, "bounds", b)

    @property
    def ng(self) -> int:
        return self.bounds.size - 1

    @property
    def emin(self) -> float:
        return float(self.bounds[0])

    @property
    def emax(self) -> float:
        return float(self.bounds[-1])

    def group_of(self, energy_ev: np.ndarray | float) -> np.ndarray:
        """0-based ascending group index; -1 below range, ng at/above the top boundary."""
        e = np.asarray(energy_ev, dtype=np.float64)
        idx = np.searchsorted(self.bounds, e, side="right") - 1
        idx = np.where(e >= self.bounds[-1], self.ng, idx)
        return idx

    def checksum(self) -> str:
        return hashlib.sha256(self.bounds.tobytes()).hexdigest()[:16]


def uniform_lethargy(name: str, ng: int, emin: float = _SYNTH_EMIN_EV, emax: float = _SYNTH_EMAX_EV) -> GroupStructure:
    """ng groups equally spaced in lethargy (log-uniform in E) between emin and emax (eV)."""
    bounds = np.exp(np.linspace(np.log(emin), np.log(emax), ng + 1))
    # Pin the ends exactly so round-tripping through logs can't move them.
    bounds[0], bounds[-1] = emin, emax
    return GroupStructure(name=name, bounds=bounds)


def from_file(path: str | Path, name: str | None = None) -> GroupStructure:
    """Load boundaries from a text file: one boundary per line (eV), '#' comments, any order.

    '# key: value' comment lines are collected as provenance metadata
    (written by the reference CLI's `ndpp groups import`, echoed into library output).
    """
    p = Path(path)
    vals = []
    meta: dict = {}
    for line in p.read_text().splitlines():
        if line.lstrip().startswith("#"):
            body = line.lstrip()[1:].strip()
            if ":" in body:
                k, _, v = body.partition(":")
                if k.strip() and " " not in k.strip():
                    meta[k.strip()] = v.strip()
            continue
        line = line.split("#", 1)[0].strip().replace(",", " ")
        if not line:
            continue
        vals.extend(float(tok) for tok in line.split())
    bounds = np.sort(np.unique(np.asarray(vals, dtype=np.float64)))
    return GroupStructure(name=name or meta.get("name") or p.stem, bounds=bounds, meta=meta)


def user_groups_dir() -> Path:
    """Directory where imported boundary tables live (NDPP_GROUPS_DIR)."""
    import os

    return Path(os.environ.get("NDPP_GROUPS_DIR", "~/.config/ndpp/groups")).expanduser()


def import_table(src: str | Path, name: str | None = None, dest_dir: str | Path | None = None) -> GroupStructure:
    """Validate + install a user-supplied boundary table (SURVEY.md section 8.4).

    The published structures (casmo-47, xmas-172, shem-361) are data this
    package does not carry and will not fabricate; once a user HAS the
    published boundaries, importing them here makes the published name
    resolvable in configs with zero code changes:

      - the source file is parsed and validated (strictly ascending after
        sort/dedup, positive, >= 2 boundaries -- GroupStructure.__post_init__);
      - a canonical table is written to ``<dest_dir>/<name>.txt`` with a
        provenance header: source path, source file sha256, import date,
        boundary checksum, group count;
      - :func:`get` resolves names from that directory, and library
        writers echo the provenance block into output metadata.

    Input format: one boundary per line in eV ('#' comments and blank
    lines ignored, commas allowed, any order; duplicates collapse).
    Returns the GroupStructure loaded back from the canonical file.
    """
    import datetime

    src = Path(src)
    gs = from_file(src, name)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    dest_root = Path(dest_dir) if dest_dir is not None else user_groups_dir()
    dest_root.mkdir(parents=True, exist_ok=True)
    dest = dest_root / f"{gs.name}.txt"
    header = [
        f"# name: {gs.name}",
        f"# source: {src.resolve()}",
        f"# source_sha256: {digest}",
        f"# imported: {datetime.date.today().isoformat()}",
        f"# boundaries_sha256_16: {gs.checksum()}",
        f"# groups: {gs.ng}",
        "# format: one boundary per line, eV; '#' comments ignored; sorted+deduped on load",
    ]
    dest.write_text("\n".join(header) + "\n" + "\n".join(f"{b:.17E}" for b in gs.bounds) + "\n")
    return from_file(dest, gs.name)


_REGISTRY_BUILDERS = {
    "uniform-lethargy-47": lambda: uniform_lethargy("uniform-lethargy-47", 47),
    "uniform-lethargy-172": lambda: uniform_lethargy("uniform-lethargy-172", 172),
    "uniform-lethargy-361": lambda: uniform_lethargy("uniform-lethargy-361", 361),
}

# The published structures named by the reference configs. Boundary data is not
# shipped (see module docstring); using one of these names without providing a
# boundary file is a configuration error with a helpful message.
_PUBLISHED_NAMES = {"casmo-47", "xmas-172", "shem-361"}


def get(name_or_path: str, ng_hint: int | None = None) -> GroupStructure:
    """Resolve a group structure: registry name, imported table name, or file path."""
    if name_or_path in _REGISTRY_BUILDERS:
        return _REGISTRY_BUILDERS[name_or_path]()
    # imported tables (ndpp groups import) make any name — including the
    # published ones — resolvable as data, with provenance attached
    if "/" not in name_or_path:
        imported = user_groups_dir() / f"{name_or_path}.txt"
        if imported.exists():
            return from_file(imported, name_or_path)
    if name_or_path in _PUBLISHED_NAMES:
        raise ConfigError(
            f"group structure '{name_or_path}' is a published table whose boundary data "
            f"is not bundled; import it once (`ndpp groups import /path/to/{name_or_path}.txt "
            f"--name {name_or_path}`), supply it as a boundary file path, "
            f"or use the synthetic stand-in 'uniform-lethargy-{name_or_path.split('-')[-1]}'"
        )
    p = Path(name_or_path)
    if p.exists():
        return from_file(p)
    raise ConfigError(
        f"unknown group structure '{name_or_path}'; known: {sorted(_REGISTRY_BUILDERS)}, "
        f"an imported table name ({user_groups_dir()}), or a boundary file path"
    )


def names() -> list[str]:
    out = sorted(_REGISTRY_BUILDERS)
    d = user_groups_dir()
    if d.is_dir():
        out += sorted(f"{p.stem}" for p in d.glob("*.txt"))
    return out
