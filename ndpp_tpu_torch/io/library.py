"""Group-wise moment library writers (HDF5 + ASCII) and comparator.

The reference writes HDF5 and/or ASCII moment libraries (SURVEY.md section
3.5). Its exact schema is not bundled with the repo, so this is the
documented, versioned 'NDPP-TPU library format v1' (docs/format.md;
SURVEY.md section 3.5 mandates the versioned schema + comparator as the
bit-compat readiness story). Nuclide-at-a-time writes with a ``complete``
attribute are the checkpoint/resume mechanism (SURVEY.md section 5).

The format is the reference package's (ndpp_tpu/io/library.py): the same
schema and datasets, with only the generator/version strings naming the
port. h5py is imported only inside the HDF5 paths, so ASCII libraries are
written, read and compared without it. The shard merge (``merge``, the
worker runs of parallel/nuclides) and the ASCII twin of a merged library are
HDF5-level, so they need h5py.
"""

from __future__ import annotations

import datetime
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ndpp_tpu_torch.groups import GroupStructure
from ndpp_tpu_torch.version import LIBRARY_FORMAT_VERSION, __version__


@dataclass
class NuclideResult:
    """Everything the pipeline computed for one nuclide."""

    name: str
    zaid: int
    awr: float
    kT: float  # eV (ACE table base temperature)
    energy: np.ndarray  # (NE,) eV — moment tabulation grid
    temperatures: np.ndarray  # (NT,) Kelvin
    scatter: np.ndarray  # (NT, NE, L+1, G) transfer moments per unit scatter
    sigma_scatter: np.ndarray  # (NE,) total scattering xs (weights denominator)
    chi_energy: np.ndarray | None = None  # (NEchi,) incident grid for chi
    chi_prompt: np.ndarray | None = None  # (NEchi, G)
    chi_delayed: np.ndarray | None = None  # (NEchi, G) combined delayed
    chi_total: np.ndarray | None = None  # (NEchi, G)
    nu_prompt: np.ndarray | None = None  # (NEchi,)
    nu_delayed: np.ndarray | None = None  # (NEchi,)
    nu_total: np.ndarray | None = None  # (NEchi,)
    extra: dict = field(default_factory=dict)


_OPTIONAL_SETS = (
    "chi_energy",
    "chi_prompt",
    "chi_delayed",
    "chi_total",
    "nu_prompt",
    "nu_delayed",
    "nu_total",
)


class HDF5LibraryWriter:
    def __init__(
        self,
        path: str | Path,
        gs: GroupStructure,
        order: int,
        temperatures: list[float],
        config_json: str = "{}",
        resume: bool = False,
    ):
        import h5py

        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if resume and self.path.exists():
            try:
                self.f = h5py.File(self.path, "a")
            except OSError:
                # A hard kill mid-write (watchdog os._exit, SIGKILL, power
                # loss) can corrupt the HDF5 superblock, and an unattended
                # resume must not die on it: quarantine the corrupt file
                # under a .corrupt-<unix time> suffix and start fresh.
                import time as _time

                bad = self.path.with_name(f"{self.path.name}.corrupt-{int(_time.time())}")
                self.path.rename(bad)
                from ndpp_tpu_torch.utils import log as log_mod

                log_mod.get().warning(
                    "resume target %s is unreadable HDF5 — moved to %s, starting fresh",
                    self.path,
                    bad.name,
                )
                self.f = h5py.File(self.path, "w")
        else:
            self.f = h5py.File(self.path, "w")
        if "group_structure" not in self.f:
            self.f.attrs["format_version"] = LIBRARY_FORMAT_VERSION
            self.f.attrs["ndpp_tpu_version"] = __version__
            self.f.attrs["created"] = datetime.datetime.now(datetime.UTC).isoformat()
            self.f.attrs["legendre_order"] = order
            self.f.create_dataset("config", data=config_json)
            g = self.f.create_group("group_structure")
            g.create_dataset("bounds", data=gs.bounds)
            g.attrs["name"] = gs.name
            g.attrs["units"] = "eV"
            g.attrs["convention"] = "ascending"
            g.attrs["checksum"] = gs.checksum()
            for k, v in gs.meta.items():
                # provenance of imported boundary tables (groups.import_table)
                g.attrs[f"provenance_{k}"] = str(v)
            self.f.create_dataset("temperatures", data=np.asarray(temperatures, dtype=np.float64))
            self.f.create_group("nuclides")

    def is_complete(self, name: str) -> bool:
        grp = self.f.get(f"nuclides/{name}")
        return bool(grp is not None and grp.attrs.get("complete", 0))

    def write_nuclide(self, res: NuclideResult) -> None:
        nucs = self.f["nuclides"]
        if res.name in nucs:
            del nucs[res.name]
        g = nucs.create_group(res.name)
        g.attrs["zaid"] = res.zaid
        g.attrs["awr"] = res.awr
        g.attrs["kT_eV"] = res.kT
        g.attrs["complete"] = 0
        g.create_dataset("energy", data=res.energy)
        g.create_dataset("temperatures", data=res.temperatures)
        g.create_dataset("scatter", data=res.scatter)
        g.create_dataset("sigma_scatter", data=res.sigma_scatter)
        for key in _OPTIONAL_SETS:
            val = getattr(res, key)
            if val is not None:
                g.create_dataset(key, data=val)
        for k, v in res.extra.items():
            g.create_dataset(f"extra/{k}", data=v)
        g.attrs["complete"] = 1  # written last: the resume marker
        self.f.flush()

    def finalize(self, metrics: dict | None = None) -> None:
        if metrics is not None:
            if "metrics" in self.f:
                del self.f["metrics"]
            self.f.create_dataset("metrics", data=json.dumps(metrics))
        self.f.close()


class AsciiLibraryWriter:
    """Mirror of the HDF5 content in a fixed, line-oriented text format (docs/format.md)."""

    def __init__(
        self,
        path: str | Path,
        gs: GroupStructure,
        order: int,
        temperatures: list[float],
        config_json: str = "{}",
        resume: bool = False,
    ):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._complete: set[str] = set()
        if resume and self.path.exists():
            # Resume bookkeeping: a nuclide is complete iff its block closed
            # with the matching end_nuclide marker (the ASCII analog of the
            # HDF5 'complete' attribute). Blocks may repeat across resumed
            # appends; the reader's last-block-wins semantics makes that safe.
            with open(self.path) as fh:
                for line in fh:
                    if line.startswith("end_nuclide "):
                        self._complete.add(line.split()[1])
        self.fh = open(self.path, "a" if resume and self.path.exists() else "w")
        if self.fh.tell() == 0:
            w = self.fh.write
            w(f"NDPP-TPU ASCII LIBRARY {LIBRARY_FORMAT_VERSION}\n")
            w(f"generator ndpp-tpu-torch {__version__}\n")
            w(f"legendre_order {order}\n")
            w(f"temperatures {len(temperatures)} " + " ".join(f"{t:.17E}" for t in temperatures) + "\n")
            w(f"group_structure {gs.name} {gs.ng}\n")
            self._write_array(gs.bounds)
            if gs.meta:
                w("group_provenance " + json.dumps(gs.meta, sort_keys=True) + "\n")

    def _write_array(self, arr: np.ndarray) -> None:
        # 17 significant digits: a float64 round-trips exactly through the
        # text form, so HDF5 and ASCII twins compare bit-equal (format 1.1).
        # Width 26, not 25: sign + 19-char mantissa + E+3-digit exponent is
        # 25 chars, and a zero-width separator glues tokens together.
        flat = np.asarray(arr).ravel()
        for i in range(0, flat.size, 4):
            self.fh.write("".join(f"{v:26.17E}" for v in flat[i : i + 4]) + "\n")

    def is_complete(self, name: str) -> bool:
        return name in self._complete

    def write_nuclide(self, res: NuclideResult) -> None:
        w = self.fh.write
        # full-precision scalars: the ASCII twin is a lossless mirror (1.1+)
        w(f"nuclide {res.name} zaid {res.zaid} awr {res.awr:.17E} kT_eV {res.kT:.17E}\n")
        w(f"energy {res.energy.size}\n")
        self._write_array(res.energy)
        w(f"temperatures {res.temperatures.size}\n")
        self._write_array(res.temperatures)
        nt, ne, lp1, ng = res.scatter.shape
        w(f"scatter {nt} {ne} {lp1} {ng}\n")
        self._write_array(res.scatter)
        w(f"sigma_scatter {res.sigma_scatter.size}\n")
        self._write_array(res.sigma_scatter)
        for key in _OPTIONAL_SETS:
            val = getattr(res, key)
            if val is not None:
                val = np.asarray(val)
                w(f"{key} " + " ".join(str(s) for s in val.shape) + "\n")
                self._write_array(val)
        for k, v in res.extra.items():
            v = np.atleast_1d(np.asarray(v, dtype=np.float64))
            w(f"extra/{k} " + " ".join(str(s) for s in v.shape) + "\n")
            self._write_array(v)
        w(f"end_nuclide {res.name}\n")
        self.fh.flush()
        self._complete.add(res.name)

    def finalize(self, metrics: dict | None = None) -> None:
        if metrics is not None:
            self.fh.write("metrics " + json.dumps(metrics) + "\n")
        self.fh.write("end_library\n")
        self.fh.close()


def open_writers(cfg, gs: GroupStructure):
    """Writers selected by config.output.format; HDF5 path also drives resume."""
    writers = []
    path = Path(cfg.output.path)
    if cfg.output.format in ("hdf5", "both"):
        writers.append(
            HDF5LibraryWriter(path, gs, cfg.legendre_order, cfg.temperatures, cfg.to_json(), cfg.resume)
        )
    if cfg.output.format in ("ascii", "both"):
        apath = path.with_suffix(".txt") if cfg.output.format == "both" else path
        writers.append(
            AsciiLibraryWriter(apath, gs, cfg.legendre_order, cfg.temperatures, cfg.to_json(), cfg.resume)
        )
    return writers


def merge_libraries(dst: str | Path, srcs: list[str | Path]) -> int:
    """Merge shard HDF5 libraries into one (nuclide-axis process sharding).

    Header/group-structure/temperatures come from the first source and are
    VALIDATED identical (checksum, bounds, temperatures, order) across all
    sources; nuclide groups are copied (later sources win on duplicates).
    Returns the merged nuclide count.
    """
    import h5py

    srcs = [Path(s) for s in srcs]
    if not srcs:
        raise ValueError("merge_libraries: no source libraries")
    dst = Path(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(dst, "w") as out:
        n = 0
        ref_meta = None
        skipped: list[str] = []
        for k, src in enumerate(srcs):
            with h5py.File(src, "r") as f:
                meta = (
                    f["group_structure"].attrs["checksum"],
                    tuple(f["group_structure/bounds"][()]),
                    tuple(f["temperatures"][()]),
                    int(f.attrs["legendre_order"]),
                )
                if k == 0:
                    ref_meta = meta
                    for key in ("group_structure", "temperatures", "config"):
                        f.copy(key, out)
                    for a in ("format_version", "ndpp_tpu_version", "created", "legendre_order"):
                        out.attrs[a] = f.attrs[a]
                    out.create_group("nuclides")
                elif meta != ref_meta:
                    raise ValueError(
                        f"merge_libraries: {src} header (groups/temps/order) differs from {srcs[0]}"
                    )
                for name in f["nuclides"]:
                    # a crashed worker may leave a partially written group
                    # (complete=0, datasets possibly missing): merging it
                    # would poison readers and resume bookkeeping -- skip it
                    if not f[f"nuclides/{name}"].attrs.get("complete", 0):
                        skipped.append(f"{src.name}:{name}")
                        continue
                    if name in out["nuclides"]:
                        del out[f"nuclides/{name}"]
                    f.copy(f"nuclides/{name}", out["nuclides"])
                    n += 1
    if skipped:
        from ndpp_tpu_torch.utils import log as log_mod

        log_mod.get().warning(
            "merge_libraries: skipped %d incomplete nuclide group(s): %s", len(skipped), skipped
        )
    return n


def write_ascii_from_hdf5(h5_path: str | Path, ascii_path: str | Path) -> int:
    """Write the lossless ASCII twin of an HDF5 library; returns nuclide count.

    Used after a worker-sharded run's HDF5 merge (parallel/nuclides): shard
    workers always write HDF5 (the merge is HDF5-level), so an 'ascii'/'both'
    output format is honored by mirroring the merged file. Only complete
    nuclide groups are written (the ASCII end_nuclide marker means complete).
    """
    import h5py

    with h5py.File(h5_path, "r") as f:
        cfg_json = f["config"][()]
        if isinstance(cfg_json, bytes):
            cfg_json = cfg_json.decode()
        gs = GroupStructure(
            name=str(f["group_structure"].attrs["name"]), bounds=f["group_structure/bounds"][()]
        )
        w = AsciiLibraryWriter(
            ascii_path, gs, int(f.attrs["legendre_order"]), list(f["temperatures"][()]), cfg_json
        )
        n = 0
        for name in f["nuclides"]:
            g = f[f"nuclides/{name}"]
            if not g.attrs.get("complete", 0):
                continue
            res = NuclideResult(
                name=name,
                zaid=int(g.attrs["zaid"]),
                awr=float(g.attrs["awr"]),
                kT=float(g.attrs["kT_eV"]),
                energy=g["energy"][()],
                temperatures=g["temperatures"][()],
                scatter=g["scatter"][()],
                sigma_scatter=g["sigma_scatter"][()],
                **{k: g[k][()] for k in _OPTIONAL_SETS if k in g},
                extra={k: g[f"extra/{k}"][()] for k in g["extra"]} if "extra" in g else {},
            )
            w.write_nuclide(res)
            n += 1
        metrics = None
        if "metrics" in f:
            m = f["metrics"][()]
            metrics = json.loads(m.decode() if isinstance(m, bytes) else m)
        w.finalize(metrics)
    return n


# --------------------------------------------------------------------------
# Readers (ASCII read-back) + format-agnostic comparator
# (SURVEY.md section 3.5: tolerance-aware comparison tool)


def read_ascii(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    """Parse an NDPP-TPU ASCII library (docs/format.md) back into memory.

    Returns (datasets, attrs): ``datasets`` maps HDF5-style paths
    (``/nuclides/<name>/scatter`` ...) to float64 arrays — the SAME keys the
    HDF5 walk produces, so the comparator works across formats; ``attrs``
    carries the scalar header metadata.
    """
    datasets: dict[str, np.ndarray] = {}
    attrs: dict = {}
    with open(path) as fh:
        lines = iter(fh.read().splitlines())

    def read_values(n: int) -> np.ndarray:
        vals: list[str] = []
        while len(vals) < n:
            vals.extend(next(lines).split())
        if len(vals) != n:
            raise ValueError(f"ASCII library: expected {n} values, got {len(vals)}")
        return np.asarray(vals, dtype=np.float64)

    header = next(lines)
    if not header.startswith("NDPP-TPU ASCII LIBRARY"):
        raise ValueError(f"not an NDPP-TPU ASCII library: {path}")
    attrs["format_version"] = header.split()[-1]
    nuclide: str | None = None
    # Per-nuclide blocks buffer until their end_nuclide marker commits them:
    # a resumed run appends past a prior finalize()'s end_library (a SOFT
    # marker), may re-write a nuclide's block (last complete block wins),
    # and may leave a truncated tail after a crash (dropped, never merged).
    pending: dict[str, np.ndarray] = {}
    pending_attrs: dict = {}
    try:
        for line in lines:
            tok = line.split()
            if not tok:
                continue
            key = tok[0]
            if key == "generator":
                attrs["generator"] = " ".join(tok[1:])
            elif key == "legendre_order":
                attrs["legendre_order"] = int(tok[1])
            elif key == "temperatures" and nuclide is None:
                datasets["/temperatures"] = np.asarray(tok[2:], dtype=np.float64)
            elif key == "group_structure":
                attrs["group_structure_name"] = tok[1]
                ng = int(tok[2])
                datasets["/group_structure/bounds"] = read_values(ng + 1)
            elif key == "nuclide":
                nuclide = tok[1]
                pending = {}
                pending_attrs = {
                    f"{nuclide}/zaid": int(tok[3]),
                    f"{nuclide}/awr": float(tok[5]),
                    f"{nuclide}/kT_eV": float(tok[7]),
                }
            elif key == "end_nuclide":
                if nuclide is not None:
                    # drop any stale datasets from an earlier block of the
                    # same nuclide before committing the new one
                    prefix = f"/nuclides/{nuclide}/"
                    for stale in [k for k in datasets if k.startswith(prefix)]:
                        del datasets[stale]
                    datasets.update(pending)
                    attrs.update(pending_attrs)
                nuclide = None
            elif key == "group_provenance":
                attrs["group_provenance"] = json.loads(line[len("group_provenance ") :])
            elif key == "metrics":
                attrs["metrics"] = json.loads(line[len("metrics ") :])
            elif key == "end_library":
                nuclide = None  # soft marker: resumed appends continue past it
            else:
                # generic per-nuclide block: "<name> <d0> [d1 ...]" + values
                if nuclide is None:
                    raise ValueError(f"ASCII library: unexpected line outside nuclide block: {line!r}")
                shape = tuple(int(d) for d in tok[1:])
                arr = read_values(int(np.prod(shape))).reshape(shape)
                pending[f"/nuclides/{nuclide}/{key}"] = arr
    except (StopIteration, ValueError):
        # Truncated tail (crash mid-block OR mid-value-line — a partial
        # float token like '1.2345E' raises ValueError in read_values):
        # committed blocks stand, the incomplete block is dropped, per the
        # format-1.2 promise that a truncated tail is never half-merged.
        pass
    return datasets, attrs


_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def is_hdf5(path: str | Path) -> bool:
    """True when the file starts with the 8-byte HDF5 signature (h5py writes
    no user block, so the signature sits at offset 0)."""
    with open(path, "rb") as fh:
        return fh.read(len(_HDF5_SIGNATURE)) == _HDF5_SIGNATURE


def load_datasets(path: str | Path) -> dict[str, np.ndarray]:
    """Flat {path: float array} view of a library file, either format.

    Dispatches on content (the HDF5 signature), not extension. String
    datasets (config/metrics JSON) are excluded — they are provenance, not
    data.
    """
    path = Path(path)
    if is_hdf5(path):
        import h5py

        out: dict[str, np.ndarray] = {}
        with h5py.File(path, "r") as f:

            def walk(g, prefix=""):
                for key in g:
                    p = f"{prefix}/{key}"
                    obj = g[key]
                    if isinstance(obj, h5py.Group):
                        walk(obj, p)
                    else:
                        a = obj[()]
                        if isinstance(a, bytes) or (hasattr(a, "dtype") and a.dtype.kind in "SU"):
                            continue
                        out[p] = np.asarray(a, dtype=np.float64)

            walk(f)
        return out
    return read_ascii(path)[0]


def compare(path_a: str | Path, path_b: str | Path, rtol: float = 1e-8, atol: float = 0.0) -> dict:
    """Compare two libraries (HDF5 or ASCII, any mix); per-dataset max errors."""
    report: dict = {"match": True, "rtol": rtol, "datasets": {}, "missing": []}
    da = load_datasets(path_a)
    db = load_datasets(path_b)
    for pa in sorted(set(da) | set(db)):
        if pa not in db or pa not in da:
            report["missing"].append(pa + (" (in A only)" if pa in da else " (in B only)"))
            report["match"] = False
            continue
        a, b = da[pa], db[pa]
        if a.shape != b.shape:
            report["datasets"][pa] = {"shape_a": list(a.shape), "shape_b": list(b.shape)}
            report["match"] = False
            continue
        denom = np.maximum(np.abs(a), np.abs(b))
        err = np.abs(a - b)
        rel = np.where(denom > 0, err / np.where(denom > 0, denom, 1.0), 0.0)
        max_rel = float(rel.max()) if rel.size else 0.0
        max_abs = float(err.max()) if err.size else 0.0
        ok = bool(np.all(err <= atol + rtol * denom))
        report["datasets"][pa] = {"max_rel": max_rel, "max_abs": max_abs, "ok": ok}
        if not ok:
            report["match"] = False
    return report
