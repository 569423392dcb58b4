"""Nuclide-axis process parallelism (counterpart of ndpp_tpu/parallel/nuclides.py).

The library sweep is a bag of independent per-nuclide tasks whose host work
(parse, prep, write) is serial, so on a host with several cards the
nuclide-axis design is one worker process per card, each running the
ordinary single-device driver over a deterministic round-robin shard of the
nuclide list (cfg.shard = "i/N"), with a final HDF5 merge
(io.library.merge_libraries).

Device assignment: on cuda, worker i gets CUDA_VISIBLE_DEVICES=<i>, or the
i-th entry of the caller's CUDA_VISIBLE_DEVICES list where the caller sets
one. On a host with fewer cards than workers (or a caller's list shorter
than the worker count, whose extra workers get an empty list), a worker
with no card finds no device, exits 2 (driver.resolve_device raises
ConfigError) and the merge takes what the other workers completed; workers
are never mapped onto one card. On cpu the workers run the plain torch path.

Shards are HDF5, so run_workers needs h5py and refuses to start without it.
A profiled run (cfg.device.profile) is refused too: every worker would write
its trace to the same file beside the output.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

from ndpp_tpu_torch.utils.errors import ConfigError


def _worker_deck(cfg, i: int, n: int, out_path: Path) -> dict:
    """Nested deck dict for config.load, with this worker's shard/output."""
    d = cfg.to_dict()
    output = d.pop("output")
    device = d.pop("device")
    d["shard"] = f"{i}/{n}"
    output["path"] = str(out_path)
    # workers always emit HDF5 (the merge is HDF5-level); run_workers writes
    # the ASCII twin from the merged file when cfg asks for ascii/both
    output["format"] = "hdf5"
    return {"run": d, "output": output, "device": device}


def run_workers(
    cfg,
    n_workers: int,
    device: str = "cuda",
    env_extra: dict | None = None,
    timeout_s: float = 24 * 3600,
    debug_nans: bool = False,
) -> dict:
    """Run the sweep as n_workers shard subprocesses + merge; returns a summary.

    Worker i processes nuclides [i::n_workers] into <output>.shard<i>.h5 on
    `device`; all workers' outputs merge into cfg.output.path. Worker
    stdout/stderr stream to <output>.shard<i>.log. A nonzero worker exit
    (quarantines -> 3, no device -> 2) is carried into the summary, not
    raised: the merge still runs over whatever completed (the per-nuclide
    quarantine model, at process granularity). debug_nans passes
    ``--debug-nans`` to every worker.
    """
    if cfg.device.profile:
        raise ConfigError("run --workers cannot profile: every worker would write the same torch_trace.json")
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        raise ConfigError("run --workers writes HDF5 shards and merges them, and h5py is not installed") from e
    from ndpp_tpu_torch.io.library import merge_libraries
    from ndpp_tpu_torch.utils import log as log_mod

    log = log_mod.get()
    out = Path(cfg.output.path)
    # The merged file is HDF5. With format='ascii' cfg.output.path names the
    # ASCII file, so the HDF5 merge target moves aside; with 'both' the HDF5
    # keeps cfg.output.path and the twin lands at the open_writers .txt path.
    ascii_out = None
    if cfg.output.format == "ascii":
        ascii_out = out
        out = out.with_suffix(".h5")
    elif cfg.output.format == "both":
        ascii_out = out.with_suffix(".txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    caller_cards = os.environ.get("CUDA_VISIBLE_DEVICES")
    caller_cards = None if caller_cards is None else [c for c in caller_cards.split(",") if c.strip()]
    t0 = time.perf_counter()
    procs = []
    shard_paths = []
    for i in range(n_workers):
        shard_path = out.with_name(out.stem + f".shard{i}.h5")
        shard_paths.append(shard_path)
        deck_path = out.with_name(out.stem + f".shard{i}.json")
        deck_path.write_text(json.dumps(_worker_deck(cfg, i, n_workers, shard_path)))
        env = dict(os.environ)
        if device == "cuda":  # one card per worker
            if caller_cards is None:
                env["CUDA_VISIBLE_DEVICES"] = str(i)
            else:
                env["CUDA_VISIBLE_DEVICES"] = caller_cards[i] if i < len(caller_cards) else ""
        if env_extra:
            env.update(env_extra)
        log_path = out.with_name(out.stem + f".shard{i}.log")
        logf = open(log_path, "w")
        cmd = [sys.executable, "-m", "ndpp_tpu_torch", "run", "-c", str(deck_path), "--device", device]
        if cfg.resume:
            cmd.append("--resume")
        if debug_nans:
            cmd.append("--debug-nans")
        procs.append((i, subprocess.Popen(cmd, env=env, stdout=logf, stderr=subprocess.STDOUT), logf))
        log.info("worker %d/%d started (shard -> %s)", i, n_workers, shard_path.name)

    rcs = {}
    for i, p, logf in procs:
        try:
            rcs[i] = p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rcs[i] = -9
        logf.close()
        log.info("worker %d exited rc=%d", i, rcs[i])

    present = [sp for sp in shard_paths if sp.exists()]
    merged = merge_libraries(out, present) if present else 0
    if ascii_out is not None and merged:
        from ndpp_tpu_torch.io.library import write_ascii_from_hdf5

        n_ascii = write_ascii_from_hdf5(out, ascii_out)
        log.info("ASCII twin written: %s (%d nuclides)", ascii_out, n_ascii)
    summary = {
        "workers": n_workers,
        "worker_rcs": rcs,
        "merged_nuclides": merged,
        "wall_seconds": time.perf_counter() - t0,
        "output": str(out),
        "shards": [str(s) for s in present],
    }
    log.info("run_workers complete: %s", json.dumps(summary))
    return summary
