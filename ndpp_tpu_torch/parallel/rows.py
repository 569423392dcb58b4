"""Row tiling for one device (counterpart of ndpp_tpu/parallel/rows.py).

Every moment kernel is independent across incident-energy rows, so the
driver cuts each row pool into tiles of at most ``device.e_tile`` rows and
sends each tile to the run's device. The reference shards tiles over a
TPU mesh and pads them onto a three-step shape ladder to keep remote
compiles scarce; eager torch has no compile per shape, so here a tile is a
plain slice and only the last one is shorter. A multi-GPU row split is
ROADMAP A12.

Inputs of a dispatch set go to the device once (put_rows on the whole row
pool, tiles are slices of the device tensor); each tile's result starts its
copy back as soon as it is enqueued (fetch_rows) and the host waits once per
dispatch set (land_rows).
"""

from __future__ import annotations

import numpy as np
import torch

from ndpp_tpu_torch.utils.errors import NdppError

# `run --debug-nans`: land_rows checks every result it lands for non-finite
# values. driver.run sets it for the length of a run; off, land_rows does no
# extra work and no extra wait.
debug_nans = False


class NonFiniteResult(NdppError):
    """A family's device result holds NaN or Inf (found under debug_nans)."""


def tile_for(n: int, cap: int, e_tile: int = 512) -> int:
    """Rows per dispatch: the cap, or all n rows when fewer.

    `cap` is an op family's row budget at the default device.e_tile = 512
    and scales with e_tile (floored at 16), so the driver's device-OOM retry,
    which halves e_tile, shrinks every family's tiles, not just the two-body
    path's (whose cap is e_tile itself)."""
    return max(1, min(n, max(16, cap * e_tile // 512)))


def put_rows(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host float array -> float64 tensor on `device`."""
    return torch.as_tensor(np.ascontiguousarray(arr, dtype=np.float64), device=device)


def put_replicated(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host table that every tile of a dispatch reads (group bounds, a law's
    shared mu knots) -> float64 tensor on `device`: copied once per dispatch
    set, never per tile. (With one device this is put_rows; the multi-GPU
    row split, ROADMAP A12, copies it to every device.)"""
    return put_rows(arr, device)


def fetch_rows(res: torch.Tensor) -> torch.Tensor:
    """Start the copy of a tile's result to the host and return the host
    tensor. From the card the copy is enqueued on the current stream, lands
    in pinned memory and does not wait (land_rows waits once for all of
    them); from the CPU it returns `res` itself."""
    return res.to("cpu", non_blocking=True)


def land_rows(pending: list, device: torch.device, family: str) -> None:
    """Wait ONCE for every fetch_rows copy enqueued on `device`, then store
    each into its host buffer. pending: [(buffer, start, length, host
    tensor)], rows [start, start + length) of `buffer` receiving the tensor.
    Under debug_nans a landed tensor with a NaN or Inf raises
    NonFiniteResult naming `family`."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    for buf, start, length, host in pending:
        if debug_nans and not bool(torch.isfinite(host).all()):
            raise NonFiniteResult(f"non-finite {family} result (rows {start}..{start + length - 1} of a dispatch)")
        buf[start : start + length] = host.numpy()
