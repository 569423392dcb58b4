"""Row tiling and the row split over the run's devices (counterpart of
ndpp_tpu/parallel/rows.py).

Every moment kernel is independent across incident-energy rows, so the
driver cuts each row pool into tiles and each tile into nd contiguous
slices, one per device of the run's Placement (the first device.max_devices
cards, or the devices a caller names). No op couples rows: a shard never
waits on another, and each shard's results come back to the host on their
own, with no gather. The reference shards tiles over a TPU mesh and pads
them onto a three-step shape ladder to keep remote compiles scarce; eager
torch has no compile per shape, so a tile here is a plain slice and only
the last one is shorter.

With more than one shard, every shard has a CUDA stream of its own (two
shards may share a card, each on its stream); with one device the current
stream carries everything, as it did before the split existed. A dispatch
set's inputs go to each shard once (RowPlan.put: that shard's rows of every
tile in one copy) and its pieces are slices of them; each piece's result
starts its copy to pinned host memory as soon as it is enqueued
(Placement.fetch), and the host waits once per dispatch set, on every
shard's stream, before it reads any result (Placement.land). Every family
driver moves its rows through RowPlan.dispatch, which does the put, the
pieces and the fetch; the driver chooses where it lands.
"""

from __future__ import annotations

import contextlib
from collections.abc import Callable, Sequence
from typing import NamedTuple

import numpy as np
import torch

from ndpp_tpu_torch.host.unionize import tile_indices
from ndpp_tpu_torch.utils.errors import ConfigError, NdppError

# `run --debug-nans`: Placement.land checks every result it lands for
# non-finite values. driver.run sets it for the length of a run; off, land
# does no extra work and no extra wait.
debug_nans = False


class NonFiniteResult(NdppError):
    """A family's device result holds NaN or Inf (found under debug_nans)."""


def tile_for(n: int, cap: int, e_tile: int = 512, nd: int = 1) -> int:
    """Rows per dispatch: one tile of at most the cap per device, times nd.

    `cap` is an op family's row budget per device at the default
    device.e_tile = 512 and scales with e_tile (floored at 16), so the
    driver's device-OOM retry, which halves e_tile, shrinks every family's
    tiles on every shard, not just the two-body path's (whose cap is e_tile
    itself). With one device this is the cap, or all n rows when fewer."""
    per = max(1, min(-(-n // nd), max(16, cap * e_tile // 512)))
    return per * nd


def _host(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.float64)


class Placement:
    """The devices of a run, one shard each, in order, and a stream per shard
    when there is more than one. `devices`: torch devices or their names."""

    def __init__(self, devices: Sequence[str | torch.device]):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ConfigError("a placement needs at least one device")
        split = len(self.devices) > 1
        self.streams = tuple(
            torch.cuda.Stream(d) if split and d.type == "cuda" else None for d in self.devices
        )

    @property
    def nd(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Placement({[str(d) for d in self.devices]})"

    def plan(self, n: int, cap: int, e_tile: int = 512) -> RowPlan:
        """The dispatch plan of n rows at the family's per-device cap."""
        return RowPlan(self, n, tile_for(n, cap, e_tile, self.nd))

    def whole(self, n: int) -> RowPlan:
        """n rows as one dispatch, cut into nd slices (an untiled family)."""
        return RowPlan(self, n, max(n, 1))

    @contextlib.contextmanager
    def shard(self, k: int):
        """Shard k's device as the current device and its stream as the
        current stream: what is enqueued inside runs on shard k."""
        dev, stream = self.devices[k], self.streams[k]
        if dev.type != "cuda":
            yield
            return
        with torch.cuda.device(dev), (torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()):
            yield

    def put_replicated(self, arr) -> list[torch.Tensor]:
        """A table that every piece reads (group bounds, a law's shared mu
        knots) -> one float64 tensor per shard, copied once to each distinct
        device, never per tile. A host-to-device copy from pageable memory
        has ended when it returns, so shards that share the copy on one card
        need no wait; record_stream keeps its memory until their work ends."""
        host = _host(arr)
        made: dict[torch.device, torch.Tensor] = {}
        out = []
        for k, dev in enumerate(self.devices):
            t = made.get(dev)
            if t is None:
                with self.shard(k):
                    t = made[dev] = torch.as_tensor(host, device=dev)
            elif self.streams[k] is not None:
                t.record_stream(self.streams[k])
            out.append(t)
        return out

    def fetch(self, res: torch.Tensor) -> torch.Tensor:
        """Start the copy of a piece's result to the host and return the host
        tensor; call it inside the piece's shard(). From a card the copy is
        enqueued on the shard's stream, lands in pinned memory and does not
        wait (land waits once for all of them); from the CPU it returns
        `res` itself."""
        return res.to("cpu", non_blocking=True)

    def land(self, pending: list, family: str) -> None:
        """Wait ONCE on every shard's stream, then store each fetched result
        into its host buffer. pending: [(buffer, start, length, host
        tensor)], rows [start, start + length) of `buffer` receiving the
        tensor. Under debug_nans a landed tensor with a NaN or Inf raises
        NonFiniteResult naming `family`."""
        waited = set()
        for dev, stream in zip(self.devices, self.streams):
            if dev.type != "cuda":
                continue
            s = stream if stream is not None else torch.cuda.current_stream(dev)
            if s not in waited:
                s.synchronize()
                waited.add(s)
        for buf, start, length, host in pending:
            if debug_nans and not bool(torch.isfinite(host).all()):
                raise NonFiniteResult(f"non-finite {family} result (rows {start}..{start + length - 1} of a dispatch)")
            buf[start : start + length] = host.numpy()


class Piece(NamedTuple):
    """One shard's slice of one tile: rows [start, start + length) of the
    dispatch set are rows `sl` of the tensors RowPlan.put made for shard k.
    tile: the rows of the whole tile, all shards' pieces of it together
    (what a kernel's lanes are chosen from, so that a split tile sums as it
    does on one device)."""

    k: int
    sl: slice
    start: int
    length: int
    tile: int


class RowPlan:
    """A dispatch set of n rows over a placement: tiles of `tile` rows (the
    last one shorter), each cut into nd contiguous slices, one per shard.

    pieces: the Pieces in dispatch order. With one device the pieces are the
    tiles and shard 0 holds every row in order."""

    def __init__(self, place: Placement, n: int, tile: int):
        self.place = place
        nd = place.nd
        self.piece_rows = -(-tile // nd)  # the most rows one piece holds
        self.pieces: list[Piece] = []
        spans: list[list[tuple[int, int]]] = [[] for _ in range(nd)]
        held = [0] * nd
        for start, length in tile_indices(n, tile):
            per = -(-length // nd)
            for k in range(nd):
                lo, hi = min(k * per, length), min((k + 1) * per, length)
                if hi > lo:
                    self.pieces.append(Piece(k, slice(held[k], held[k] + hi - lo), start + lo, hi - lo, length))
                    spans[k].append((start + lo, start + hi))
                    held[k] += hi - lo
        self._spans = spans

    def put(self, arr) -> list[torch.Tensor | None]:
        """Host rows (n, ...) -> float64 tensors, one per shard on its
        device holding its rows of every tile (None for a shard with none)."""
        host = _host(arr)
        out: list[torch.Tensor | None] = []
        for k, spans in enumerate(self._spans):
            if not spans:
                out.append(None)
                continue
            if all(a[1] == b[0] for a, b in zip(spans, spans[1:])):  # one run of rows: a view, no copy
                rows = host[spans[0][0] : spans[-1][1]]
            else:
                rows = np.concatenate([host[a:b] for a, b in spans])
            with self.place.shard(k):
                out.append(torch.as_tensor(rows, device=self.place.devices[k]))
        return out

    def dispatch(self, op: Callable, out: np.ndarray, pending: list, *rows) -> None:
        """Enqueue op over every piece and start each result's copy back.

        rows: host operands (n, ...), put for the shards once each; None
        stays None. op(piece, *row slices) runs under the piece's shard, in
        pieces order; what it returns lands in rows [start, start + length)
        of `out`. This appends those copies to `pending` and does not land:
        the caller's Placement.land waits once for all of a set's pieces."""
        held = [None if a is None else self.put(a) for a in rows]
        for piece in self.pieces:
            with self.place.shard(piece.k):
                res = op(piece, *(None if d is None else d[piece.k][piece.sl] for d in held))
                pending.append((out, piece.start, piece.length, self.place.fetch(res)))


def as_placement(where: Placement | str | torch.device) -> Placement:
    """A placement as given, or one device's placement."""
    return where if isinstance(where, Placement) else Placement([where])
