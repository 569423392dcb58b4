"""Device mesh + sharded moment evaluation (counterpart of
ndpp_tpu/parallel/mesh.py).

The distribution design of the reference, on torch devices:

  - mesh axis 'nuclide': blocks of nuclides, embarrassingly parallel;
  - mesh axis 'e': incident-energy tiles; every incident energy is
    independent, so plain block sharding with no collective in the compute
    path is the whole design.

A Mesh is a 2-D grid of torch devices (a card may appear more than once:
each cell is a shard with its own stream, parallel.rows.Placement). Inputs
are split into per-cell blocks on the host (place_batch), each cell runs the
port's ordinary op on its block, and the results come back to the host cell
by cell into one array of the reference's output shape, with no all-gather.
Blocks must divide evenly, as under the reference's shard_map.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from ndpp_tpu_torch.ops.chi import tabular_group_fractions
from ndpp_tpu_torch.ops.freegas import freegas_moments_sab
from ndpp_tpu_torch.ops.twobody import twobody_moments
from ndpp_tpu_torch.parallel.rows import Placement


class Mesh:
    """A ('nuclide', 'e') grid of torch devices; cell (i, j) is shard
    i * n_e + j of `place`."""

    axis_names = ("nuclide", "e")

    def __init__(self, devices):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2:
            raise ValueError(f"a mesh is a 2-D grid of devices, got shape {grid.shape}")
        self.devices = grid
        self.place = Placement(list(grid.flat))

    @property
    def shape(self) -> tuple[int, int]:
        return self.devices.shape

    def cells(self):
        """(shard index, i, j) of every cell, row-major."""
        n_e = self.shape[1]
        return [(k, k // n_e, k % n_e) for k in range(self.place.nd)]


class Blocks:
    """A host array split over a mesh: `blocks[k]` is cell k's block on its
    device; `shape` is the whole array's."""

    def __init__(self, blocks: list[torch.Tensor], shape: tuple):
        self.blocks = blocks
        self.shape = shape


def auto_mesh(devices: Sequence, n_nuclide: int | None = None) -> Mesh:
    """A ('nuclide', 'e') mesh over `devices` (torch devices or names).

    Default split: the nuclide axis gets the largest divisor of the device
    count <= sqrt(count) (nuclide blocks are coarser-grained than E-tiles).
    """
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_nuclide is None:
        n_nuclide = 1
        for d in range(1, int(np.sqrt(n)) + 1):
            if n % d == 0:
                n_nuclide = d
    if n % n_nuclide != 0:
        raise ValueError(f"n_nuclide={n_nuclide} does not divide device count {n}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n_nuclide, n // n_nuclide))


def _block(mesh: Mesh, arr: np.ndarray, i: int, j: int) -> np.ndarray:
    """Cell (i, j)'s block by the canonical spec: (N, T, ...) arrays split
    along both axes, (N,) along the nuclide axis, scalars whole."""
    pn, pe = mesh.shape
    if arr.ndim == 0:
        return arr
    bn = arr.shape[0] // pn
    if arr.ndim == 1:
        return arr[i * bn : (i + 1) * bn]
    be = arr.shape[1] // pe
    return arr[i * bn : (i + 1) * bn, j * be : (j + 1) * be]


def _split(mesh: Mesh, arr) -> Blocks:
    """A host array (numpy or a CPU tensor) as per-cell float64 blocks."""
    if isinstance(arr, Blocks):
        return arr
    host = np.asarray(arr.cpu() if isinstance(arr, torch.Tensor) else arr, dtype=np.float64)
    for axis, parts in enumerate(mesh.shape[: host.ndim]):
        if host.shape[axis] % parts:
            raise ValueError(f"axis {axis} of length {host.shape[axis]} does not split into {parts} blocks")
    blocks = []
    for k, i, j in mesh.cells():
        with mesh.place.shard(k):
            blocks.append(torch.as_tensor(np.ascontiguousarray(_block(mesh, host, i, j)), device=mesh.place.devices[k]))
    return Blocks(blocks, host.shape)


def place_batch(mesh: Mesh, arrays: dict) -> dict[str, Blocks]:
    """Host arrays -> per-cell blocks with the canonical (nuclide, e, ...)
    split (the reference's device_put with those shardings)."""
    return {name: _split(mesh, arr) for name, arr in arrays.items()}


def _replicated(mesh: Mesh, arr) -> list[torch.Tensor]:
    host = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else arr
    return mesh.place.put_replicated(host)


def _per_cell(mesh: Mesh, n: int, t: int, tail: tuple, op) -> torch.Tensor:
    """Run op(k) under every cell's shard; each returns its (n_loc * t_loc,
    *tail) block, which lands in the (n, t, *tail) host result."""
    pn, pe = mesh.shape
    bn, be = n // pn, t // pe
    out = np.empty((n, t) + tail)
    bufs, pending = [], []
    for k, i, j in mesh.cells():
        buf = np.empty((bn * be,) + tail)
        bufs.append((buf, i, j))
        with mesh.place.shard(k):
            pending.append((buf, 0, bn * be, mesh.place.fetch(op(k))))
    mesh.place.land(pending, "mesh")
    for buf, i, j in bufs:
        out[i * bn : (i + 1) * bn, j * be : (j + 1) * be] = buf.reshape((bn, be) + tail)
    return torch.from_numpy(out)


def sharded_twobody_moments(
    mesh: Mesh, e, knots, pdf, bounds, c1, c2, awr, order: int, nq: int = 16, clamp: bool = True
) -> torch.Tensor:
    """Two-body moments for a (nuclide x E-tile) batch over the mesh.

    e: (N, T); knots/pdf: (N, T, K); c1/c2/awr: (N,); bounds (G+1,) shared.
    Host arrays or place_batch blocks. Returns the (N, T, L+1, G) float64
    result on the host. On a card each block runs the CUDA kernel.
    """
    e, knots, pdf, c1, c2, awr = (_split(mesh, a) for a in (e, knots, pdf, c1, c2, awr))
    b = _replicated(mesh, bounds)
    n, t = e.shape
    kk = knots.shape[-1]

    def op(k):
        e_b = e.blocks[k]
        t_loc = e_b.shape[1]
        rows = e_b.numel()
        return twobody_moments(
            e_b.reshape(rows), knots.blocks[k].reshape(rows, kk), pdf.blocks[k].reshape(rows, kk), b[k],
            c1.blocks[k].repeat_interleave(t_loc), c2.blocks[k].repeat_interleave(t_loc),
            awr.blocks[k].repeat_interleave(t_loc), order, nq, clamp,
        )

    return _per_cell(mesh, n, t, (order + 1, b[0].shape[0] - 1), op)


def sharded_freegas_moments(mesh: Mesh, e, awr, kt, bounds, order: int, **kw) -> torch.Tensor:
    """Free-gas moments (freegas_moments_sab) for an (N, T) energy batch over
    the mesh. e: (N, T); awr: (N,); kt scalar; bounds (G+1,) shared and
    FINITE (the op normalizes over its window). Returns (N, T, L+1, G)."""
    e, awr = _split(mesh, e), _split(mesh, awr)
    b = _replicated(mesh, bounds)
    n, t = e.shape

    def op(k):
        e_b = e.blocks[k]
        return freegas_moments_sab(e_b.reshape(-1), awr.blocks[k].repeat_interleave(e_b.shape[1]), kt, b[k], order, **kw)

    return _per_cell(mesh, n, t, (order + 1, b[0].shape[0] - 1), op)


def sharded_chi_fractions(mesh: Mesh, e_knots, pdf, bounds, clamp: bool = True) -> torch.Tensor:
    """Tabular spectrum group fractions for an (N, T, K) batch over the
    mesh. Returns (N, T, G)."""
    e_knots, pdf = _split(mesh, e_knots), _split(mesh, pdf)
    b = _replicated(mesh, bounds)
    n, t, kk = e_knots.shape

    def op(k):
        return tabular_group_fractions(e_knots.blocks[k].reshape(-1, kk), pdf.blocks[k].reshape(-1, kk), b[k], clamp)

    return _per_cell(mesh, n, t, (b[0].shape[0] - 1,), op)
