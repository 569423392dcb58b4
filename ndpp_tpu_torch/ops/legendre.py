"""Legendre recurrence and Gauss-Legendre quadrature tables.

P_l via the Bonnet recurrence (SURVEY.md section 8.3); GL nodes/weights
are computed on the host in float64 with numpy and handed to the kernels as
small tensors. Counterpart of ndpp_tpu/ops/legendre.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def gl_nodes_weights(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre nodes/weights on [-1, 1], float64."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x.astype(np.float64), w.astype(np.float64)


@lru_cache(maxsize=256)
def device_table(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant table (GL nodes, a ladder) as a tensor on `device`,
    made once per (values, dtype, device) and only read afterwards. The
    plain kernel versions take their tables from here, so that a CUDA graph
    can capture them: a copy from host memory during the capture would fail."""
    return torch.tensor(values, dtype=dtype, device=device)


def legendre_all(x: torch.Tensor, order: int) -> torch.Tensor:
    """Stack [P_0(x), ..., P_order(x)] along a new LAST axis.

    Bonnet: (l+1) P_{l+1} = (2l+1) x P_l - l P_{l-1}.
    """
    ps = [torch.ones_like(x)]
    if order >= 1:
        ps.append(x)
    for l in range(1, order):
        ps.append(((2 * l + 1) * x * ps[l] - l * ps[l - 1]) / (l + 1))
    return torch.stack(ps, dim=-1)


def legendre_all_np(x: np.ndarray, order: int) -> np.ndarray:
    """Numpy twin of legendre_all (host-side exact angular moments)."""
    x = np.asarray(x, dtype=np.float64)
    ps = [np.ones_like(x)]
    if order >= 1:
        ps.append(x)
    for l in range(1, order):
        ps.append(((2 * l + 1) * x * ps[l] - l * ps[l - 1]) / (l + 1))
    return np.stack(ps, axis=-1)
