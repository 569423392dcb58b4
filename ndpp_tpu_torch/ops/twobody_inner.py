"""Two-body group moments: the hand-written CUDA kernel and its plain version.

For each row t and subinterval s, an nq-point Gauss-Legendre rule on
mu = mid + half * x_q. At each node:

    pdf     = a_s + b_s * mu
    E'_lab  = max(base + slope * mu, 1e-30)
    mu_lab  = clip((sqrt(E'_cm) * mu + sqrt(E)/(A+1)) * E'_lab^(-1/2), -1, 1)
    acc_l  += pdf * w_q * P_l(mu_lab)          (P_l by the Bonnet recurrence)

and the subinterval moment is half * acc_l, shape (T, L+1, S) (the inner
stage). Each live subinterval (half > 0 on a row with valid_e) is then
summed into the outgoing group that holds E'_lab at its midpoint (the
epilogue, ops/segment.py), giving (T, L+1, G). This replaces the Pallas TPU
kernel ndpp_tpu/ops/twobody_pallas_dd.py::twobody_inner_dd (its
double-double arithmetic is a TPU workaround: the card has native float64)
together with the group reduction after it.

``twobody_group_moments`` runs the fused CUDA kernel (csrc/twobody_inner.cu)
on a CUDA tensor, so the (T, L+1, S) intermediate never reaches device
memory, and the plain torch version ``twobody_group_moments_ref`` (inner
stage, then epilogue) on a CPU tensor; there is no fallback from one to the
other. The kernel library is built with nvcc at first use by
utils.build.build_cuda into utils.build.build_dir() (build/ndpp_tpu_torch/
at the root of a source checkout, the per-user cache for an installed
package), keyed by the source's hash, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache
from pathlib import Path

import torch

from ndpp_tpu_torch.ops.legendre import gl_nodes_weights
from ndpp_tpu_torch.ops.segment import segment_group_sum
from ndpp_tpu_torch.utils.build import NVCC_FLAGS, build_cuda, build_dir

MAX_ORDER = 10
MAX_NQ = 64  # GL nodes the kernel's parameter block holds (kMaxNq)

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "twobody_inner.cu"
_BUILD_DIR = build_dir()
_NVCC_FLAGS = NVCC_FLAGS


def twobody_inner_ref(mid, half, a_s, b_s, kin, order: int, nq: int) -> torch.Tensor:
    """Plain torch inner stage: (T, L+1, S) subinterval moments, the formula
    of the module docstring node by node."""
    xq, wq = gl_nodes_weights(nq)
    base, slope, sqecm, sqe_ap1 = (kin[:, i : i + 1] for i in range(4))
    acc = [torch.zeros_like(mid) for _ in range(order + 1)]
    for q in range(nq):
        mu = mid + half * float(xq[q])
        pdf = a_s + b_s * mu
        elab = torch.clamp_min(base + slope * mu, 1e-30)
        mu_lab = torch.clamp((sqecm * mu + sqe_ap1) * torch.rsqrt(elab), -1.0, 1.0)
        w = pdf * float(wq[q])
        acc[0] += w
        if order >= 1:
            p_prev = torch.ones_like(mu_lab)
            p_cur = mu_lab
            acc[1] += w * p_cur
            for l in range(1, order):
                p_prev, p_cur = p_cur, ((2 * l + 1) * mu_lab * p_cur - l * p_prev) / (l + 1)
                acc[l + 1] += w * p_cur
    return half.unsqueeze(1) * torch.stack(acc, dim=1)


def twobody_scatter(m, mid, half, base, slope, valid_e, bounds, clamp: bool) -> torch.Tensor:
    """Plain torch epilogue: (T, L+1, S) subinterval moments -> (T, L+1, G).

    E'_lab(mid) is ascending along the sorted subinterval axis (slope > 0),
    so group indices are NON-DECREASING per row and the group sums are
    contiguous segments (ops.segment.segment_group_sum).
    """
    elab_mid = base[:, None] + slope[:, None] * mid  # (T, S)
    valid = (half > 0.0) & valid_e[:, None]
    m = m * valid[:, None, :]
    return segment_group_sum(m, elab_mid, bounds, clamp)


def twobody_group_moments_ref(mid, half, a_s, b_s, kin, valid_e, bounds, order: int, nq: int, clamp: bool):
    """Plain version of the fused kernel: the inner stage, then the epilogue."""
    m = twobody_inner_ref(mid, half, a_s, b_s, kin, order, nq)
    return twobody_scatter(m, mid, half, kin[:, 0], kin[:, 1], valid_e, bounds, clamp)


def _check(mid, half, a_s, b_s, kin, valid_e, bounds, order: int, nq: int) -> None:
    if not 0 <= order <= MAX_ORDER:
        raise ValueError(f"twobody_group_moments: order must be in [0, {MAX_ORDER}], got {order}")
    if not 0 < nq <= MAX_NQ:
        raise ValueError(f"twobody_group_moments: nq must be in [1, {MAX_NQ}], got {nq}")
    if mid.dim() != 2:
        raise ValueError(f"twobody_group_moments: mid must be (T, S), got {tuple(mid.shape)}")
    t, _ = mid.shape
    for name, x in (("half", half), ("a_s", a_s), ("b_s", b_s)):
        if x.shape != mid.shape:
            raise ValueError(f"twobody_group_moments: {name} {tuple(x.shape)} != mid {tuple(mid.shape)}")
    if kin.shape != (t, 4):
        raise ValueError(f"twobody_group_moments: kin must be ({t}, 4), got {tuple(kin.shape)}")
    if valid_e.shape != (t,):
        raise ValueError(f"twobody_group_moments: valid_e must be ({t},), got {tuple(valid_e.shape)}")
    if valid_e.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"twobody_group_moments: valid_e must be bool or uint8, got {valid_e.dtype}")
    if not (bounds.dim() == 1 or (bounds.dim() == 2 and bounds.shape[0] == t)) or bounds.shape[-1] < 2:
        raise ValueError(
            f"twobody_group_moments: bounds must be (G+1,) or ({t}, B+1) with G, B >= 1, got {tuple(bounds.shape)}"
        )
    floats = (("mid", mid), ("half", half), ("a_s", a_s), ("b_s", b_s), ("kin", kin), ("bounds", bounds))
    for name, x in floats:
        if x.dtype != torch.float64:
            raise TypeError(f"twobody_group_moments: {name} must be float64, got {x.dtype}")
    for name, x in (*floats, ("valid_e", valid_e)):
        if x.device != mid.device:
            raise ValueError(f"twobody_group_moments: {name} on {x.device}, mid on {mid.device}")
        if not x.is_contiguous():
            raise ValueError(f"twobody_group_moments: {name} must be contiguous")


def twobody_group_moments(mid, half, a_s, b_s, kin, valid_e, bounds, order: int, nq: int, clamp: bool) -> torch.Tensor:
    """(T, L+1, G | B) group moments from the prologue's panels.

    mid/half/a_s/b_s: (T, S) panels; kin: (T, 4) = (base, slope, sqrt(E'_cm),
    sqrt(E)/(A+1)); valid_e: (T,) bool or uint8; bounds: shared (G+1,) or
    per-row (T, B+1). CUDA tensors launch the fused kernel on the current
    stream without synchronising; CPU tensors take twobody_group_moments_ref.
    """
    _check(mid, half, a_s, b_s, kin, valid_e, bounds, order, nq)
    if mid.device.type == "cpu":
        return twobody_group_moments_ref(mid, half, a_s, b_s, kin, valid_e, bounds, order, nq, clamp)
    if mid.device.type != "cuda":
        raise ValueError(f"twobody_group_moments: unsupported device {mid.device}")
    t, s = mid.shape
    ng = bounds.shape[-1] - 1
    out = torch.empty((t, order + 1, ng), dtype=torch.float64, device=mid.device)
    if t == 0:
        return out
    lib = library()
    xq, wq = gl_nodes_weights(nq)
    valid = valid_e.view(torch.uint8) if valid_e.dtype == torch.bool else valid_e
    row_stride = 0 if bounds.dim() == 1 else bounds.stride(0)
    with torch.cuda.device(mid.device):
        stream = torch.cuda.current_stream(mid.device).cuda_stream
        rc = lib.twobody_group_launch(
            *(x.data_ptr() for x in (mid, half, a_s, b_s, kin, valid, bounds)), row_stride, ng, int(bool(clamp)),
            order, nq, xq.ctypes.data, wq.ctypes.data, t, s, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"twobody_group_moments: kernel launch failed with cudaError {rc}")
    twobody_group_moments.launches += 1
    twobody_group_moments.launches_by_stream[stream] += 1
    return out


# Launches of the CUDA kernel since the last reset (a run shows with it that
# its main path went through the kernel), in all and by the CUDA stream that
# took them (its cudaStream_t handle; a row split shows that every shard's
# stream launched). CPU calls never count.
twobody_group_moments.launches = 0
twobody_group_moments.launches_by_stream = Counter()


def build() -> tuple[Path, float]:
    """Compile csrc/twobody_inner.cu for sm_90a unless a library built from
    the same source bytes exists (utils.build.build_cuda); returns (path,
    seconds spent building)."""
    return build_cuda(_SRC, _NVCC_FLAGS)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of twobody_group_launch in a loaded library."""
    fn = lib.twobody_group_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    )
    fn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    return bind(ctypes.CDLL(str(path)))
