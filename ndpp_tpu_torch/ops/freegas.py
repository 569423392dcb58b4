"""Free-gas (target-in-motion) thermal scattering moments with up-scatter.

Counterpart of ndpp_tpu/ops/freegas.py: the production kernel
freegas_moments_sab with its density _sab_dens, the structurally independent
panel-split kernel freegas_moments_panelsplit with its (v_r, V_cm)
quadrature density _pointwise_dens (the kernel selfcheck holds the production
one against), and the outgoing-axis machinery _outgoing_panelsplit that both
share. At the end of the module, the reference's cross-checks that no driver
calls: the kink-panel kernel freegas_moments, the pointwise kernel
freegas_moments_pointwise and the validation hook freegas_sigma_eff_ratio.

Model: Maxwellian target of mass ratio A at temperature T (kT in eV),
constant free-atom cross section, isotropic CM scattering. With the
free-gas scattering law

    S(alpha, beta) = (4 pi alpha)^(-1/2) exp(-(alpha + beta)^2 / (4 alpha)),
    alpha = (E + E' - 2 mu sqrt(E E')) / (A kT),  beta = (E' - E) / kT,

and t = sqrt(alpha), u = (t - |beta| / t) / 2, the density of outgoing
energy E' and its Legendre moments are one smooth Gaussian integral in u per
outgoing point (_sab_dens). The outgoing axis y = sqrt(E') is cut into
panels at the integrand's own structure (the elastic cusp, graded ladders,
a uniform fill); the panel GL nodes give the totals and group splits come
from the GL-node Lagrange interpolant (ops.panelsplit.lagrange_cumulants),
so a row's cost does not grow with the group count.

Float64 torch functions on the device of their arguments, except the
production density: sab_density runs the hand-written CUDA kernel
(csrc/freegas_sab.cu) on a CUDA tensor, one launch for every (row, y-node),
and its plain torch version sab_density_ref (_sab_dens a chunk of y-panels
at a time) on a CPU tensor; there is no fallback from one to the other.
The reference's lax.scan over chunks of 8 y-panels is a Python loop in the
plain paths whose chunk comes from a byte budget (chunk_for,
panelsplit_chunk_for); chunks are independent, so the result does not
depend on the chunk. The panel-split kernel's lax.scan over v_r panels is a
Python loop too, and only the L+1 (T, NY) accumulators live across its
iterations; it stays torch on every device, so selfcheck holds the CUDA
kernel against independent code.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from functools import lru_cache
from math import comb
from pathlib import Path

import numpy as np
import torch

from ndpp_tpu_torch.ops.continuum import CHUNK_BUDGET_BYTES
from ndpp_tpu_torch.ops.lanes import H100_SMS, check_lanes, device_sms, lane_group
from ndpp_tpu_torch.ops.legendre import device_table, gl_nodes_weights, legendre_all
from ndpp_tpu_torch.ops.panelsplit import lagrange_cumulants
from ndpp_tpu_torch.utils.build import build_cuda

# per-row outer v_r panel offsets of _pointwise_dens in units of 1/beta,
# graded around v_r = v
_VR_OFFSETS = np.array([-8.0, -4.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 4.0, 8.0])
# its middle V_cm panel offsets in units of the Gaussian width, graded around
# the weight peak V_cm* (the e^{-beta^2 V^2} band can be much narrower than
# the kinematic [|v - u|, v + u] range at high x = beta v)
_VCM_OFFSETS = np.array([-8.0, -4.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 4.0, 8.0])
# outgoing y-panel ladder around the elastic point and its alpha image, in
# units of 2 gamma / beta
_Y_LADDER = np.array([-32.0, -16.0, -8.0, -4.0, -2.0, -1.0, -0.5, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0])
# u-panel ladders of _sab_dens: a fixed one for the Gaussian, one scaled by
# sqrt(|beta|) for the sqrt(u^2 + |beta|) curvature at the elastic cusp
_SAB_ULAD = np.array([-6.0, -4.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 4.0, 6.0])
_SAB_CLAD = np.array([-8.0, -4.0, -2.0, -1.0, 1.0, 2.0, 4.0, 8.0])
_UCLIP = 8.5
U_PANELS = _SAB_ULAD.size + _SAB_CLAD.size + 1  # u-panels per outgoing point
# The reference's shipped rule: GL nodes per u-panel and per y-panel, and the
# uniform fill of the outgoing axis
NQ_U, NQ_G, NFILL_Y = 24, 20, 8


def y_panels(nfill_y: int) -> int:
    """Outgoing y-panels per row of _outgoing_panelsplit: the uniform fill
    with both window ends, two graded ladders and their two anchors."""
    return (nfill_y + 2) + 2 * _Y_LADDER.size + 2 - 1


Y_PANELS = y_panels(NFILL_Y)
# float64 tensors of (rows, chunk * NQ_G, U_PANELS, NQ_U) alive at once at the
# widest point of _sab_dens (u, w, root, t, jac and their temporaries; in the
# Legendre loop base, mu, three P_l and their temporaries)
_LIVE_NODE_TENSORS = 10
# float64 tensors of (rows, chunk * nq_g, nq_r, C) alive at once at the widest
# point of a v_r panel of _pointwise_dens (cc, w_c, dens, c_a, c_b, two P_l of
# each, their product and the temporaries of each line)
_PW_LIVE_NODE_TENSORS = 14


def chunk_for(rows: int, budget_bytes: int = CHUNK_BUDGET_BYTES) -> int:
    """y-panels per chunk so the chunk's live (T, chunk * NQ_G, U_PANELS,
    NQ_U) float64 tensors stay inside `budget_bytes`: between 1 and all. It
    bounds the plain path only: the CUDA kernel holds no such tensor."""
    per_panel = max(rows, 1) * NQ_G * U_PANELS * NQ_U * 8 * _LIVE_NODE_TENSORS
    return max(1, min(Y_PANELS, budget_bytes // per_panel))


def _c_fill(nfill_c: int, ngeo_c: int) -> np.ndarray:
    """Fill fractions of a V_cm range: a uniform fill and a geometric grading
    at its low end (the reference's np.unique, computed once on the host)."""
    return np.unique(np.concatenate([np.linspace(0.0, 1.0, nfill_c + 2)[1:-1], 4.0 ** -np.arange(ngeo_c, 0, -1.0)]))


def panelsplit_chunk_for(
    rows: int, nq_g: int, nq_r: int, nq_c: int, nfill_c: int, ngeo_c: int, npan: int,
    budget_bytes: int = CHUNK_BUDGET_BYTES,
) -> int:
    """y-panels per chunk of freegas_moments_panelsplit so the chunk's live
    (T, chunk * nq_g, nq_r, C) float64 tensors stay inside `budget_bytes`:
    between 1 and all `npan`. C is the V_cm nodes per v_r node: nq_c on each
    of the panels between lo, two graded ladders, the fill and hi."""
    n_c = (2 * _VCM_OFFSETS.size + _c_fill(nfill_c, ngeo_c).size + 1) * nq_c
    per_panel = max(rows, 1) * nq_g * nq_r * n_c * 8 * _PW_LIVE_NODE_TENSORS
    return max(1, min(npan, budget_bytes // per_panel))


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi) with tensor bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _per_row(x, e):
    """A scalar or (T,) value as a float64 (T,) tensor beside e."""
    return torch.as_tensor(x, dtype=e.dtype, device=e.device).expand(e.shape)


def freegas_moments_sab(e, awr, kt, bounds, order: int, chunk: int = Y_PANELS, lanes: int | None = None):
    """Free-gas moments via the exact scattering-law density: (T, L+1, G).

    e: (T,) incident energies, eV; awr, kt: scalars or (T,); bounds: FINITE
    covering window (G+1,), ascending. Rows are normalized over the window,
    so each P0 row sums to 1 (a row with no mass in it is left unscaled).
    chunk: y-panels evaluated at a time by the plain path (chunk_for); the
    CUDA kernel takes every y-node in one launch, with `lanes` lanes per
    y-node (sab_density's).
    """
    v, awr, kt = torch.sqrt(e).contiguous(), _per_row(awr, e).contiguous(), _per_row(kt, e).contiguous()
    return _outgoing_panelsplit(
        e, v, awr, kt, bounds, order, NQ_G, NFILL_Y,
        lambda pm, ph: sab_density(pm, ph, v, awr, kt, order, chunk, lanes),
    )


def freegas_moments_panelsplit(
    e,
    awr,
    kt,
    bounds,
    order: int,
    nq_g: int = 10,
    nq_r: int = 8,
    nq_c: int = 8,
    chunk: int = 8,
    nfill_r: int = 7,
    nfill_c: int = 7,
    ngeo_c: int = 8,
    nfill_y: int = 8,
):
    """Free-gas moments by the (v_r, V_cm) quadrature of the target's motion,
    at the outgoing panels of _outgoing_panelsplit: (T, L+1, G).

    The kernel selfcheck holds freegas_moments_sab against: the same
    outgoing-axis machinery, an independent density (_pointwise_dens, no
    scattering-law code). Its cost per row does not grow with G.

    bounds: FINITE covering window (G+1,), ascending. chunk: at most this many
    y-panels at a time; fewer where the 2 GiB budget of live node tensors
    says so (panelsplit_chunk_for). The result does not depend on it.
    """
    dtype, dev = e.dtype, e.device
    v = torch.sqrt(e)
    awr = _per_row(awr, e)
    kt = _per_row(kt, e)
    gamma = awr / (awr + 1.0)
    beta = torch.sqrt(awr / kt)
    inv_beta = 1.0 / beta
    a_ratio = (awr + 1.0) / awr
    xr, wr, xc, wc = (
        torch.as_tensor(a, dtype=dtype, device=dev) for a in (*gl_nodes_weights(nq_r), *gl_nodes_weights(nq_c))
    )
    lo_r_dom = torch.clamp_min(v - 8.0 * inv_beta, 0.0)
    hi_r_dom = v + 8.0 * inv_beta
    ladder = torch.as_tensor(_VR_OFFSETS, dtype=dtype, device=dev)
    offs_c = torch.as_tensor(_VCM_OFFSETS, dtype=dtype, device=dev)
    chunk = min(chunk, panelsplit_chunk_for(e.shape[0], nq_g, nq_r, nq_c, nfill_c, ngeo_c, y_panels(nfill_y)))

    def dens_fn(y):
        return _pointwise_dens(
            y, v, awr, gamma, beta, inv_beta, a_ratio, lo_r_dom, hi_r_dom,
            ladder, offs_c, xr, wr, xc, wc, order, nfill_r, nfill_c, ngeo_c,
        )

    return _outgoing_panelsplit(
        e, v, awr, kt, bounds, order, nq_g, nfill_y, lambda pm, ph: _chunked_gvals(pm, ph, nq_g, order, chunk, dens_fn)
    )


def sab_u_edges(y, v, awr, kt):
    """The sorted u-panel edges of _sab_dens at outgoing points y (T, NY):
    (edges (T, NY, U_PANELS + 1), c = |beta_s|, beta_s)."""
    tt, ny = y.shape
    vv = v[:, None]
    akt = (awr * kt)[:, None]
    sq_akt = torch.sqrt(akt)
    sq_a_kt = torch.sqrt(awr / kt)[:, None]
    dy = torch.abs(y - vv)
    sy = y + vv
    beta_s = (y * y - vv * vv) / kt[:, None]  # signed energy transfer / kT
    c = torch.abs(beta_s)
    u_lo = torch.clamp_min(0.5 * (dy / sq_akt - sy * sq_a_kt), -_UCLIP)
    u_hi = torch.clamp_max(0.5 * (sy / sq_akt - dy * sq_a_kt), _UCLIP)
    u_hi = torch.maximum(u_hi, u_lo)
    sc = torch.sqrt(c)
    ulad = device_table(tuple(_SAB_ULAD), y.dtype, y.device)
    clad = device_table(tuple(_SAB_CLAD), y.dtype, y.device)
    lo, hi = u_lo[..., None], u_hi[..., None]
    edges = torch.cat(
        [lo, _clip(ulad.expand(tt, ny, ulad.shape[0]), lo, hi), _clip(sc[..., None] * clad, lo, hi), hi], dim=-1
    )
    return torch.sort(edges, dim=-1).values, c, beta_s


def _sab_dens(y, v, awr, kt, order: int):
    """dF_l/dE' at outgoing points y via the free-gas scattering law.

    y: (T, NY); returns a list of L+1 (T, NY) tensors (up to an E-row-only
    constant factor, which the caller's row normalization cancels).
    Endpoint u-values use the exact identities c/t- = (y+v) sqrt(A/kT) and
    c/t+ = |y-v| sqrt(A/kT) (no 0/0 at the elastic point; for u < 0 at
    beta -> 0 the Jacobian t/sqrt(u^2+c) -> 0 kills the spurious segment
    continuously).
    """
    dtype, dev = y.dtype, y.device
    vv = v[:, None]
    akt = (awr * kt)[:, None]
    edges, c, beta_s = sab_u_edges(y, v, awr, kt)  # (T, NY, P+1)
    denom = torch.clamp_min(2.0 * vv * y, 1e-30)
    m0 = (vv * vv + y * y) / denom
    m1 = akt / denom
    xq, wq = (device_table(tuple(a), dtype, dev) for a in gl_nodes_weights(NQ_U))
    pm = 0.5 * (edges[..., 1:] + edges[..., :-1])
    ph = 0.5 * (edges[..., 1:] - edges[..., :-1])
    del edges
    u = pm[..., None] + ph[..., None] * xq  # (T, NY, P, Q)
    w = ph[..., None] * wq
    root = torch.sqrt(u * u + c[..., None, None])
    t = u + root
    jac = t / torch.clamp_min(root, 1e-30)
    del root
    expo = -(u * u) - torch.clamp_min(beta_s, 0.0)[..., None, None]
    del u
    base = w * jac * torch.exp(expo)
    del w, jac, expo
    mu = torch.clamp(m0[..., None, None] - m1[..., None, None] * t * t, -1.0, 1.0)
    del t

    dsig = [torch.sum(base, dim=(2, 3))]
    if order >= 1:
        p_prev = torch.ones_like(mu)
        p_cur = mu
        dsig.append(torch.sum(base * p_cur, dim=(2, 3)))
        for l in range(1, order):
            p_next = ((2 * l + 1) * mu * p_cur - l * p_prev) / (l + 1)
            p_prev, p_cur = p_cur, p_next
            dsig.append(torch.sum(base * p_cur, dim=(2, 3)))
    return dsig


def _outgoing_panelsplit(e, v, awr, kt, bounds, order: int, nq_g: int, nfill_y: int, gvals_fn):
    """The outgoing-axis machinery of both kernels: y-panels at the
    integrand's structure, the density at every panel GL node, group splits
    from the GL-node Lagrange interpolant, row normalization. gvals_fn maps
    the panels' mids and halves (T, NP) to g(y) = dF_l/dE' * 2y at every
    panel GL node, (T, NP, nq_g, L+1)."""
    dtype, dev = e.dtype, e.device
    tt = e.shape[0]
    gamma = awr / (awr + 1.0)
    beta = torch.sqrt(awr / kt)
    inv_beta = 1.0 / beta

    sb = torch.sqrt(torch.clamp_min(bounds, 0.0))  # (G+1,) finite ascending

    # --- y panel edges: cusps + graded ladders + uniform fill + window ends
    delta = 2.0 * gamma * inv_beta
    lad = torch.as_tensor(_Y_LADDER, dtype=dtype, device=dev)
    y_alpha = v * torch.abs(awr - 1.0) / (awr + 1.0)
    fill_y = torch.as_tensor(np.linspace(0.0, 1.0, nfill_y + 2), dtype=dtype, device=dev)
    fills = sb[0] + (sb[-1] - sb[0]) * fill_y  # includes both window ends
    extra = torch.cat(
        [
            v[:, None] + delta[:, None] * lad[None, :],
            y_alpha[:, None] + delta[:, None] * lad[None, :],
            torch.stack([v, y_alpha], dim=1),
        ],
        dim=1,
    )
    extra = torch.clamp(extra, sb[0], sb[-1])
    y_edges = torch.sort(torch.cat([fills[None, :].expand(tt, fills.shape[0]), extra], dim=1), dim=1).values
    npan = y_edges.shape[1] - 1
    wg = torch.as_tensor(gl_nodes_weights(nq_g)[1], dtype=dtype, device=dev)
    pmid = 0.5 * (y_edges[:, 1:] + y_edges[:, :-1])  # (T, NP)
    phalf = 0.5 * (y_edges[:, 1:] - y_edges[:, :-1])

    # --- g(y) = dF_l/dE' * 2y at every panel GL node
    gvals = gvals_fn(pmid, phalf)

    # --- cumulative integrals C_l(sb_g) at every group boundary
    cumul = lagrange_cumulants(y_edges, pmid, phalf, gvals, wg, sb, npan, nq_g)
    out = cumul[:, 1:, :] - cumul[:, :-1, :]  # (T, G, L+1)
    n_full = cumul[:, -1, 0]
    n_full = torch.where(n_full > 0, n_full, torch.ones_like(n_full))
    return out.transpose(1, 2) / n_full[:, None, None]


def _chunked_gvals(pmid, phalf, nq_g: int, order: int, chunk: int, dens_fn):
    """g(y) = dF_l/dE' * 2y at every GL node of the panels (pmid, phalf)
    (T, NP), `chunk` panels at a time: (T, NP, nq_g, L+1). dens_fn maps y
    (T, NY) to a list of L+1 (T, NY) density values."""
    tt, npan = pmid.shape
    xg = device_table(tuple(gl_nodes_weights(nq_g)[0]), pmid.dtype, pmid.device)
    gvals = pmid.new_empty((tt, npan, nq_g, order + 1))
    for c0 in range(0, npan, chunk):
        pm = pmid[:, c0 : c0 + chunk]
        ph = phalf[:, c0 : c0 + chunk]
        n = pm.shape[1]
        y = (pm[:, :, None] + ph[:, :, None] * xg[None, None, :]).reshape(tt, n * nq_g)
        vals = torch.stack(dens_fn(y), dim=-1) * (2.0 * y)[..., None]  # g(y) = dens * dE'/dy
        gvals[:, c0 : c0 + n] = vals.reshape(tt, n, nq_g, order + 1)
    return gvals


# ---------------------------------------------------------------------------
# The production density on the card: the hand-written CUDA kernel
# csrc/freegas_sab.cu and its plain version.

MAX_ORDER = 10
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "freegas_sab.cu"


def sab_density_ref(pmid, phalf, v, awr, kt, order: int, chunk: int = Y_PANELS):
    """Plain torch version of the free-gas density kernel: _sab_dens times 2y
    at every NQ_G-point GL node of the y-panels (pmid, phalf) (T, NP), `chunk`
    panels at a time: (T, NP, NQ_G, L+1), what _outgoing_panelsplit stores."""
    return _chunked_gvals(pmid, phalf, NQ_G, order, chunk, lambda y: _sab_dens(y, v, awr, kt, order))


def _check_sab(pmid, phalf, v, awr, kt, order: int) -> None:
    if not 0 <= order <= MAX_ORDER:
        raise ValueError(f"sab_density: order must be in [0, {MAX_ORDER}], got {order}")
    if pmid.dim() != 2 or phalf.shape != pmid.shape:
        raise ValueError(f"sab_density: pmid and phalf must be one (T, NP) shape, got {tuple(pmid.shape)}, "
                         f"{tuple(phalf.shape)}")
    for name, x in (("pmid", pmid), ("phalf", phalf), ("v", v), ("awr", awr), ("kt", kt)):
        if x.dtype != torch.float64:
            raise TypeError(f"sab_density: {name} must be float64, got {x.dtype}")
        if x.device != pmid.device:
            raise ValueError(f"sab_density: {name} on {x.device}, pmid on {pmid.device}")
        if not x.is_contiguous():
            raise ValueError(f"sab_density: {name} must be contiguous")
        if name in ("v", "awr", "kt") and x.shape != pmid.shape[:1]:
            raise ValueError(f"sab_density: {name} must be ({pmid.shape[0]},), got {tuple(x.shape)}")


@lru_cache(maxsize=1)
def sab_ulad_table() -> np.ndarray:
    """The fixed-ladder table the kernel stages in shared memory: (3, 10, 24)
    float64 (read-only), for each u-panel [ULAD[k], ULAD[k+1]] its 24 GL
    nodes u, their weights w and exp(-u^2). u and w are rounded as _sab_dens
    rounds them (u = pm + ph x_q, w = ph w_q, a product and then a sum), so
    they equal the plain version's nodes on such a panel bit for bit."""
    xq, wq = gl_nodes_weights(NQ_U)
    e0, e1 = _SAB_ULAD[:-1], _SAB_ULAD[1:]
    pm, ph = 0.5 * (e1 + e0), 0.5 * (e1 - e0)
    u = pm[:, None] + ph[:, None] * xq[None, :]
    table = np.stack([u, ph[:, None] * wq[None, :], np.exp(-(u * u))])
    table.flags.writeable = False
    return table


@lru_cache(maxsize=16)
def _ulad_device(device: torch.device) -> torch.Tensor:
    return device_table(tuple(sab_ulad_table().ravel().tolist()), torch.float64, device)


def sab_lanes(rows: int, n_panels: int = Y_PANELS, sms: int = H100_SMS) -> int:
    """The lanes per y-node the kernel takes for a (rows, n_panels) tile."""
    return lane_group(rows * n_panels * NQ_G, sms)


def sab_tile_lanes(rows: int, device: torch.device) -> int | None:
    """The lanes per y-node of a dispatch tile of `rows` rows on `device`
    (None off the card): what the free-gas driver passes for every piece of
    a tile split over shards, so that each sums as the whole tile would."""
    return sab_lanes(rows, Y_PANELS, device_sms(device)) if device.type == "cuda" else None


def sab_density(pmid, phalf, v, awr, kt, order: int, chunk: int = Y_PANELS, lanes: int | None = None):
    """g(y) = dF_l/dE' * 2y at every GL node of the y-panels: (T, NP, NQ_G, L+1).

    pmid/phalf: (T, NP) y-panel mids and halves; v = sqrt(E), awr, kt: (T,).
    CUDA tensors launch the kernel on the current stream without
    synchronising (chunk is not read), with `lanes` lanes per y-node (1, 2,
    4 or 8; None: sab_lanes of this call's tile). The lanes fix the order of
    each sum, so a caller that splits a tile (the driver, over shards)
    passes the whole tile's. CPU tensors take sab_density_ref.
    """
    _check_sab(pmid, phalf, v, awr, kt, order)
    check_lanes("sab_density", lanes)
    if pmid.device.type == "cpu":
        return sab_density_ref(pmid, phalf, v, awr, kt, order, chunk)
    if pmid.device.type != "cuda":
        raise ValueError(f"sab_density: unsupported device {pmid.device}")
    tt, npan = pmid.shape
    out = torch.empty((tt, npan, NQ_G, order + 1), dtype=torch.float64, device=pmid.device)
    if tt == 0 or npan == 0:
        return out
    g = lanes or sab_lanes(tt, npan, device_sms(pmid.device))
    lib = _sab_library()
    xg, _ = gl_nodes_weights(NQ_G)
    xu, wu = gl_nodes_weights(NQ_U)
    table = _ulad_device(pmid.device)
    with torch.cuda.device(pmid.device):
        stream = torch.cuda.current_stream(pmid.device).cuda_stream
        rc = lib.freegas_sab_launch(
            *(x.data_ptr() for x in (pmid, phalf, v, awr, kt, table)), tt, npan, NQ_G, order, g,
            *(a.ctypes.data for a in (xg, xu, wu, _SAB_ULAD, _SAB_CLAD)), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sab_density: kernel launch failed with cudaError {rc}")
    sab_density.launches += 1
    sab_density.launches_by_stream[stream] += 1
    sab_density.lane_groups[g] += 1
    return out


# Launches of the CUDA kernel since the last reset, in all, by the CUDA
# stream that took them, and by the lanes per y-node. CPU calls never count.
sab_density.launches = 0
sab_density.launches_by_stream = Counter()
sab_density.lane_groups = Counter()


@lru_cache(maxsize=1)
def _sab_library() -> ctypes.CDLL:
    """The loaded kernel library (every order and lane group), built on first use."""
    path, _ = build_cuda(_SRC)
    lib = ctypes.CDLL(str(path))
    fn = lib.freegas_sab_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    return lib


def _pointwise_dens(
    y, v, awr, gamma, beta, inv_beta, a_ratio, lo_r_dom, hi_r_dom,
    ladder, offs_c, xr, wr, xc, wc, order: int,
    nfill_r: int, nfill_c: int, ngeo_c: int,
):
    """dF_l/dE'(y) at outgoing points by the (v_r, V_cm) quadrature of the
    target's motion: a list of L+1 (T, NY) tensors; y is (T, NY).

    Relative speed v_r and CM speed V_cm (units y = sqrt(E)): weight
    v_r^2 V_cm exp(-beta^2 V^2) with V^2 = -v^2/A + v_r^2/(A+1) + V_cm^2 (A+1)/A,
    E' uniform over [(V_cm - u)^2, (V_cm + u)^2] (u = gamma v_r) with density
    1/(4 V_cm u), and P_l(mu_lab) averaged over azimuth as P_l(c_a) P_l(c_b).
    The v_r panels per (row, y) are graded around v and cut at the kinks of
    the reachable ranges; the V_cm panels per (row, y, v_r node) are graded
    around the weight's peak, filled uniformly and graded geometrically at
    their low end. The reference's lax.scan over v_r panels is a Python loop
    that keeps only the L+1 accumulators across iterations.
    """
    dtype, dev = y.dtype, y.device
    tt, ny = y.shape
    nq_r = xr.shape[0]

    # per-(row, y) outer v_r edges: Maxwellian ladder + 3 closed-form kinks
    # (|v - y| covers down- and up-scatter)
    base_e = (v[:, None] + inv_beta[:, None] * ladder[None, :])[:, None, :].expand(tt, ny, ladder.shape[0])
    g2 = (2.0 * gamma)[:, None]
    kinks = torch.stack([y / gamma[:, None], torch.abs(v[:, None] - y) / g2, (v[:, None] + y) / g2], dim=-1)

    # V_cm-ladder layout transitions: vstar(vr) crossing the V_cm-domain ends
    # |y - u|, y + u, |v - u|, v + u, the roots of
    #   (A/(A+1)) vr^2 -+ 2 z gamma vr + z^2 - v^2/(A+1) = 0, z in {y, v}
    a2 = (awr / (awr + 1.0))[:, None]
    vsc = (v * v / (awr + 1.0))[:, None]
    root_parts = []
    for z in (y, v[:, None].expand(tt, ny)):
        for sgn in (-1.0, 1.0):
            bq = sgn * 2.0 * z * gamma[:, None]
            disc = bq * bq - 4.0 * a2 * (z * z - vsc)
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            root_parts.append((-bq + sq) / (2.0 * a2))
            root_parts.append((-bq - sq) / (2.0 * a2))
    vkinks = torch.stack(root_parts, dim=-1)  # (T, NY, 8)

    # uniform fill: P_l(c_a) P_l(c_b) oscillates across the whole domain
    fill_fr = torch.as_tensor(np.linspace(0.0, 1.0, nfill_r + 2)[1:-1], dtype=dtype, device=dev)
    lo_d, hi_d = lo_r_dom[:, None, None], hi_r_dom[:, None, None]
    fill_r = (lo_d + (hi_r_dom - lo_r_dom)[:, None, None] * fill_fr).expand(tt, ny, fill_fr.shape[0])
    edges_r = torch.sort(_clip(torch.cat([base_e, kinks, vkinks, fill_r], dim=-1), lo_d, hi_d), dim=-1).values
    del base_e, kinks, vkinks, fill_r, root_parts
    nrp = edges_r.shape[-1] - 1

    fill_cf = torch.as_tensor(_c_fill(nfill_c, ngeo_c), dtype=dtype, device=dev)
    vv3 = v[:, None, None]
    v2_ = (v * v)[:, None, None, None]
    y2_ = (y * y)[..., None, None]
    y4 = y[..., None, None]
    awr4 = awr[:, None, None, None]
    ap1_4 = (awr + 1.0)[:, None, None, None]
    ar4 = a_ratio[:, None, None, None]
    nb2_4 = -(beta * beta)[:, None, None, None]
    two_v4 = 2.0 * v[:, None, None, None]
    vstar_c0 = (v * v / (awr + 1.0))[:, None, None]
    vstar_c1 = (awr / ((awr + 1.0) * (awr + 1.0)))[:, None, None]
    w_quad = (1.0 / (beta * torch.sqrt(a_ratio)))[:, None, None, None]
    w_lin_d = (beta * beta * 2.0 * a_ratio)[:, None, None]

    acc = [torch.zeros_like(y) for _ in range(order + 1)]
    for rp in range(nrp):
        e_lo = edges_r[..., rp]
        e_hi = edges_r[..., rp + 1]
        rmid = 0.5 * (e_hi + e_lo)  # (T, NY)
        rhalf = 0.5 * (e_hi - e_lo)
        vr = rmid[..., None] + rhalf[..., None] * xr  # (T, NY, QR)
        w_r = rhalf[..., None] * wr
        u = gamma[:, None, None] * vr
        lo_c = torch.maximum(torch.abs(y[..., None] - u), torch.abs(vv3 - u))
        hi_c = torch.minimum(y[..., None] + u, vv3 + u)
        ok_rc = hi_c > lo_c
        # graded V_cm nodes inside [lo_c, hi_c]
        vstar = torch.sqrt(torch.clamp_min(vstar_c0 - vstar_c1 * (vr * vr), 0.0))
        anchor = _clip(vstar, lo_c, hi_c)
        w_lin = 1.0 / (w_lin_d * torch.clamp_min(anchor, 1e-30))
        lo4, hi4 = lo_c[..., None], hi_c[..., None]
        g_q = _clip(anchor[..., None] + w_quad * offs_c, lo4, hi4)
        g_l = _clip(anchor[..., None] + w_lin[..., None] * offs_c, lo4, hi4)
        g_f = lo4 + (hi_c - lo_c)[..., None] * fill_cf
        edges_c = torch.sort(torch.cat([lo4, g_q, g_l, g_f, hi4], dim=-1), dim=-1).values  # (T, NY, QR, EC)
        del g_q, g_l, g_f, vstar, anchor, w_lin
        cmid = 0.5 * (edges_c[..., 1:] + edges_c[..., :-1])
        chalf = 0.5 * (edges_c[..., 1:] - edges_c[..., :-1])
        del edges_c
        cc = (cmid[..., None] + chalf[..., None] * xc).reshape(tt, ny, nq_r, -1)  # (T, NY, QR, C)
        w_c = (chalf[..., None] * wc).reshape(tt, ny, nq_r, -1)
        del cmid, chalf

        u4 = u[..., None]
        cc2 = cc * cc
        vsq = -v2_ / awr4 + (vr * vr)[..., None] / ap1_4 + cc2 * ar4
        # the exponent is clamped at 0: vsq >= 0 on every valid cell, and the
        # masked ones must not overflow (inf * 0 = NaN)
        wgt = (vr * vr)[..., None] * cc * torch.exp(torch.clamp_max(nb2_4 * vsq, 0.0)) * w_c * w_r[..., None] * ok_rc[..., None]
        del vsq, w_c
        # guard the products: factors can underflow to 0 jointly on masked cells
        dens = wgt / torch.clamp_min(4.0 * cc * u4, 1e-30)  # x E'-density 1/(4 C u)
        del wgt
        uu = u4 * u4
        c_a = torch.clamp((v2_ + cc2 - uu) / torch.clamp_min(two_v4 * cc, 1e-30), -1.0, 1.0)
        c_b = torch.clamp((y2_ + cc2 - uu) / torch.clamp_min(2.0 * y4 * cc, 1e-30), -1.0, 1.0)
        del cc, cc2, uu
        acc[0] = acc[0] + torch.sum(dens, dim=(2, 3))
        if order >= 1:
            pa_prev = torch.ones_like(c_a)
            pb_prev = torch.ones_like(c_b)
            pa_cur, pb_cur = c_a, c_b
            acc[1] = acc[1] + torch.sum(dens * pa_cur * pb_cur, dim=(2, 3))
            for l in range(1, order):
                pa_next = ((2 * l + 1) * c_a * pa_cur - l * pa_prev) / (l + 1)
                pb_next = ((2 * l + 1) * c_b * pb_cur - l * pb_prev) / (l + 1)
                pa_prev, pa_cur = pa_cur, pa_next
                pb_prev, pb_cur = pb_cur, pb_next
                acc[l + 1] = acc[l + 1] + torch.sum(dens * pa_cur * pb_cur, dim=(2, 3))
    return acc


# ---------------------------------------------------------------------------
# The reference's cross-checks: the kink-panel ("grouped") kernel, the
# pointwise-E' kernel with panels at every group boundary, and the
# sigma_eff/sigma_free validation hook. No driver calls them; the tests hold
# them against their JAX functions and against the production kernel.


def _vcm_panel_nodes(v, vr, u, awr, beta, xc, wc, sb=None):
    """Graded V_cm quadrature nodes/weights for given (row, v_r) values.

    v/vr/u: (...,) tensors; awr/beta broadcast with them. When ``sb``
    ((G+1,) sqrt-boundaries) is given, the exact kink lines V_cm = sb_g -+ u
    (where the inner group-clipped integral changes branch) are inserted as
    panel edges, keeping every GL panel smooth. Returns cc, w_c with a
    flattened trailing node axis.
    """
    a_ratio = (awr + 1.0) / awr
    clo = torch.abs(v - u)
    chi_ = v + u
    # weight peak: V^2 = 0 at V_cm*^2 = v^2/(A+1) - A vr^2/(A+1)^2
    vstar = torch.sqrt(torch.clamp_min(v * v / (awr + 1.0) - awr * vr * vr / (awr + 1.0) ** 2, 0.0))
    anchor = _clip(vstar, clo, chi_)
    # two ladder scales: quadratic regime (peak interior) and linear regime
    # (peak clipped at the domain edge, where the Gaussian band is narrower)
    w_quad = 1.0 / (beta * torch.sqrt(a_ratio))
    w_lin = 1.0 / (beta * beta * 2.0 * torch.clamp_min(anchor, 1e-30) * a_ratio)
    offs = torch.as_tensor(_VCM_OFFSETS, dtype=v.dtype, device=v.device)
    lo, hi = clo[..., None], chi_[..., None]
    parts = [
        lo,
        _clip(anchor[..., None] + w_quad[..., None] * offs, lo, hi),
        _clip(anchor[..., None] + w_lin[..., None] * offs, lo, hi),
        hi,
        # |V_cm - u| branch switch: the inner-range lower end kinks at V_cm = u
        _clip(u[..., None], lo, hi),
    ]
    if sb is not None:
        finite = torch.where(torch.isfinite(sb), sb, torch.zeros_like(sb))
        # kink families |V_cm - u| = sb_g and V_cm + u = sb_g reduce to the
        # two value sets u + sb_g and |u - sb_g|
        parts.append(_clip(u[..., None] + finite, lo, hi))
        parts.append(_clip(torch.abs(u[..., None] - finite), lo, hi))
    edges = torch.sort(torch.cat(parts, dim=-1), dim=-1).values
    mid = 0.5 * (edges[..., 1:] + edges[..., :-1])
    half = 0.5 * (edges[..., 1:] - edges[..., :-1])
    cc = (mid[..., None] + half[..., None] * xc).reshape(*mid.shape[:-1], -1)
    w_c = (half[..., None] * wc).reshape(*mid.shape[:-1], -1)
    return cc, w_c


def _leg_monomial_coeffs(order: int) -> list[np.ndarray]:
    """Monomial coefficients of P_l, l = 0..order (exact in f64 for l <= ~12)."""
    return [np.polynomial.legendre.leg2poly(np.eye(l + 1)[l]) for l in range(order + 1)]


def _inner_closed_form(lo, hi, cc, u, order: int):
    """J_l = (1/(2 C u)) * int_lo^hi P_l((y^2 + D)/(2 C y)) y dy, D = C^2 - u^2.

    lo/hi/cc/u broadcastable tensors (pre-clipped, lo <= hi); returns a list
    of L+1 tensors. Exact (power rule + log term). The lower limit is floored
    as in the reference (which keeps its Laurent terms inside the TPU's
    emulated-f64 range): it drops outgoing energies below ~floor^2 eV.
    """
    d = cc * cc - u * u
    inv2c = 1.0 / (2.0 * cc)
    p_min = min(2 - order, 1)
    p_max = order + 2
    lo_floor = 10.0 ** (-min(30.0 / (order - 2), 12.0)) if order > 2 else 1e-12
    lo = torch.clamp_min(lo, lo_floor)
    hi = torch.maximum(hi, lo)
    pow_lo = {0: torch.ones_like(lo), 1: lo}
    pow_hi = {0: torch.ones_like(hi), 1: hi}
    for p in range(2, p_max + 1):
        pow_lo[p] = pow_lo[p - 1] * lo
        pow_hi[p] = pow_hi[p - 1] * hi
    inv_lo, inv_hi = 1.0 / lo, 1.0 / hi
    for p in range(-1, p_min - 1, -1):
        pow_lo[p] = pow_lo[p + 1] * inv_lo
        pow_hi[p] = pow_hi[p + 1] * inv_hi
    log_diff = torch.log(torch.clamp_min(hi, 1e-30)) - torch.log(torch.clamp_min(lo, 1e-30))

    out = []
    for a in _leg_monomial_coeffs(order):
        acc = torch.zeros_like(lo)
        for k in range(a.size):
            if a[k] == 0.0:
                continue
            for m in range(k + 1):
                p_exp = 2 * m + 2 - k  # antiderivative exponent of the y^{2m+1-k} term
                scale = float(a[k]) * comb(k, m) * inv2c**k * (d ** (k - m) if k - m > 0 else 1.0)
                if p_exp == 0:
                    acc = acc + scale * log_diff
                else:
                    acc = acc + (scale / p_exp) * (pow_hi[p_exp] - pow_lo[p_exp])
        out.append(acc * inv2c / u)  # the 1/(2 C u) prefactor
    return out


def _effective_sqrt_bounds(bounds, clamp: bool):
    """sqrt of group boundaries, with edge groups extended under clamping."""
    sb = torch.sqrt(torch.clamp_min(bounds, 0.0))
    if not clamp:
        return sb
    return torch.cat([sb.new_zeros(1), sb[1:-1], sb.new_full((1,), float("inf"))])


def freegas_moments(e, awr, kt, bounds, order: int, nq_r: int = 8, nq_c: int = 12, clamp: bool = True):
    """Free-gas transfer moments by the kink-panel kernel: (T, L+1, G), rows
    normalized per scatter.

    e: (T,) incident energies (eV); awr, kt: scalars or (T,); bounds: (G+1,)
    group boundaries (eV). The (v_r, V_cm) quadrature takes O(G) exact
    breakpoints in both dimensions and the innermost v' integral is closed
    form per group (_inner_closed_form). The reference's lax.scan over v_r
    nodes is a Python loop over them.
    """
    dtype, dev = e.dtype, e.device
    ng = bounds.shape[0] - 1
    v = torch.sqrt(e)
    awr, kt = _per_row(awr, e), _per_row(kt, e)
    gamma = awr / (awr + 1.0)
    beta = torch.sqrt(awr / kt)
    inv_beta = 1.0 / beta
    sb = _effective_sqrt_bounds(bounds, clamp)

    # per-row outer v_r panels: Maxwellian-graded offsets plus the closed-form
    # kinks where a split line V_cm = sb_g -+ u crosses the V_cm domain ends:
    # v_r in {(v + sb_g)/2gamma, |v - sb_g|/2gamma}
    offsets = torch.as_tensor(_VR_OFFSETS, dtype=dtype, device=dev)
    graded_r = v[:, None] + inv_beta[:, None] * offsets[None, :]
    lo_r = torch.clamp_min(v - 8.0 * inv_beta, 0.0)[:, None]
    hi_r = (v + 8.0 * inv_beta)[:, None]
    sbf = torch.where(torch.isfinite(sb), sb, torch.zeros_like(sb))[None, :]
    g2 = (2.0 * gamma)[:, None]
    kinks = _clip(torch.cat([(v[:, None] + sbf) / g2, torch.abs(v[:, None] - sbf) / g2], dim=1), lo_r, hi_r)
    edges = torch.sort(torch.cat([torch.clamp_min(graded_r, 0.0), kinks], dim=1), dim=1).values
    mid_p = 0.5 * (edges[:, 1:] + edges[:, :-1])
    half_p = 0.5 * (edges[:, 1:] - edges[:, :-1])
    xr, wr = gl_nodes_weights(nq_r)
    xc, wc = (torch.as_tensor(a, dtype=dtype, device=dev) for a in gl_nodes_weights(nq_c))
    a_ratio = (awr + 1.0) / awr
    v2 = (v * v)[:, None]

    num = e.new_zeros((e.shape[0], order + 1, ng))
    den = torch.zeros_like(e)
    for p in range(mid_p.shape[1]):
        for q in range(nq_r):
            vr = mid_p[:, p] + half_p[:, p] * float(xr[q])  # (T,)
            w_r = half_p[:, p] * float(wr[q])
            u = gamma * vr
            cc, w_c = _vcm_panel_nodes(v, vr, u, awr, beta, xc, wc, sb)  # (T, C)
            vsq = -v2 / awr[:, None] + (vr * vr)[:, None] / (awr + 1.0)[:, None] + cc * cc * a_ratio[:, None]
            # exponent clamped at 0: vsq >= 0 wherever the weight is live
            weight = (vr * vr)[:, None] * cc * torch.exp(torch.clamp_max(-(beta * beta)[:, None] * vsq, 0.0)) * w_c
            weight = weight * w_r[:, None]
            c_a = torch.clamp((v2 + cc * cc - (u * u)[:, None]) / (2.0 * v[:, None] * cc), -1.0, 1.0)
            pl_a = legendre_all(c_a, order)  # (T, C, L+1)
            # inner: closed form per group over [max(|C-u|, sb_g), min(C+u, sb_{g+1})]
            u3, cc3 = u[:, None, None], cc[:, :, None]
            lo_g = torch.maximum(torch.abs(cc3 - u3), sb[None, None, :-1])  # (T, C, G)
            hi_g = torch.minimum(cc3 + u3, sb[None, None, 1:])
            valid = hi_g > lo_g
            one = torch.ones_like(lo_g)
            j_list = _inner_closed_form(torch.where(valid, lo_g, one), torch.where(valid, hi_g, one), cc3, u3, order)
            num += torch.stack(
                [
                    torch.einsum("tc,tc,tcg->tg", weight, pl_a[:, :, l], torch.where(valid, j_list[l], 0.0))
                    for l in range(order + 1)
                ],
                dim=1,
            )
            den += torch.sum(weight, dim=1)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return num / den[:, None, None]


def freegas_sigma_eff_ratio(e, awr: float, kt: float, nq_r: int = 8, nq_c: int = 8):
    """sigma_eff/sigma_free = vbar_r / v computed with the SAME quadrature.

    Validation hook: the analytic result is
      (1 + 1/(2x^2)) erf(x) + exp(-x^2)/(sqrt(pi) x),  x = sqrt(A E / kT).
    Agreement checks the (v_r, V_cm) quadrature independently of any moments.
    awr and kt are scalars.
    """
    dtype, dev = e.dtype, e.device
    v = torch.sqrt(e)
    awr = torch.as_tensor(awr, dtype=dtype, device=dev)
    gamma = awr / (awr + 1.0)
    beta = torch.sqrt(awr / kt)
    offsets = torch.as_tensor(_VR_OFFSETS, dtype=dtype, device=dev)
    edges = torch.sort(torch.clamp_min(v[:, None] + (1.0 / beta) * offsets[None, :], 0.0), dim=1).values
    mid_p = 0.5 * (edges[:, 1:] + edges[:, :-1])
    half_p = 0.5 * (edges[:, 1:] - edges[:, :-1])
    xr, wr, xc, wc = (
        torch.as_tensor(a, dtype=dtype, device=dev) for a in (*gl_nodes_weights(nq_r), *gl_nodes_weights(nq_c))
    )
    vr = mid_p[:, :, None] + half_p[:, :, None] * xr  # (T, P, R)
    w_r = half_p[:, :, None] * wr
    u = gamma * vr
    cc, w_c = _vcm_panel_nodes(v[:, None, None].expand(vr.shape), vr, u, awr, beta, xc, wc)  # (T, P, R, C)
    vsq = -(v * v)[:, None, None, None] / awr + (vr * vr)[..., None] / (awr + 1.0) + cc * cc * ((awr + 1.0) / awr)
    wgt = (vr * vr)[..., None] * cc * torch.exp(torch.clamp_max(-(beta * beta) * vsq, 0.0)) * w_c * w_r[..., None]
    # vbar_r = (2 beta^3 / (sqrt(pi) gamma v)) * N_full; sigma_eff/sigma_free = vbar_r / v
    n_full = torch.sum(wgt, dim=(1, 2, 3))
    return 2.0 * beta**3 * n_full / (math.sqrt(math.pi) * gamma * v * v)


def freegas_moments_pointwise(
    e,
    awr,
    kt,
    bounds,
    order: int,
    nq_g: int = 8,
    nq_r: int = 8,
    nq_c: int = 8,
    chunk: int = 8,
    nfill_r: int = 7,
    nfill_c: int = 7,
    ngeo_c: int = 8,
):
    """Free-gas transfer moments via the pointwise-E' path: (T, L+1, G).

    The density of _pointwise_dens at GL points of outgoing y-panels cut at
    every group boundary, the cusp y = v and graded ladders around it and
    around sqrt(alpha) v; each panel's GL sum lands in the group holding its
    midpoint. bounds must be FINITE and COVER the kinematically reachable
    outgoing range: rows are normalized by their own l = 0 total. chunk:
    y-panels evaluated at a time (the result does not depend on it).
    """
    dtype, dev = e.dtype, e.device
    ng = bounds.shape[0] - 1
    tt = e.shape[0]
    v = torch.sqrt(e)
    awr, kt = _per_row(awr, e), _per_row(kt, e)
    gamma = awr / (awr + 1.0)
    beta = torch.sqrt(awr / kt)
    inv_beta = 1.0 / beta
    a_ratio = (awr + 1.0) / awr
    sb = torch.sqrt(torch.clamp_min(bounds, 0.0))  # (G+1,) finite

    # outgoing panels in y: group boundaries, the cusp at y = v, and graded
    # ladders around the thermal spike and the smeared 0K down-scatter edge
    delta = 2.0 * gamma * inv_beta
    lad = torch.as_tensor(_Y_LADDER, dtype=dtype, device=dev)
    y_alpha = v * torch.abs(awr - 1.0) / (awr + 1.0)
    extra = torch.cat(
        [v[:, None] + delta[:, None] * lad, y_alpha[:, None] + delta[:, None] * lad, torch.stack([v, y_alpha], dim=1)],
        dim=1,
    )
    extra = torch.clamp(extra, sb[0], sb[-1])
    y_edges = torch.sort(torch.cat([sb.expand(tt, ng + 1), extra], dim=1), dim=1).values
    npan = y_edges.shape[1] - 1
    pmid = 0.5 * (y_edges[:, 1:] + y_edges[:, :-1])  # (T, P)
    phalf = 0.5 * (y_edges[:, 1:] - y_edges[:, :-1])
    pg = (torch.searchsorted(bounds, (pmid * pmid).contiguous(), right=True) - 1).clamp_(0, ng - 1)  # by midpoint

    xg, wg, xr, wr, xc, wc = (
        torch.as_tensor(a, dtype=dtype, device=dev)
        for a in (*gl_nodes_weights(nq_g), *gl_nodes_weights(nq_r), *gl_nodes_weights(nq_c))
    )
    lo_r_dom = torch.clamp_min(v - 8.0 * inv_beta, 0.0)
    hi_r_dom = v + 8.0 * inv_beta
    ladder = torch.as_tensor(_VR_OFFSETS, dtype=dtype, device=dev)
    offs_c = torch.as_tensor(_VCM_OFFSETS, dtype=dtype, device=dev)

    panel_vals = e.new_zeros((tt, npan, order + 1))
    for c0 in range(0, npan, chunk):
        pm, ph = pmid[:, c0 : c0 + chunk], phalf[:, c0 : c0 + chunk]
        n = pm.shape[1]
        y = (pm[:, :, None] + ph[:, :, None] * xg).reshape(tt, n * nq_g)
        wy = (ph[:, :, None] * wg).reshape(tt, n * nq_g) * 2.0 * y  # dE' = 2y dy
        dsig = _pointwise_dens(
            y, v, awr, gamma, beta, inv_beta, a_ratio, lo_r_dom, hi_r_dom,
            ladder, offs_c, xr, wr, xc, wc, order, nfill_r, nfill_c, ngeo_c,
        )
        vals = torch.stack(dsig, dim=-1) * wy[..., None]  # (T, NY, L+1)
        panel_vals[:, c0 : c0 + n] = vals.reshape(tt, n, nq_g, order + 1).sum(dim=2)

    # normalization: the numerator's own l = 0 total over the covering window
    n_full = panel_vals[:, :, 0].sum(dim=1)
    n_full = torch.where(n_full > 0, n_full, torch.ones_like(n_full))
    out = e.new_zeros((tt, ng, order + 1)).scatter_add_(1, pg[:, :, None].expand(tt, npan, order + 1), panel_vals)
    return out.transpose(1, 2) / n_full[:, None, None]
