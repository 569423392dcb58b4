"""Continuum-law group-transfer moments (laws 4/44/61/66; config 4).

Counterpart of ndpp_tpu/ops/continuum.py. Two device paths (SURVEY.md
section 3.4):

lab_tabular_moments
  Lab frame: the angular factor decouples per outgoing-energy knot, so
  f_{l,g'}(E) = int p(E'|E) M_l(E') dE' with host-precomputed EXACT
  per-knot moments M_l (host.angular_moments). Sorted-edges + GL; the
  integrand is piecewise-quadratic, so modest GL order is exact.

cm_moments_pointwise
  CM frame (Kalbach law 44, CM tabular law 61/4, N-body law 66): the exact
  (mu_cm, E'_cm) -> (E'_lab, y = sqrt(E'_cm)) change of variables — constant
  Jacobian 1/s, no CM->lab fold, group classification exact by panel
  construction, cost linear in the group count. See its docstring for the
  full derivation.

Float64 torch functions on the device of their arguments, except the inner
integral of cm_moments_pointwise: cm_inner_moments runs the hand-written
CUDA kernel (csrc/cm_pointwise.cu) on a CUDA tensor, one launch for every
outer node of a tile, and its plain torch version cm_inner_moments_ref on a
CPU tensor; there is no fallback from one to the other. Lookups are
``torch.searchsorted`` + ``torch.gather``; sums into groups go through
ops.segment.segment_group_sum (cumsum + gather), which adds in a fixed
order, so a CUDA run gives the same bits every time (a scatter-add of
float64 uses atomics there and does not).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache
from pathlib import Path

import numpy as np
import scipy.special as sps
import torch

from ndpp_tpu_torch.ops.lanes import H100_SMS, check_lanes, device_sms, lane_group
from ndpp_tpu_torch.ops.legendre import device_table, gl_nodes_weights
from ndpp_tpu_torch.ops.panelsplit import lagrange_cumulants
from ndpp_tpu_torch.ops.segment import effective_bounds, segment_group_sum
from ndpp_tpu_torch.utils.build import build_cuda

# Bytes of float64 node tensors one cm_moments_pointwise chunk may hold at a
# time (chunk_for). About _LIVE_NODE_TENSORS tensors of (T, NW, SY, QY) are
# alive at the widest point of the chunk body: a cm-tabular tile of 178 MB
# node tensors peaked at 3.49 GB of device memory (NVIDIA H100 80GB HBM3,
# scripts/torch_profile_deck.py continuum).
CHUNK_BUDGET_BYTES = 2 << 30
_LIVE_NODE_TENSORS = 20


def _searchsorted_last(b, q):
    """Right-insertion index minus 1 of q into the sorted last axis of b.

    b: (NB,) shared or (T, NB) per-row; q: (T, S). Returns int64 (T, S).
    """
    return torch.searchsorted(b.contiguous(), q.contiguous(), right=True) - 1


def _panel_index_rows(knots, q):
    """Index of the knot panel containing each query.

    knots: (K,) shared or (T, K) per-row, non-decreasing (duplicates = dead
    panels); q: (T, S). Returns int64 (T, S) in [0, K-2]: the LAST j with
    knots[j] <= q, so a dead panel never matches, queries below the first
    knot take panel 0 and queries at or above the last knot take panel K-2
    (the reference's first-match rule, ndpp_tpu/ops/continuum.py
    _panel_index_rows).
    """
    return _searchsorted_last(knots, q).clamp_(0, knots.shape[-1] - 2)


def _affine_panel_coeffs(knots, chans):
    """Per-knot-panel affine coefficients (a, b) of channels on one knot table.

    knots: (T, K); chans: (T, K, C). Returns (T, K-1, C) pairs with
    value(x) = a + b x on panel j; a dead (zero-width) panel keeps the left
    value and slope 0.
    """
    dx = knots[:, 1:] - knots[:, :-1]
    ok = (dx > 0)[..., None]
    dxs = torch.where(dx > 0, dx, torch.ones_like(dx))[..., None]
    c0 = chans[:, :-1]
    b = torch.where(ok, (chans[:, 1:] - c0) / dxs, torch.zeros_like(c0))
    a = torch.where(ok, c0 - b * knots[:, :-1, None], c0)
    return a, b


def _gather_rows(payload, idx):
    """out[t, q, :] = payload[t, idx[t, q], :]; payload (T, K, C), idx (T, Q)."""
    return torch.gather(payload, 1, idx[:, :, None].expand(idx.shape[0], idx.shape[1], payload.shape[2]))


def discrete_lines_moments(e_out, w, am, bounds, clamp: bool = True):
    """Exact moments of per-row weighted discrete outgoing-energy lines.

    Law 4/44/61 tables may carry ND delta lines ahead of the continuous part
    (ACE DLW convention); each line contributes its probability times its
    angular Legendre factors in the group containing its energy.

    e_out: (T, J) eV; w: (T, J) line probabilities; am: (T, J, L+1);
    bounds: (G+1,). Returns (T, L+1, G). With clamp, out-of-range lines
    collapse into the edge groups; otherwise they are dropped.
    """
    ng = bounds.shape[0] - 1
    tt, nj, l1 = am.shape
    g = _searchsorted_last(bounds, e_out)  # (T, J)
    if not clamp:
        w = w * ((g >= 0) & (g < ng))
    g = g.clamp_(0, ng - 1)
    out = am.new_zeros((tt, l1, ng))
    # one scatter per line index: inside a call every (row, l) writes its own
    # element, so the adds run in a fixed order (line 0, 1, ...) on any device
    for j in range(nj):
        out.scatter_add_(2, g[:, j, None, None].expand(tt, l1, 1), (am[:, j, :] * w[:, j, None])[:, :, None])
    return out


def lab_tabular_moments(e_knots, pdf, moms, bounds, order: int, nq: int = 6, clamp: bool = True):
    """f_{l,g'} rows for lab-frame tabular spectra.

    e_knots/pdf: (T, K); moms: (T, K, L+1) per-knot exact angular moments.
    bounds: shared (G+1,) or per-row (T, B+1) group-band windows (each
    row's window must cover its knot support). Returns (T, L+1, G|B).
    """
    xq, wq = gl_nodes_weights(nq)
    xq = torch.as_tensor(xq, dtype=pdf.dtype, device=pdf.device)
    wq = torch.as_tensor(wq, dtype=pdf.dtype, device=pdf.device)
    tt = e_knots.shape[0]
    eff = effective_bounds(bounds, clamp)
    if eff.dim() == 1:
        eff = eff[None, :].expand(tt, eff.shape[0])
    brk = torch.minimum(torch.maximum(eff, e_knots[:, :1]), e_knots[:, -1:])
    edges = torch.sort(torch.cat([e_knots, brk], dim=1), dim=1).values
    lo, hi = edges[:, :-1], edges[:, 1:]
    half = 0.5 * (hi - lo)
    mid = 0.5 * (hi + lo)
    x = mid[:, None, :] + half[:, None, :] * xq[None, :, None]  # (T, Q, S)
    # every subinterval lies inside one knot panel (the edges include all
    # knots): pdf and each M_l are one affine function of E' per subinterval
    a_k, b_k = _affine_panel_coeffs(e_knots, torch.cat([pdf[:, :, None], moms[:, :, : order + 1]], dim=2))
    j = _panel_index_rows(e_knots, mid)
    a_s = _gather_rows(a_k, j)  # (T, S, L+2)
    b_s = _gather_rows(b_k, j)
    w = (a_s[:, None, :, 0] + b_s[:, None, :, 0] * x) * wq[None, :, None] * half[:, None, :]
    m = torch.stack(
        [
            torch.sum(w * (a_s[:, None, :, l + 1] + b_s[:, None, :, l + 1] * x), dim=1)
            for l in range(order + 1)
        ],
        dim=1,
    )  # (T, L+1, S)
    m = m * (half > 0)[:, None, :]
    # mid is sorted along S, so each group is one contiguous run; without
    # clamp, subintervals outside [bounds[0], bounds[-1]) drop out
    return segment_group_sum(m, mid, bounds, clamp)


# N-body phase-space outgoing-energy knot ladder (fractions of emax): graded
# toward both support ends, where sqrt(x) and (emax-x)^expo defeat plain GL
_NBODY_LADDER = np.concatenate(
    [[0.0], 0.25 ** np.arange(12, 0, -1), [0.5], 1.0 - 0.25 ** np.arange(1, 13), [1.0]]
)
NBODY_KNOTS = _NBODY_LADDER.size  # KE of an energy="nbody" call


def inner_panel_count(ke: int, ksel: int, angular: str, kmu: int) -> int:
    """SY, the inner y-panels per outer node of cm_moments_pointwise."""
    nsel = ksel if 0 < ksel < ke else ke
    return nsel + 1 + (1 + 2 * kmu if angular == "tabular" else 0)


def outer_panel_count(ke: int, nb: int, angular: str, kmu: int, group_split: str, cross_edges: bool) -> int:
    """P, the outer w-panels per row of cm_moments_pointwise (nb = G or B)."""
    edges = 2 * ke + 3 + 20  # knot images y_k +- s, {s, w_min, w_max}, two graded ladders
    if angular == "tabular":
        edges += 3 * kmu + (ke * kmu if cross_edges else 0)
    if group_split != "lagrange":
        edges += nb + 1
    return edges - 1


def chunk_for(rows: int, nq_w: int, nq_y: int, sy: int, npan: int, budget_bytes: int = CHUNK_BUDGET_BYTES) -> int:
    """Outer panels per chunk so the chunk's live (T, NW, SY, QY) float64
    tensors (NW = chunk * nq_w) stay inside `budget_bytes`: between 1 and
    all `npan` panels. It bounds the plain path only: the CUDA kernel holds
    no such tensor."""
    per_panel = max(rows, 1) * nq_w * sy * nq_y * 8 * _LIVE_NODE_TENSORS
    return max(1, min(npan, budget_bytes // per_panel))


def cm_moments_pointwise(
    e,
    e_knots,
    pdf_e,
    r_rows,
    a_rows,
    mu_knots,
    mu_pdf,
    nbody_emax,
    nbody_expo: float,
    bounds,
    awr,
    order: int,
    nq_w: int = 8,
    nq_y: int = 8,
    angular: str = "kalbach",  # 'kalbach' | 'tabular' | 'isotropic'
    energy: str = "tabular",  # 'tabular' | 'nbody'
    clamp: bool = True,
    chunk: int = 8,
    ksel: int = 0,
    group_split: str = "panels",  # "panels" | "lagrange" (see below)
    cross_edges: bool = False,  # tabular only: K x KMU crossing-image outer edges
    lanes: int | None = None,  # the CUDA kernel's lanes per outer node (cm_inner_moments)
):
    """CM-frame continuum moments via the pointwise-E'_lab formulation: (T, L+1, G).

    Exact change of variables (mu_cm, E'_cm) -> (E'_lab, y = sqrt(E'_cm)):
    with s = sqrt(E)/(A+1) and w = sqrt(E'_lab),

        mu_cm  = (w^2 - s^2 - y^2) / (2 s y)        (single-valued: no CM->lab fold)
        mu_lab = (w^2 + s^2 - y^2) / (2 s w)
        |Jacobian| = 1/s                             (constant)
        mu_cm in [-1, 1]  <=>  y in [|w - s|, w + s]

    f_{l,g'} = (1/s) int_{g'} dE'_lab int dy p_E(y^2) p_mu(mu_cm) P_l(mu_lab),
    the inner y-window intersected with the data support. Outer panels in w
    use group boundaries as EXACT edges (a panel never crosses a boundary),
    plus the closed-form kink families {y_k +- s}, {s}, and for tabulated
    angles the mu-knot domain-entry images; inner panels in y use the data
    knots and (tabular) the closed-form mu-knot crossing roots
    y = -s mu_k +- sqrt(s^2 mu_k^2 + w^2 - s^2). Every GL panel therefore
    sees an analytic integrand (spectral convergence), the group
    classification is exact, and cost is LINEAR in G.

    e: (T,); e_knots/pdf_e/r_rows/a_rows: (T, KE); mu_knots: (KMU,);
    mu_pdf: (T, KE, KMU); nbody_emax: (T,). An operand its options do not
    read may be None: r_rows/a_rows outside angular="kalbach",
    mu_knots/mu_pdf outside "tabular", nbody_emax outside energy="nbody",
    e_knots/pdf_e inside it. bounds: shared (G+1,) or per-row
    (T, B+1) group-band windows — a banded call returns (T, L+1, B), and the
    caller guarantees each row's window covers its kinematic support, so the
    clamp semantics (edge groups absorb out-of-domain mass) are unchanged.

    ksel > 0 enables the windowed-knot path: only the <= ksel data knots
    that can fall inside a [|w-s|, w+s] window (host-verified bound) are
    gathered as inner panel edges; ksel = 0 uses every knot.

    group_split = "lagrange" drops the group boundaries from the outer
    panel edges (the density is SMOOTH across them) and splits panel
    integrals at the boundaries via the Lagrange cumulant machinery
    (ops/panelsplit) — outer cost becomes independent of G. "panels" is the
    boundary-edged scheme.

    chunk: outer panels evaluated at a time by the plain path. It bounds
    the live (T, chunk*nq_w, SY, QY) tensors and nothing else: each outer
    node's value is a sum over its own inner panels, so the result does not
    depend on it (ops.continuum.chunk_for picks it from a byte budget). The
    CUDA kernel takes every outer node of the call in one launch.
    """
    dtype, dev = e.dtype, e.device
    tt = e.shape[0]
    ng = bounds.shape[-1] - 1
    awr = torch.as_tensor(awr, dtype=dtype, device=dev).expand(e.shape)
    s = torch.sqrt(e.clamp_min(0.0)) / (awr + 1.0)  # (T,)
    s_safe = torch.where(s > 0, s, torch.ones_like(s))
    inv_s = torch.where(s > 0, 1.0 / s_safe, torch.zeros_like(s))

    if energy == "nbody":
        e_knots = nbody_emax[:, None] * torch.as_tensor(_NBODY_LADDER, dtype=dtype, device=dev)[None, :]
        beta_c = float(sps.beta(1.5, float(nbody_expo) + 1.0))
        emax_ok = nbody_emax > 0.0
        emax_safe = torch.where(emax_ok, nbody_emax, torch.ones_like(nbody_emax))
        c_norm = torch.where(
            emax_ok, 1.0 / (beta_c * emax_safe ** (nbody_expo + 1.5)), torch.zeros_like(nbody_emax)
        )  # (T,)

    ke = e_knots.shape[1]
    yk = torch.sqrt(e_knots.clamp_min(0.0)).contiguous()  # (T, KE)
    y_lo = yk[:, 0]
    y_hi = yk[:, -1]

    # ---- outer domain in w = sqrt(E'_lab)
    w_min = torch.where(
        (y_lo <= s) & (s <= y_hi), torch.zeros_like(s), torch.minimum((y_lo - s).abs(), (y_hi - s).abs())
    )
    w_max = y_hi + s
    sb = torch.sqrt(bounds.clamp_min(0.0))  # (G+1,) or (T, B+1)
    if not clamp:
        w_min = torch.maximum(w_min, sb[..., 0])
        w_max = torch.minimum(w_max, sb[..., -1])
    w_min_c = w_min[:, None]
    w_max_c = torch.maximum(w_max, w_min)[:, None]
    sb_rows = sb if sb.dim() == 2 else sb[None, :].expand(tt, ng + 1)

    s1 = s[:, None]  # (T, 1)
    parts = [yk + s1, (yk - s1).abs(), s1, w_min_c, w_max_c]
    if angular == "tabular":
        mu_knots = torch.as_tensor(mu_knots, dtype=dtype, device=dev)
        kmu = mu_knots.shape[0]
        mk = mu_knots[None, :]  # (1, KMU)
        for ye in (y_lo, y_hi):
            parts.append(torch.sqrt((ye[:, None] ** 2 + 2.0 * s1 * mk * ye[:, None] + (s**2)[:, None]).clamp_min(0.0)))
        # double-root pair birth: max_y mu_cm(y) = mu_k at w = s sqrt(1 - mu_k^2)
        parts.append(s1 * torch.sqrt((1.0 - mk**2).clamp_min(0.0)))
        if cross_edges:
            # K x KMU crossing-image family: the outer integrand
            # F(w) = int p dy has a C^1 kink wherever a mu-knot crossing
            # root coincides with a DATA knot, i.e. mu_cm(y_j; w) = mu_k,
            # whose closed-form image is
            #   w_jk = sqrt((y_j + s mu_k)^2 + s^2 (1 - mu_k^2)).
            # With every such w an outer panel EDGE, each panel's integrand
            # is analytic and GL converges spectrally on rough
            # tabular-angle tables.
            mk3 = mk[:, None, :]  # (1, 1, KMU)
            img = torch.sqrt(
                ((yk[:, :, None] + s[:, None, None] * mk3) ** 2 + (s**2)[:, None, None] * (1.0 - mk3**2)).clamp_min(0.0)
            )  # (T, KE, KMU)
            parts.append(img.reshape(tt, -1))
    # graded ladders at both support ends (integrand ~ w near w=0; windows
    # shrink linearly at both ends)
    lad = torch.as_tensor(4.0 ** -np.arange(1, 11, dtype=np.float64), dtype=dtype, device=dev)[None, :]
    span = w_max_c - w_min_c
    parts.append(w_min_c + span * lad)
    parts.append(w_max_c - span * lad)
    if group_split != "lagrange":
        parts.insert(0, sb_rows)
    w_edges = torch.sort(torch.minimum(torch.maximum(torch.cat(parts, dim=1), w_min_c), w_max_c), dim=1).values
    npan = w_edges.shape[1] - 1
    pmid = 0.5 * (w_edges[:, 1:] + w_edges[:, :-1])  # (T, P)
    phalf = 0.5 * (w_edges[:, 1:] - w_edges[:, :-1])

    xw, ww_ = (torch.as_tensor(a, dtype=dtype, device=dev) for a in gl_nodes_weights(nq_w))

    # Per-knot-panel affine coefficients of every interpolation channel,
    # computed ONCE at (T, KE-1) and looked up per inner panel.
    interp_chans = []
    if energy != "nbody":
        interp_chans.append(pdf_e)
    if angular == "kalbach":
        interp_chans += [r_rows, a_rows]
    chan_payload = None
    if interp_chans:
        a_c, b_c = _affine_panel_coeffs(e_knots, torch.stack(interp_chans, dim=-1))
        # (T, KE-1, 2*NCH): [a_0, b_0, a_1, b_1, ...]
        chan_payload = torch.stack([a_c, b_c], dim=-1).reshape(tt, ke - 1, 2 * len(interp_chans))

    # the inner integral at every outer node: one kernel launch on the card,
    # the plain version `chunk` outer panels at a time on the CPU
    nw = npan * nq_w
    w = (pmid[:, :, None] + phalf[:, :, None] * xw[None, None, :]).reshape(tt, nw)  # (T, NW)
    tab = angular == "tabular"
    nb = energy == "nbody"
    mnode = cm_inner_moments(
        w, s, yk, e_knots.contiguous(), chan_payload, mu_knots if tab else None, mu_pdf.contiguous() if tab else None,
        nbody_emax if nb else None, c_norm if nb else None, float(nbody_expo), order, nq_y, angular, energy, ksel,
        chunk=max(1, chunk) * nq_w, lanes=lanes,
    )  # (T, NW, L+1)
    if group_split == "lagrange":
        # node values of the DENSITY g(w) = dF/dw (2w from dE' = 2w dw, 1/s
        # Jacobian) — panel half-widths and GL weights are applied by
        # lagrange_cumulants, NOT here
        acc = (mnode * (2.0 * w * inv_s[:, None])[..., None]).reshape(tt, npan, nq_w, order + 1)
    else:
        w_wt = (phalf[:, :, None] * ww_[None, None, :]).reshape(tt, nw) * 2.0 * w  # dE' = 2w dw
        acc = (mnode * (w_wt * inv_s[:, None])[..., None]).reshape(tt, npan, nq_w, order + 1).sum(dim=2)

    if group_split == "lagrange":
        # effective boundaries: with clamping the edge groups absorb the
        # below-/above-window mass, so the outermost boundaries are the
        # DOMAIN ends (w_min, w_max); without clamping the domain was
        # already clipped to [sb_0, sb_G] above
        if clamp:
            b_arr = torch.cat([w_min_c, sb_rows[:, 1:-1], w_max_c], dim=1)
        else:
            b_arr = sb_rows
        cumul = lagrange_cumulants(w_edges, pmid, phalf, acc, ww_, b_arr, npan, nq_w)  # (T, G+1, L+1)
        return (cumul[:, 1:, :] - cumul[:, :-1, :]).transpose(1, 2)

    # a panel never crosses a boundary and pmid is sorted, so each group is
    # one contiguous run of panels; the domain was clipped into the table
    # above, so the edge groups take everything (clamp semantics either way)
    return segment_group_sum(acc.transpose(1, 2), pmid**2, bounds, True)


# ---------------------------------------------------------------------------
# The inner integral of cm_moments_pointwise on the card: the hand-written
# CUDA kernel csrc/cm_pointwise.cu and its plain version.

MAX_ORDER = 10
MAX_NQ_Y = 64  # inner GL nodes the kernel's parameter block holds (kMaxNqY)
ANGULAR = ("kalbach", "tabular", "isotropic")
ENERGY = ("tabular", "nbody")
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "cm_pointwise.cu"


def payload_columns(angular: str, energy: str) -> int:
    """2 * NCH: the columns of the (T, KE-1, 2*NCH) channel payload, an (a, b)
    pair for p_E (tabular energy) and for r and a (Kalbach)."""
    return 2 * ((energy != "nbody") + (2 if angular == "kalbach" else 0))


def cm_inner_moments_ref(
    w, s, yk, e_knots, payload, mu_knots, mu_pdf, nbody_emax, c_norm, nbody_expo: float,
    order: int, nq_y: int, angular: str, energy: str, ksel: int, chunk: int | None = None,
):
    """Plain torch version of the CM inner kernel: (T, NW, L+1).

    At every outer node w (T, NW), the sum over the inner y-panels of
    [|w - s|, w + s] cut at the data knots (a window of ksel of them when
    0 < ksel < KE) and, for tabular angles, at the mu-knot crossing roots,
    and over their nq_y GL nodes, of p_E(y^2) p_mu(mu_cm) wgt_y P_l(mu_lab),
    zero where the window misses the knot table (ok_w). s: (T,); yk =
    sqrt(e_knots): (T, KE); payload: (T, KE-1, 2*NCH) affine channel
    coefficients, None without channels; mu_knots (KMU,) and mu_pdf (T, KE,
    KMU) for tabular angles; nbody_emax and c_norm (T,) for N-body energies.
    chunk: outer nodes per pass of the torch body (all at once when None);
    each node's value is a sum over its own inner panels, so the result does
    not depend on it.
    """
    tt, nw_all = w.shape
    ke = yk.shape[1]
    nsel = ksel if 0 < ksel < ke else ke
    if chunk is None or chunk >= nw_all:
        return _cm_inner_body(w, s, yk, e_knots, payload, mu_knots, mu_pdf, nbody_emax, c_norm, nbody_expo,
                              order, nq_y, angular, energy, nsel)
    out = w.new_empty((tt, nw_all, order + 1))
    for c0 in range(0, nw_all, chunk):
        out[:, c0 : c0 + chunk] = _cm_inner_body(
            w[:, c0 : c0 + chunk], s, yk, e_knots, payload, mu_knots, mu_pdf, nbody_emax, c_norm, nbody_expo,
            order, nq_y, angular, energy, nsel,
        )
    return out


def cm_inner_edges(w, s, yk, mu_knots, nsel: int):
    """The inner y-panel edges of every outer node w (T, NW): (y_edges
    (T, NW, EY), ok_w (T, NW), j0 (T, NW) or None, yk_sel (T, NW, nsel)).
    [lo, clip(knots), hi] with lo, hi = max(|w - s|, y_0), min(w + s,
    y_{K-1}); the knots are a window of nsel of them from j0 when nsel < KE;
    with mu_knots (tabular angles) the clipped crossing roots join and the
    edges are sorted."""
    tt, nw = w.shape
    ke = yk.shape[1]
    s1 = s[:, None]  # (T, 1)
    ylo_i = torch.maximum((w - s1).abs(), yk[:, :1])  # (T, NW)
    yhi_i = torch.minimum(w + s1, yk[:, -1:])
    ok_w = yhi_i > ylo_i
    if nsel < ke:
        j0 = _panel_index_rows(yk, ylo_i).clamp_(0, ke - nsel)  # (T, NW)
        # the window of nsel consecutive knots from j0
        widx = (j0[:, :, None] + torch.arange(nsel, device=w.device)).clamp_(max=ke - 1)
        yk_sel = torch.gather(yk, 1, widx.reshape(tt, nw * nsel)).reshape(tt, nw, nsel)
    else:
        j0 = None
        yk_sel = yk[:, None, :].expand(tt, nw, ke)
    lo_e = ylo_i[..., None]
    hi_e = yhi_i[..., None]
    kn_clip = torch.minimum(torch.maximum(yk_sel, lo_e), hi_e)
    if mu_knots is None:
        # kalbach/isotropic inner edges are just the clipped knots:
        # sorted rows stay sorted under clip, the window ends bracket
        # them, and out-of-window knots collapse to dead (zero-width)
        # edge panels — the same multiset as a sorted concat, no sort
        return torch.cat([lo_e, kn_clip, hi_e], dim=-1), ok_w, j0, yk_sel
    mkv = mu_knots[None, None, :]  # (1, 1, KMU)
    iparts = [kn_clip, lo_e, hi_e]
    disc = ((s1**2)[..., None] * mkv**2 + (w**2)[..., None] - (s1**2)[..., None]).clamp_min(0.0)
    sq = torch.sqrt(disc)
    for sgn in (1.0, -1.0):
        iparts.append(torch.minimum(torch.maximum(-s1[..., None] * mkv + sgn * sq, lo_e), hi_e))
    return torch.sort(torch.cat(iparts, dim=-1), dim=-1).values, ok_w, j0, yk_sel


def _cm_inner_body(w, s, yk, e_knots, chan_payload, mu_knots, mu_pdf, nbody_emax, c_norm, nbody_expo: float,
                   order: int, nq_y: int, angular: str, energy: str, nsel: int):
    """cm_inner_moments_ref on one chunk of outer nodes, all at once."""
    dtype, dev = w.dtype, w.device
    tt, nw = w.shape
    ke = yk.shape[1]
    use_window = nsel < ke
    s1 = s[:, None]  # (T, 1)
    s4 = s[:, None, None, None]
    xy, wy_ = (device_table(tuple(a), dtype, dev) for a in gl_nodes_weights(nq_y))
    if angular == "tabular":
        kmu = mu_knots.shape[0]
        mu_flat = mu_pdf.reshape(tt, ke * kmu)

    y_edges, ok_w, j0, yk_sel = cm_inner_edges(w, s, yk, mu_knots if angular == "tabular" else None, nsel)
    sy = y_edges.shape[-1] - 1
    ymid = 0.5 * (y_edges[..., 1:] + y_edges[..., :-1])  # (T, NW, SY)
    yhalf = 0.5 * (y_edges[..., 1:] - y_edges[..., :-1])
    y = ymid[..., None] + yhalf[..., None] * xy  # (T, NW, SY, QY)
    wgt_y = (yhalf[..., None] * wy_) * ok_w[..., None, None]

    x = y * y  # E'_cm at nodes
    w4 = w[:, :, None, None]
    mu = ((w4**2 - s4**2 - x) / (2.0 * s4 * y).clamp_min(1e-30)).clamp_(-1.0, 1.0)
    mu_lab = ((w4**2 + s4**2 - x) / (2.0 * s4 * w4).clamp_min(1e-30)).clamp_(-1.0, 1.0)

    # Interpolation channels. For knot-delimited inner edges (kalbach /
    # isotropic / nbody) the y-panel -> knot-panel correspondence is
    # STATIC: y_edges = [lo, clip(knots j0..j0+nsel-1), hi], so live
    # panel p lies in knot panel j0 + p - 1 (panel 0 is always dead:
    # kn_clip[0] collapses onto lo); dead (clip-collapsed) panels may
    # read an arbitrary finite panel payload — their contribution is
    # zeroed by wgt_y. The tabular path counts knots instead (its inner
    # edges interleave mu-crossing roots with the knots, so the
    # correspondence is data-dependent).
    cf = None
    if chan_payload is not None:
        if angular == "tabular":
            if use_window:
                cnt = torch.searchsorted(yk_sel, ymid, right=True)  # knots of the window <= ymid
                jq = j0[:, :, None] + (cnt - 1).clamp_(0, nsel - 2)
            else:
                cnt = torch.searchsorted(yk, ymid.reshape(tt, nw * sy), right=True).reshape(tt, nw, sy)
                jq = (cnt - 1).clamp_(0, nsel - 2)
            jq = jq.clamp_(0, ke - 2)
        elif use_window:
            jq = (j0[:, :, None] + (torch.arange(nsel + 1, device=dev) - 1)).clamp_(0, ke - 2)
        else:
            jq = None
        if jq is None:
            p_idx = device_table(tuple(np.clip(np.arange(ke + 1) - 1, 0, ke - 2).tolist()), torch.int64, dev)  # static
            cf = chan_payload[:, p_idx, :][:, None]  # (T, 1, SY, C) broadcast
        else:
            cf = _gather_rows(chan_payload, jq.reshape(tt, nw * sy)).reshape(tt, nw, sy, -1)

    if energy == "nbody":
        # p_E per unit E'_cm carries sqrt(E'_cm) = y from the phase-space
        # form; the measure is dy with |J| = 1/s (no extra 2y)
        pe = c_norm[:, None, None, None] * y * (nbody_emax[:, None, None, None] - x).clamp_min(0.0) ** nbody_expo
    else:
        pe = cf[..., 0:1] + cf[..., 1:2] * x

    if angular == "kalbach":
        off = 0 if energy == "nbody" else 2
        rr = cf[..., off : off + 1] + cf[..., off + 1 : off + 2] * x
        aa = (cf[..., off + 2 : off + 3] + cf[..., off + 3 : off + 4] * x).clamp_min(1e-12)
        # two-exp form of a/(2 sinh a) (cosh(a mu) + r sinh(a mu)):
        # cosh + r sinh = ((1+r) e^{a mu} + (1-r) e^{-a mu})/2 and
        # 2 sinh a = e^a - e^-a = em (2 + em)/(1 + em) with em = expm1(a).
        # The naive e^a - e^-a cancels catastrophically for small a
        # (~eps/(2 a) relative, ~1e-4 at the 1e-12 clamp that every
        # a=0/near-isotropic law-44 knot hits); expm1 is exact there and
        # a/em -> 1 smoothly. Same operations as the reference, so the
        # two differ by the ulp of exp/expm1 only.
        ex = torch.exp(aa * mu)
        em = torch.expm1(aa)
        num = aa * ((1.0 + rr) * (ex * ex) + (1.0 - rr)) * (1.0 + em)
        pa = num / (ex * (2.0 * em * (2.0 + em)))
    elif angular == "tabular":
        xm = (ymid * ymid).reshape(tt, nw * sy)  # panel-constant interp selectors
        je = _panel_index_rows(e_knots, xm)  # (T, NW*SY)
        mum = (
            (w[:, :, None] ** 2 - s1[..., None] ** 2 - ymid * ymid) / (2.0 * s1[..., None] * ymid).clamp_min(1e-30)
        ).reshape(tt, nw * sy).clamp_(-1.0, 1.0)
        jm = _panel_index_rows(mu_knots, mum)
        f00 = je * kmu + jm
        c00, c01, c10, c11 = (
            torch.gather(mu_flat, 1, f00 + d).reshape(tt, nw, sy, 1) for d in (0, 1, kmu, kmu + 1)
        )
        ek0 = torch.gather(e_knots, 1, je).reshape(tt, nw, sy, 1)
        ek1 = torch.gather(e_knots, 1, je + 1).reshape(tt, nw, sy, 1)
        mk0 = mu_knots[jm].reshape(tt, nw, sy, 1)
        mk1 = mu_knots[jm + 1].reshape(tt, nw, sy, 1)
        t_e = ((x - ek0) / (ek1 - ek0).clamp_min(1e-30)).clamp_(0.0, 1.0)
        t_m = ((mu - mk0) / (mk1 - mk0).clamp_min(1e-30)).clamp_(0.0, 1.0)
        lo_mix = c00 + t_m * (c01 - c00)
        hi_mix = c10 + t_m * (c11 - c10)
        pa = lo_mix + t_e * (hi_mix - lo_mix)
    else:  # isotropic
        pa = 0.5

    wgt = pe * pa * wgt_y  # (T, NW, SY, QY)
    m_list = [torch.sum(wgt, dim=(2, 3))]  # (T, NW)
    if order >= 1:
        p_prev = torch.ones_like(mu_lab)
        p_cur = mu_lab
        m_list.append(torch.sum(wgt * p_cur, dim=(2, 3)))
        for l in range(1, order):
            p_next = ((2 * l + 1) * mu_lab * p_cur - l * p_prev) / (l + 1)
            p_prev, p_cur = p_cur, p_next
            m_list.append(torch.sum(wgt * p_cur, dim=(2, 3)))
    return torch.stack(m_list, dim=-1)  # (T, NW, L+1)


def _check_cm(w, s, yk, e_knots, payload, mu_knots, mu_pdf, nbody_emax, c_norm,
              order: int, nq_y: int, angular: str, energy: str, ksel: int) -> None:
    name = "cm_inner_moments"
    if not 0 <= order <= MAX_ORDER:
        raise ValueError(f"{name}: order must be in [0, {MAX_ORDER}], got {order}")
    if not 0 < nq_y <= MAX_NQ_Y:
        raise ValueError(f"{name}: nq_y must be in [1, {MAX_NQ_Y}], got {nq_y}")
    if angular not in ANGULAR or energy not in ENERGY:
        raise ValueError(f"{name}: angular must be one of {ANGULAR} and energy one of {ENERGY}, "
                         f"got {angular!r}, {energy!r}")
    if ksel < 0:
        raise ValueError(f"{name}: ksel must be >= 0, got {ksel}")
    if w.dim() != 2 or yk.dim() != 2 or yk.shape[0] != w.shape[0] or yk.shape[1] < 2:
        raise ValueError(f"{name}: w must be (T, NW) and yk (T, KE >= 2), got {tuple(w.shape)}, {tuple(yk.shape)}")
    tt, ke = yk.shape
    ncol = payload_columns(angular, energy)
    tab = angular == "tabular"
    kmu = mu_knots.shape[0] if tab and mu_knots is not None and mu_knots.dim() == 1 else 0
    if tab and kmu < 2:
        raise ValueError(f"{name}: tabular angles need mu_knots (KMU,) with KMU >= 2")
    shapes = {
        "s": (s, (tt,)), "e_knots": (e_knots, (tt, ke)),
        "payload": (payload, (tt, ke - 1, ncol) if ncol else None),
        "mu_knots": (mu_knots, (kmu,) if tab else None), "mu_pdf": (mu_pdf, (tt, ke, kmu) if tab else None),
        "nbody_emax": (nbody_emax, (tt,) if energy == "nbody" else None),
        "c_norm": (c_norm, (tt,) if energy == "nbody" else None),
    }
    for key, (x, shape) in shapes.items():
        if shape is None:
            if x is not None:
                raise ValueError(f"{name}: {key} must be None for angular={angular!r}, energy={energy!r}")
            continue
        if x is None or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape}, got {None if x is None else tuple(x.shape)}")
    for key, x in (("w", w), ("yk", yk), *((k, x) for k, (x, sh) in shapes.items() if sh is not None)):
        if x.dtype != torch.float64:
            raise TypeError(f"{name}: {key} must be float64, got {x.dtype}")
        if x.device != w.device:
            raise ValueError(f"{name}: {key} on {x.device}, w on {w.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def cm_lanes(rows: int, nw: int, sms: int = H100_SMS) -> int:
    """The lanes per outer node the kernel takes for a (rows, nw) tile."""
    return lane_group(rows * nw, sms)


def cm_tile_lanes(rows: int, nw: int, device: torch.device) -> int | None:
    """The lanes per outer node of a dispatch tile of `rows` rows on
    `device` (None off the card): what the continuum driver passes for every
    piece of a tile split over shards, so that each sums as the whole tile
    would."""
    return cm_lanes(rows, nw, device_sms(device)) if device.type == "cuda" else None


def cm_order_bucket(order: int) -> int:
    """The sums the kernel keeps for an order, less one (csrc/cm_pointwise.cu
    bucket()): 3, 5 or MAX_ORDER."""
    return 3 if order <= 3 else 5 if order <= 5 else MAX_ORDER


def cm_inner_moments(
    w, s, yk, e_knots, payload, mu_knots, mu_pdf, nbody_emax, c_norm, nbody_expo: float,
    order: int, nq_y: int, angular: str, energy: str, ksel: int, chunk: int | None = None,
    lanes: int | None = None,
):
    """The inner integral of cm_moments_pointwise at every outer node: (T, NW, L+1).

    Operands as cm_inner_moments_ref; an operand the variant does not read
    is None. CUDA tensors launch the kernel on the current stream without
    synchronising, every outer node in one launch (chunk is not read), with
    `lanes` lanes per outer node (1, 2, 4 or 8; None: cm_lanes of this call's
    tile). The lanes fix the order of each sum, so a caller that splits a
    tile (the driver, over shards) passes the whole tile's. CPU tensors take
    cm_inner_moments_ref, `chunk` outer nodes at a time.
    """
    _check_cm(w, s, yk, e_knots, payload, mu_knots, mu_pdf, nbody_emax, c_norm, order, nq_y, angular, energy, ksel)
    check_lanes("cm_inner_moments", lanes)
    if w.device.type == "cpu":
        return cm_inner_moments_ref(w, s, yk, e_knots, payload, mu_knots, mu_pdf, nbody_emax, c_norm, nbody_expo,
                                    order, nq_y, angular, energy, ksel, chunk)
    if w.device.type != "cuda":
        raise ValueError(f"cm_inner_moments: unsupported device {w.device}")
    tt, nw = w.shape
    ke = yk.shape[1]
    out = torch.empty((tt, nw, order + 1), dtype=torch.float64, device=w.device)
    if tt == 0 or nw == 0:
        return out
    kmu = 0 if mu_knots is None else mu_knots.shape[0]
    g = lanes or cm_lanes(tt, nw, device_sms(w.device))
    lib = _cm_library()
    xy, wy = gl_nodes_weights(nq_y)
    nsel = ksel if 0 < ksel < ke else ke

    def ptr(x):
        return 0 if x is None else x.data_ptr()

    staged = ctypes.c_int(0)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.cm_inner_launch(
            *(ptr(x) for x in (w, s, yk, e_knots, payload, mu_knots, mu_pdf, nbody_emax, c_norm)),
            float(nbody_expo), tt, nw, ke, kmu, nsel, ANGULAR.index(angular), ENERGY.index(energy), order, nq_y, g,
            xy.ctypes.data, wy.ctypes.data, out.data_ptr(), ctypes.byref(staged), stream,
        )
    if rc != 0:
        raise RuntimeError(f"cm_inner_moments: kernel launch failed with cudaError {rc}")
    cm_inner_moments.launches += 1
    cm_inner_moments.launches_by_stream[stream] += 1
    cm_inner_moments.row_tables["shared" if staged.value else "l2"] += 1
    cm_inner_moments.lane_groups[g] += 1
    return out


# Launches of the CUDA kernel since the last reset, in all, by the CUDA
# stream that took them, by where the rows' tables were read from
# ("shared": staged in shared memory; "l2": read through the caches), as
# the launch reports it, and by the lanes per outer node. CPU calls never
# count.
cm_inner_moments.launches = 0
cm_inner_moments.launches_by_stream = Counter()
cm_inner_moments.row_tables = Counter()
cm_inner_moments.lane_groups = Counter()


@lru_cache(maxsize=1)
def _cm_library() -> ctypes.CDLL:
    """The loaded kernel library (every variant, L bucket and lane group), built on first use."""
    path, _ = build_cuda(_SRC)
    lib = ctypes.CDLL(str(path))
    fn = lib.cm_inner_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_double] + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib
