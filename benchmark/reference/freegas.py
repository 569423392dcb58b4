"""Free-gas (target-in-motion) transfer moments of one incident energy.

Model (the configuration's): Maxwellian target of mass ratio A at kT,
constant free-atom cross section, scattering isotropic in the centre of
mass, rate weighted by the relative speed. In the relative speed v_r and
the centre-of-mass speed c (the JAX package oracle's coordinates,
`_moments_vrvcm`), with u = A v_r / (A + 1) the neutron's speed in the
centre of mass, the outgoing lab speed y runs over [|c - u|, c + u] with
density y / (2 c u), and the Legendre moment of the lab deflection factors
into P_l(cos a) P_l(cos b) (the addition theorem): a the angle between the
incident direction and the centre-of-mass velocity, b between that and the
outgoing velocity.

Every kink of the integrand (where a group boundary meets an end of the
y range) is a panel edge in v_r and in c, so fixed Gauss-Legendre rules
converge fast; the y integral over each group's overlap is a Gauss-Legendre
rule too. Plain PyTorch (float64, or the precision it is given), on the
device it is given; no closed form and no interpolation of the density.
"""

from __future__ import annotations

import numpy as np
import torch

from .data import gauss_legendre

NQ_R, NQ_C, NQ_Y = 12, 12, 32
_VR_LADDER = np.array([-8, -6, -4, -3, -2, -1.5, -1, -0.5, 0, 0.5, 1, 1.5, 2, 3, 4, 6, 8], dtype=float)
_C_LADDER = np.array([-8, -4, -2, -1, -0.5, 0.5, 1, 2, 4, 8], dtype=float)


def _legendre_t(x: torch.Tensor, order: int) -> torch.Tensor:
    ps = [torch.ones_like(x)]
    if order >= 1:
        ps.append(x)
    for l in range(1, order):
        ps.append(((2 * l + 1) * x * ps[l] - l * ps[l - 1]) / (l + 1))
    return torch.stack(ps, dim=-1)


def _c_edges(v: float, vr: float, a: float, beta: float, gamma: float, finite: np.ndarray) -> np.ndarray:
    """Panel edges in c for one relative speed: the ends, the weight's peak
    and its ladders, every kink (a group boundary meeting c - u, u - c or
    c + u) and a uniform fill."""
    u = gamma * vr
    clo, chi = abs(v - u), v + u
    vstar = np.sqrt(max(v * v / (a + 1.0) - a * vr * vr / (a + 1.0) ** 2, 0.0))
    anchor = min(max(vstar, clo), chi)
    wq = 1.0 / (beta * np.sqrt((a + 1.0) / a))
    wl = 1.0 / (beta**2 * 2.0 * max(anchor, 1e-30) * (a + 1.0) / a)
    cands = [np.array([clo, chi, min(max(u, clo), chi)]), anchor + wq * _C_LADDER, anchor + wl * _C_LADDER,
             finite + u, u - finite, finite - u, np.linspace(clo, chi, 17)]
    return np.unique(np.clip(np.concatenate(cands), clo, chi))


def moments(e: float, awr: float, kt: float, bounds: np.ndarray, order: int, clamp: bool = True,
            device="cpu", dtype=torch.float64, nq=(NQ_R, NQ_C, NQ_Y), batch: int = 16) -> np.ndarray:
    """(L+1, G) free-gas moments per unit scatter at incident energy e (eV).
    `batch` relative speeds at a time."""
    nq_r, nq_c, nq_y = nq
    v = float(np.sqrt(e))
    a = float(awr)
    beta = float(np.sqrt(a / kt))
    gamma = a / (a + 1.0)
    sb = np.sqrt(np.maximum(bounds, 0.0))
    if clamp:
        sb[0], sb[-1] = 0.0, np.inf
    finite = sb[np.isfinite(sb)]
    ng = sb.size - 1
    xr, wr = gauss_legendre(nq_r)
    xc, wc = gauss_legendre(nq_c)
    xy, wy = gauss_legendre(nq_y)
    xy_t = torch.as_tensor(xy, dtype=dtype, device=device)
    wy_t = torch.as_tensor(wy, dtype=dtype, device=device)

    lo_r, hi_r = max(0.0, v - 9.0 / beta), v + 9.0 / beta
    cand = [v + _VR_LADDER / beta, (v + finite) / (2 * gamma), (v - finite) / (2 * gamma),
            (finite - v) / (2 * gamma), np.linspace(lo_r, hi_r, 33)]
    edges_r = np.unique(np.clip(np.concatenate(cand), lo_r, hi_r))
    h = 0.5 * np.diff(edges_r)
    keep = h > 0
    m = (0.5 * (edges_r[1:] + edges_r[:-1]))[keep]
    h = h[keep]
    vrs = (m[:, None] + h[:, None] * xr[None, :]).ravel()
    w_rs = (h[:, None] * wr[None, :]).ravel()
    out = torch.zeros((ng, order + 1), dtype=dtype, device=device)
    den = torch.zeros((), dtype=dtype, device=device)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    sb_t = t(sb)
    for b0 in range(0, vrs.size, batch):
        vr = vrs[b0 : b0 + batch]
        edges = [_c_edges(v, x, a, beta, gamma, finite) for x in vr]
        n = max(x.size for x in edges)
        edges = np.stack([np.concatenate([x, np.full(n - x.size, x[-1])]) for x in edges])  # (B, n)
        mids = 0.5 * (edges[:, 1:] + edges[:, :-1])
        halfs = 0.5 * (edges[:, 1:] - edges[:, :-1])  # zero on padding: no weight
        cc = (mids[:, :, None] + halfs[:, :, None] * xc).reshape(vr.size, -1)  # (B, C)
        w_c = (halfs[:, :, None] * wc).reshape(vr.size, -1)
        u = gamma * vr[:, None]
        vsq = -v * v / a + vr[:, None] ** 2 / (a + 1.0) + cc * cc * (a + 1.0) / a
        wgt = vr[:, None] ** 2 * cc * np.exp(-(beta**2) * vsq) * w_c * w_rs[b0 : b0 + batch, None]
        ca = np.clip((v * v + cc * cc - u * u) / (2.0 * v * np.maximum(cc, 1e-300)), -1.0, 1.0)
        c_t, w_t = t(cc), t(wgt)
        u_t = t(np.broadcast_to(u, cc.shape).copy())
        den = den + w_t.sum()
        pla = _legendre_t(t(ca), order)  # (B, C, L+1)
        lo = torch.maximum((c_t - u_t).abs()[..., None], sb_t[:-1])  # (B, C, G)
        hi = torch.minimum((c_t + u_t)[..., None], sb_t[1:])
        bi, ci, gi = torch.nonzero((hi > lo) & (w_t != 0)[..., None], as_tuple=True)
        if bi.numel() == 0:
            continue
        lo, hi, c, uu = lo[bi, ci, gi], hi[bi, ci, gi], c_t[bi, ci], u_t[bi, ci]
        y = 0.5 * (lo + hi)[:, None] + 0.5 * (hi - lo)[:, None] * xy_t  # (M, NY)
        cb = torch.clamp((y * y + (c * c - uu * uu)[:, None]) / (2.0 * y * c[:, None]), -1.0, 1.0)
        dens = y / (2.0 * c[:, None] * uu[:, None])
        inner = torch.einsum("my,myl,y->ml", dens, _legendre_t(cb, order), wy_t) * (0.5 * (hi - lo))[:, None]
        out.index_add_(0, gi, w_t[bi, ci, None] * pla[bi, ci] * inner)
    return (out / den).T.cpu().numpy()
