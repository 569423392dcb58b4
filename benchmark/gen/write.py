"""ACE table encoder/writer (ASCII Type-1).

Emits genuine continuous-energy ACE tables following the published block
layout (NXS/JXS/XSS; SURVEY.md section 8.1). Primary consumer: the synthetic
test fixtures (SURVEY.md section 4.1 — fixtures are generated by code, not
binary blobs), which simultaneously exercise this writer and the parser
(round-trip) and feed the moment kernels.

Layout written (1-based locators, standard ACE conventions):
  JXS(1)  ESZ    E, sig_t, sig_a, sig_el, heating           (5*NES)
  JXS(2)  NU     KNU<0 => prompt then total arrays; KNU>0 => single array
  JXS(3)  MTR    MT numbers (NTR)
  JXS(4)  LQR    Q values (NTR, MeV)
  JXS(5)  TYR    frames/multiplicities (NTR)
  JXS(6)  LSIG   cross-section locators (NTR, rel JXS(7))
  JXS(7)  SIG    per reaction: IE, NE, sigma[NE]
  JXS(8)  LAND   angular locators (NR+1, first = elastic; 0 iso, -1 in DLW)
  JXS(9)  AND    per reaction: NE, E[NE], LC[NE], tables
  JXS(10) LDLW   energy-dist locators (NR, rel JXS(11))
  JXS(11) DLW    law chains: LNW, LAW, IDAT, applicability, law data
  JXS(24) DNU    delayed nu-bar array
  JXS(25) BDD    per precursor: DEC(1/shake), applicability table
  JXS(26) DNEDL  delayed-spectrum locators (NPCR, rel JXS(27))
  JXS(27) DNED   delayed-spectrum law chains (law 4)

Energies in the in-memory model are eV; ACE stores MeV — converted here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .records import (
    MEV_TO_EV,
    AngularDistribution,
    ContinuousTable,
    EnergyDistribution,
    NuBar,
    Nuclide,
    Tab1,
)
from .errors import AceFormatError

_EV = 1.0 / MEV_TO_EV  # multiply eV -> MeV
SHAKE = 1.0e-8  # seconds


class _Xss:
    """Append-only XSS array builder with 1-based positions."""

    def __init__(self) -> None:
        self.data: list[float] = []

    @property
    def pos(self) -> int:
        """1-based index of the next value to be appended."""
        return len(self.data) + 1

    def append(self, *vals) -> int:
        start = self.pos
        for v in vals:
            if isinstance(v, (list, tuple, np.ndarray)):
                self.data.extend(float(x) for x in np.asarray(v).ravel())
            else:
                self.data.append(float(v))
        return start

    def set(self, pos_1based: int, value: float) -> None:
        self.data[pos_1based - 1] = float(value)

    def array(self) -> np.ndarray:
        return np.asarray(self.data, dtype=np.float64)


def _append_interp_header(xss: _Xss, tab: Tab1) -> None:
    """NR, [NBT, INT]*NR preamble used by nu/applicability/law tables."""
    if tab.nbt is None:
        xss.append(0)
    else:
        nbt = np.asarray(tab.nbt, dtype=np.int64)
        law = np.asarray(tab.law, dtype=np.int64).ravel()
        xss.append(nbt.size)
        xss.append(nbt)
        xss.append(law)


def _append_tab1(xss: _Xss, tab: Tab1, xscale: float = 1.0) -> None:
    _append_interp_header(xss, tab)
    xss.append(tab.x.size)
    xss.append(tab.x * xscale)
    xss.append(tab.y)


def _append_nu(xss: _Xss, nu: NuBar) -> None:
    if nu.form == "polynomial":
        assert nu.coeffs is not None
        # stored polynomial is in E(MeV): convert our eV-coefficients back
        coeffs_mev = nu.coeffs * (MEV_TO_EV ** np.arange(nu.coeffs.size))
        xss.append(1)  # LNU
        xss.append(coeffs_mev.size)
        xss.append(coeffs_mev)
    else:
        assert nu.tab is not None
        xss.append(2)  # LNU
        _append_tab1(xss, nu.tab, xscale=_EV)


def _nu_block_len(nu: NuBar) -> int:
    if nu.form == "polynomial":
        return 2 + int(nu.coeffs.size)
    tab = nu.tab
    nr = 0 if tab.nbt is None else int(np.asarray(tab.nbt).size)
    return 1 + 1 + 2 * nr + 1 + 2 * tab.x.size


def _append_angular(xss: _Xss, and_start: int, dist: AngularDistribution) -> int:
    """Append one reaction's AND data; returns its 1-based locator rel to JXS(9)."""
    loc = xss.pos - and_start + 1
    ne = dist.energies.size
    xss.append(ne)
    xss.append(dist.energies * _EV)
    lc_pos = xss.pos
    xss.append(np.zeros(ne))  # LC placeholders
    for i, (table, enc) in enumerate(zip(dist.tables, dist.encodings)):
        if enc == "isotropic":
            xss.set(lc_pos + i, 0)
            continue
        tloc = xss.pos - and_start + 1
        if enc == "equiprobable":
            xss.set(lc_pos + i, +tloc)
            xss.append(table.mu)  # 33 bin boundaries
        else:  # tabular
            xss.set(lc_pos + i, -tloc)
            xss.append(table.interp)
            xss.append(table.mu.size)
            xss.append(table.mu)
            xss.append(table.pdf)
            xss.append(table.cdf)
    return loc


def _append_law_data(xss: _Xss, dlw_start: int, ed: EnergyDistribution) -> int:
    """Append the law payload; returns IDAT (1-based, rel to JXS(11))."""
    d = ed.data
    idat = xss.pos - dlw_start + 1
    if ed.law == 3:
        xss.append(d.c1 * _EV, d.c2)
    elif ed.law in (4, 44, 61):
        assert d.energies is not None and d.tables is not None
        tab_hdr = Tab1(d.energies, np.zeros_like(d.energies), d.nbt, d.int_law)
        _append_interp_header(xss, tab_hdr)
        ne = d.energies.size
        xss.append(ne)
        xss.append(d.energies * _EV)
        lpos = xss.pos
        xss.append(np.zeros(ne))  # L locators placeholder
        for i, t in enumerate(d.tables):
            xss.set(lpos + i, xss.pos - dlw_start + 1)
            xss.append(t.intt + 10 * t.nd)
            npnt = t.e_out.size
            xss.append(npnt)
            xss.append(t.e_out * _EV)
            pdf_mev = t.pdf / _EV  # density per MeV...
            if t.nd:
                pdf_mev = pdf_mev.copy()
                pdf_mev[: t.nd] = t.pdf[: t.nd]  # ...but line probabilities verbatim
            xss.append(pdf_mev)
            xss.append(t.cdf)
            if ed.law == 44:
                xss.append(t.r if t.r is not None else np.zeros(npnt))
                xss.append(t.a if t.a is not None else np.zeros(npnt))
            elif ed.law == 61:
                lcpos = xss.pos
                xss.append(np.zeros(npnt))
                ang = t.angular or [None] * npnt
                for j, at in enumerate(ang):
                    if at is None:
                        xss.set(lcpos + j, 0)
                    else:
                        xss.set(lcpos + j, xss.pos - dlw_start + 1)
                        xss.append(at.interp)
                        xss.append(at.mu.size)
                        xss.append(at.mu)
                        xss.append(at.pdf)
                        xss.append(at.cdf)
    elif ed.law in (7, 9):
        assert d.theta is not None
        _append_tab1(xss, Tab1(d.theta.x, d.theta.y * _EV, d.theta.nbt, d.theta.law), xscale=_EV)
        xss.append((d.restriction_u or 0.0) * _EV)
    elif ed.law == 11:
        assert d.a_tab is not None and d.b_tab is not None
        # a(E) has units of energy (MeV); b(E) has units 1/energy (1/MeV)
        _append_tab1(xss, Tab1(d.a_tab.x, d.a_tab.y * _EV, d.a_tab.nbt, d.a_tab.law), xscale=_EV)
        _append_tab1(xss, Tab1(d.b_tab.x, d.b_tab.y / _EV, d.b_tab.nbt, d.b_tab.law), xscale=_EV)
        xss.append((d.restriction_u or 0.0) * _EV)
    elif ed.law == 5:
        assert d.theta is not None and d.x_grid is not None
        _append_tab1(xss, Tab1(d.theta.x, d.theta.y * _EV, d.theta.nbt, d.theta.law), xscale=_EV)
        xss.append(d.x_grid.size)
        xss.append(d.x_grid)
    elif ed.law == 1:
        assert d.energies is not None and d.e_out_bins is not None
        tab_hdr = Tab1(d.energies, np.zeros_like(d.energies), d.nbt, d.int_law)
        _append_interp_header(xss, tab_hdr)
        xss.append(d.energies.size)
        xss.append(d.energies * _EV)
        xss.append(d.net)
        xss.append(d.e_out_bins * _EV)
    elif ed.law == 66:
        xss.append(d.npsx, d.ap)
    elif ed.law == 67:
        assert d.energies is not None and d.ae_tables is not None
        tab_hdr = Tab1(d.energies, np.zeros_like(d.energies), d.nbt, d.int_law)
        _append_interp_header(xss, tab_hdr)
        ne = d.energies.size
        xss.append(ne)
        xss.append(d.energies * _EV)
        lpos = xss.pos
        xss.append(np.zeros(ne))  # L locators placeholder
        for i, t in enumerate(d.ae_tables):
            xss.set(lpos + i, xss.pos - dlw_start + 1)
            xss.append(t.intmu)
            xss.append(t.mu.size)
            xss.append(t.mu)
            lmupos = xss.pos
            xss.append(np.zeros(t.mu.size))  # LMU placeholders
            for j, sl in enumerate(t.slices):
                xss.set(lmupos + j, xss.pos - dlw_start + 1)
                xss.append(sl.intep)
                xss.append(sl.e_out.size)
                xss.append(sl.e_out * _EV)
                xss.append(sl.pdf / _EV)
                xss.append(sl.cdf)
    else:
        raise AceFormatError(f"encoder: unsupported law {ed.law}")
    return idat


def _append_law_chain(xss: _Xss, dlw_start: int, dists: list[EnergyDistribution]) -> int:
    """Append a full DLW law chain; returns its locator rel to JXS(11)."""
    loc = xss.pos - dlw_start + 1
    lnw_positions = []
    for k, ed in enumerate(dists):
        lnw_positions.append(xss.pos)
        xss.append(0)  # LNW placeholder
        xss.append(ed.law)
        idat_pos = xss.pos
        xss.append(0)  # IDAT placeholder
        _append_tab1(xss, ed.applicability, xscale=_EV)
        idat = _append_law_data(xss, dlw_start, ed)
        xss.set(idat_pos, idat)
        if k + 1 < len(dists):
            xss.set(lnw_positions[k], xss.pos - dlw_start + 1)
    return loc


def encode(nuc: Nuclide) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode a Nuclide into (nxs, jxs, xss)."""
    nxs = np.zeros(16, dtype=np.int64)
    jxs = np.zeros(32, dtype=np.int64)
    xss = _Xss()

    nes = nuc.energy.size
    mts = sorted(nuc.reactions)
    ntr = len(mts)
    with_sec = [mt for mt in mts if nuc.reactions[mt].has_secondary_neutrons]
    nr = len(with_sec)

    nxs[1] = nuc.zaid
    nxs[2] = nes
    nxs[3] = ntr
    nxs[4] = nr
    nxs[7] = len(nuc.precursors)

    # ESZ
    jxs[0] = xss.pos
    xss.append(nuc.energy * _EV)
    xss.append(nuc.sigma_t)
    xss.append(nuc.sigma_a)
    xss.append(nuc.sigma_el)
    xss.append(nuc.heating if nuc.heating.size == nes else np.zeros(nes))

    # NU
    if nuc.nu_prompt is not None or nuc.nu_total is not None:
        jxs[1] = xss.pos
        if nuc.nu_prompt is not None and nuc.nu_total is not None:
            xss.append(-_nu_block_len(nuc.nu_prompt))
            _append_nu(xss, nuc.nu_prompt)
            _append_nu(xss, nuc.nu_total)
        else:
            # single array: KNU>0 is the LNU flag itself at JXS(2)
            _append_nu(xss, nuc.nu_prompt or nuc.nu_total)

    if ntr:
        # MTR / LQR / TYR
        jxs[2] = xss.append([float(mt) for mt in mts])
        jxs[3] = xss.append([nuc.reactions[mt].q * _EV for mt in mts])
        tyr_vals = []
        for mt in mts:
            r = nuc.reactions[mt]
            if r.yield_tab is not None:
                ty = 100 + 1  # placeholder magnitude; fixed up after DLW is built
            elif r.multiplicity == 19 or r.is_fission and r.has_secondary_neutrons:
                ty = 19
            else:
                ty = r.multiplicity
            tyr_vals.append(-ty if r.frame == "cm" and ty != 0 else ty)
        jxs[4] = tyr_pos = xss.append(tyr_vals)

        # LSIG / SIG
        jxs[5] = lsig_pos = xss.append(np.zeros(ntr))
        jxs[6] = sig_start = xss.pos
        for i, mt in enumerate(mts):
            r = nuc.reactions[mt]
            xss.set(lsig_pos + i, xss.pos - sig_start + 1)
            xss.append(r.threshold_idx + 1)  # IE, 1-based
            xss.append(r.sigma.size)
            xss.append(r.sigma)
    else:
        tyr_pos = lsig_pos = 0
        jxs[6] = xss.pos

    # LAND / AND (elastic + reactions with secondary neutrons)
    jxs[7] = land_pos = xss.append(np.zeros(nr + 1))
    jxs[8] = and_start = xss.pos
    ang_owners = [("elastic", nuc.elastic_angular)] + [(mt, nuc.reactions[mt].angular) for mt in with_sec]
    for i, (owner, dist) in enumerate(ang_owners):
        if owner != "elastic":
            r = nuc.reactions[owner]
            if r.angular_in_dlw:
                xss.set(land_pos + i, -1)
                continue
        if dist is None:
            xss.set(land_pos + i, 0)
            continue
        xss.set(land_pos + i, _append_angular(xss, and_start, dist))

    # LDLW / DLW
    if nr:
        jxs[9] = ldlw_pos = xss.append(np.zeros(nr))
        jxs[10] = dlw_start = xss.pos
        for i, mt in enumerate(with_sec):
            r = nuc.reactions[mt]
            if not r.energy_dists:
                raise AceFormatError(f"MT={mt} has secondary neutrons but no energy distribution")
            xss.set(ldlw_pos + i, _append_law_chain(xss, dlw_start, r.energy_dists))
        # energy-dependent yield tables (|TYR| > 100): append into DLW and fix TYR
        for i, mt in enumerate(mts):
            r = nuc.reactions[mt]
            if r.yield_tab is not None:
                offset = xss.pos - dlw_start + 1
                _append_tab1(xss, r.yield_tab, xscale=_EV)
                ty = 100 + offset
                xss.set(tyr_pos + i, -ty if r.frame == "cm" else ty)
    else:
        jxs[10] = xss.pos

    # Delayed-neutron data
    if nuc.precursors:
        if nuc.nu_delayed is not None:
            jxs[23] = xss.pos
            _append_nu(xss, nuc.nu_delayed)
        jxs[24] = xss.pos
        for prec in nuc.precursors:
            xss.append(prec.decay_const * SHAKE)  # 1/s -> 1/shake
            _append_tab1(xss, prec.probability, xscale=_EV)
        jxs[25] = dnedl_pos = xss.append(np.zeros(len(nuc.precursors)))
        jxs[26] = dned_start = xss.pos
        for i, spec in enumerate(nuc.delayed_spectra):
            xss.set(dnedl_pos + i, _append_law_chain(xss, dned_start, [spec]))

    jxs[21] = len(xss.data)  # END pointer: last word
    nxs[0] = len(xss.data)
    return nxs, jxs, xss.array()


# --------------------------------------------------------------------------
# ASCII serialization (Type-1, legacy header)


def format_ascii(nuc: Nuclide, date: str = "08/16/26", comment: str | None = None) -> str:
    nxs, jxs, xss = encode(nuc)
    lines = []
    lines.append(f"{nuc.name:<10s}{nuc.awr:12.6f}{nuc.kT * _EV:12.4E} {date:<10s}")
    lines.append(f"{(comment or 'ndpp-tpu synthetic fixture'):<70s}{'mat 0':<10s}")
    # 16 IZ/AW pairs, 4 per line
    for row in range(4):
        lines.append("".join(f"{0:7d}{0.0:11.0f}" for _ in range(4)))
    for row in range(2):
        lines.append("".join(f"{int(v):9d}" for v in nxs[row * 8 : row * 8 + 8]))
    for row in range(4):
        lines.append("".join(f"{int(v):9d}" for v in jxs[row * 8 : row * 8 + 8]))
    for i in range(0, xss.size, 4):
        chunk = xss[i : i + 4]
        lines.append("".join(f"{v:20.12E}" for v in chunk))
    return "\n".join(lines) + "\n"


def write_ace(nuc: Nuclide, path: str | Path, **kw) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(format_ascii(nuc, **kw))
    return p
