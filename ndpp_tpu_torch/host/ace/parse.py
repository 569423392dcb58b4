"""ACE table parser (ASCII Type-1 -> Nuclide).

Decodes the published continuous-energy ACE block layout (SURVEY.md section
8.1; the counterpart of the reference's ``ace.F90`` reader, SURVEY.md
section 2 'ACE reader') into the typed model in ``records.py``. Token
streaming is numpy-vectorized (whole-file split -> float64 array). The
reference package's C++ tokenizer (ndpp_tpu/native) is not ported yet
(ROADMAP A3).

Supports legacy and 2.0.x headers. All energies are converted to eV.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ndpp_tpu_torch import native
from ndpp_tpu_torch.host.ace.records import (
    MEV_TO_EV,
    AngleEnergySlice,
    AngleEnergyTable,
    AngularDistribution,
    AngularTable,
    ContinuousTable,
    EnergyDistribution,
    LawData,
    NuBar,
    Nuclide,
    Precursor,
    Reaction,
    Tab1,
)
from ndpp_tpu_torch.host.ace.write import SHAKE
from ndpp_tpu_torch.utils.errors import AceFormatError


@dataclass
class AceHeader:
    name: str
    awr: float
    kT_ev: float
    date: str


class _Cursor:
    """1-based reader over the XSS array."""

    def __init__(self, xss: np.ndarray):
        self.xss = xss

    def f(self, pos: int) -> float:
        return float(self.xss[pos - 1])

    def i(self, pos: int) -> int:
        return int(round(self.xss[pos - 1]))

    def fa(self, pos: int, n: int) -> np.ndarray:
        return np.asarray(self.xss[pos - 1 : pos - 1 + n], dtype=np.float64)

    def ia(self, pos: int, n: int) -> np.ndarray:
        return np.asarray(np.round(self.xss[pos - 1 : pos - 1 + n]), dtype=np.int64)


def _read_interp_header(c: _Cursor, pos: int):
    """Returns (nbt, law, next_pos)."""
    nr = c.i(pos)
    if nr == 0:
        return None, 2, pos + 1
    nbt = c.ia(pos + 1, nr)
    law = c.ia(pos + 1 + nr, nr)
    if nr == 1:
        return None, int(law[0]), pos + 1 + 2 * nr
    return nbt, law, pos + 1 + 2 * nr


def _read_tab1(c: _Cursor, pos: int, xscale: float = 1.0, yscale: float = 1.0):
    """Returns (Tab1, next_pos)."""
    nbt, law, pos = _read_interp_header(c, pos)
    ne = c.i(pos)
    x = c.fa(pos + 1, ne) * xscale
    y = c.fa(pos + 1 + ne, ne) * yscale
    return Tab1(x, y, nbt, law), pos + 1 + 2 * ne


def _read_nu(c: _Cursor, pos: int) -> NuBar:
    lnu = c.i(pos)
    if lnu == 1:
        nc = c.i(pos + 1)
        coeffs_mev = c.fa(pos + 2, nc)
        coeffs_ev = coeffs_mev / (MEV_TO_EV ** np.arange(nc))
        return NuBar(form="polynomial", coeffs=coeffs_ev)
    if lnu == 2:
        tab, _ = _read_tab1(c, pos + 1, xscale=MEV_TO_EV)
        return NuBar(form="tabular", tab=tab)
    raise AceFormatError(f"NU block: bad LNU={lnu}")


def _read_angular_table(c: _Cursor, and_start: int, lc: int) -> tuple[AngularTable, str]:
    if lc == 0:
        return AngularTable.isotropic(), "isotropic"
    pos = and_start + abs(lc) - 1
    if lc > 0:  # 32 equiprobable cosine bins: 33 boundaries
        bounds = c.fa(pos, 33)
        return AngularTable.from_equiprobable(bounds), "equiprobable"
    jj = c.i(pos)
    npts = c.i(pos + 1)
    mu = c.fa(pos + 2, npts)
    pdf = c.fa(pos + 2 + npts, npts)
    cdf = c.fa(pos + 2 + 2 * npts, npts)
    return AngularTable(interp=jj, mu=mu, pdf=pdf, cdf=cdf), "tabular"


def _read_angular_dist(c: _Cursor, and_start: int, locator: int) -> AngularDistribution:
    pos = and_start + locator - 1
    ne = c.i(pos)
    energies = c.fa(pos + 1, ne) * MEV_TO_EV
    lcs = c.ia(pos + 1 + ne, ne)
    tables, encodings = [], []
    for lc in lcs:
        t, enc = _read_angular_table(c, and_start, int(lc))
        tables.append(t)
        encodings.append(enc)
    return AngularDistribution(energies=energies, tables=tables, encodings=encodings)


def _read_law_data(c: _Cursor, dlw_start: int, law: int, idat: int) -> LawData:
    pos = dlw_start + idat - 1
    if law == 3:
        return LawData(law=3, c1=c.f(pos) * MEV_TO_EV, c2=c.f(pos + 1))
    if law in (4, 44, 61):
        nbt, int_law, pos = _read_interp_header(c, pos)
        ne = c.i(pos)
        energies = c.fa(pos + 1, ne) * MEV_TO_EV
        locs = c.ia(pos + 1 + ne, ne)
        tables = []
        for loc in locs:
            tpos = dlw_start + int(loc) - 1
            intt_p = c.i(tpos)
            intt, nd = intt_p % 10, intt_p // 10
            npts = c.i(tpos + 1)
            e_out = c.fa(tpos + 2, npts) * MEV_TO_EV
            pdf = c.fa(tpos + 2 + npts, npts) / MEV_TO_EV
            if nd:  # discrete-line head: dimensionless probabilities, not densities
                pdf[:nd] *= MEV_TO_EV
            cdf = c.fa(tpos + 2 + 2 * npts, npts)
            tab = ContinuousTable(intt=intt, nd=nd, e_out=e_out, pdf=pdf, cdf=cdf)
            extra = tpos + 2 + 3 * npts
            if law == 44:
                tab.r = c.fa(extra, npts)
                tab.a = c.fa(extra + npts, npts)
            elif law == 61:
                lcs = c.ia(extra, npts)
                ang: list[AngularTable | None] = []
                for lc in lcs:
                    if lc == 0:
                        ang.append(None)
                    else:
                        apos = dlw_start + int(lc) - 1
                        jj = c.i(apos)
                        nmu = c.i(apos + 1)
                        ang.append(
                            AngularTable(
                                interp=jj,
                                mu=c.fa(apos + 2, nmu),
                                pdf=c.fa(apos + 2 + nmu, nmu),
                                cdf=c.fa(apos + 2 + 2 * nmu, nmu),
                            )
                        )
                tab.angular = ang
            tables.append(tab)
        return LawData(law=law, energies=energies, nbt=nbt, int_law=int_law, tables=tables)
    if law in (7, 9):
        theta, pos = _read_tab1(c, pos, xscale=MEV_TO_EV, yscale=MEV_TO_EV)
        return LawData(law=law, theta=theta, restriction_u=c.f(pos) * MEV_TO_EV)
    if law == 11:
        a_tab, pos = _read_tab1(c, pos, xscale=MEV_TO_EV, yscale=MEV_TO_EV)
        b_tab, pos = _read_tab1(c, pos, xscale=MEV_TO_EV, yscale=1.0 / MEV_TO_EV)
        return LawData(law=11, a_tab=a_tab, b_tab=b_tab, restriction_u=c.f(pos) * MEV_TO_EV)
    if law == 5:
        theta, pos = _read_tab1(c, pos, xscale=MEV_TO_EV, yscale=MEV_TO_EV)
        net = c.i(pos)
        return LawData(law=5, theta=theta, x_grid=c.fa(pos + 1, net))
    if law == 1:
        nbt, int_law, pos = _read_interp_header(c, pos)
        ne = c.i(pos)
        energies = c.fa(pos + 1, ne) * MEV_TO_EV
        pos = pos + 1 + ne
        net = c.i(pos)
        bins = c.fa(pos + 1, ne * net).reshape(ne, net) * MEV_TO_EV
        return LawData(law=1, energies=energies, nbt=nbt, int_law=int_law, net=net, e_out_bins=bins)
    if law == 66:
        return LawData(law=66, npsx=c.i(pos), ap=c.f(pos + 1))
    if law == 67:
        # lab angle-energy (ENDF File 6 LAW=7): per incident energy, a mu
        # grid whose slices carry joint-density E' tables (records.py
        # AngleEnergySlice convention)
        nbt, int_law, pos = _read_interp_header(c, pos)
        ne = c.i(pos)
        energies = c.fa(pos + 1, ne) * MEV_TO_EV
        locs = c.ia(pos + 1 + ne, ne)
        ae_tables = []
        for loc in locs:
            tpos = dlw_start + int(loc) - 1
            intmu = c.i(tpos)
            nmu = c.i(tpos + 1)
            mu = c.fa(tpos + 2, nmu)
            lmu = c.ia(tpos + 2 + nmu, nmu)
            slices = []
            for lm in lmu:
                spos = dlw_start + int(lm) - 1
                intep = c.i(spos)
                npe = c.i(spos + 1)
                slices.append(
                    AngleEnergySlice(
                        intep=intep,
                        e_out=c.fa(spos + 2, npe) * MEV_TO_EV,
                        pdf=c.fa(spos + 2 + npe, npe) / MEV_TO_EV,
                        cdf=c.fa(spos + 2 + 2 * npe, npe),
                    )
                )
            ae_tables.append(AngleEnergyTable(intmu=intmu, mu=mu, slices=slices))
        return LawData(law=67, energies=energies, nbt=nbt, int_law=int_law, ae_tables=ae_tables)
    # Unknown/unsupported: retain nothing but the law id.
    return LawData(law=law, raw=np.zeros(0))


def _read_law_chain(c: _Cursor, dlw_start: int, locator: int) -> list[EnergyDistribution]:
    dists = []
    loc = locator
    while loc != 0:
        pos = dlw_start + loc - 1
        lnw = c.i(pos)
        law = c.i(pos + 1)
        idat = c.i(pos + 2)
        applic, _ = _read_tab1(c, pos + 3, xscale=MEV_TO_EV)
        data = _read_law_data(c, dlw_start, law, idat)
        dists.append(EnergyDistribution(law=law, applicability=applic, data=data))
        loc = lnw
    return dists


# --------------------------------------------------------------------------


def parse_ascii(text: str, name_hint: str | None = None) -> Nuclide:
    try:
        return _parse_ascii(text, name_hint)
    except AceFormatError:
        raise
    except (ValueError, IndexError) as e:
        # Malformed content (bad tokens, truncated blocks) surfaces as the
        # typed error so the sweep can quarantine the nuclide (SURVEY.md s5).
        raise AceFormatError(f"malformed ACE content: {e}") from e


def _parse_ascii(text: str, name_hint: str | None = None) -> Nuclide:
    lines = text.splitlines()
    if not lines:
        raise AceFormatError("empty ACE file")
    first = lines[0].split()
    if first and first[0].startswith("2.0"):
        # 2.0.x header: line0: VERS SZAID SRC ; line1: AWR kT date Ncomment
        szaid = first[1] if len(first) > 1 else (name_hint or "unknown")
        hdr2 = lines[1].split()
        awr = float(hdr2[0])
        kt_ev = float(hdr2[1]) * MEV_TO_EV
        date = hdr2[2] if len(hdr2) > 2 else ""
        ncom = int(hdr2[3]) if len(hdr2) > 3 else 0
        body_start = 2 + ncom
        name = szaid
    else:
        # legacy header: zaid(10) awr(12) temp(12) date ; comment line
        line0 = lines[0]
        name = line0[:10].strip()
        rest = line0[10:].split()
        awr = float(rest[0])
        kt_ev = float(rest[1]) * MEV_TO_EV
        date = rest[2] if len(rest) > 2 else ""
        body_start = 2
    # 4 lines IZ/AW, 2 lines NXS, 4 lines JXS
    izaw_end = body_start + 4
    nxs_tokens = "".join(lines[izaw_end : izaw_end + 2])
    nxs = np.array([int(nxs_tokens[i : i + 9]) for i in range(0, 16 * 9, 9)], dtype=np.int64)
    jxs_tokens = "".join(lines[izaw_end + 2 : izaw_end + 6])
    jxs = np.array([int(jxs_tokens[i : i + 9]) for i in range(0, 32 * 9, 9)], dtype=np.int64)
    xss_text = "\n".join(lines[izaw_end + 6 :])
    xss = native.tokenize_floats(xss_text)
    if xss.size < nxs[0]:
        raise AceFormatError(f"XSS truncated: have {xss.size}, NXS(1)={nxs[0]}")
    xss = xss[: nxs[0]]
    return decode(AceHeader(name=name, awr=awr, kT_ev=kt_ev, date=date), nxs, jxs, xss)


def decode(hdr: AceHeader, nxs: np.ndarray, jxs: np.ndarray, xss: np.ndarray) -> Nuclide:
    c = _Cursor(xss)
    nes, ntr, nr, npcr = int(nxs[2]), int(nxs[3]), int(nxs[4]), int(nxs[7])

    esz = int(jxs[0])
    nuc = Nuclide(
        name=hdr.name,
        zaid=int(nxs[1]),
        awr=hdr.awr,
        kT=hdr.kT_ev,
        energy=c.fa(esz, nes) * MEV_TO_EV,
        sigma_t=c.fa(esz + nes, nes),
        sigma_a=c.fa(esz + 2 * nes, nes),
        sigma_el=c.fa(esz + 3 * nes, nes),
        heating=c.fa(esz + 4 * nes, nes),
    )
    # ESZ sanity: a corrupted table must fail HERE with the typed error the
    # sweep quarantines on, not propagate garbage into the kernels
    # ascending with equals allowed: the 12-digit ASCII mantissa can collapse
    # ultra-close resonance grid points to equal neighbors
    if nes < 2 or np.any(nuc.energy <= 0) or np.any(np.diff(nuc.energy) < 0):
        raise AceFormatError("ESZ union energy grid must be positive and ascending")
    if np.any(nuc.sigma_t < 0) or np.any(nuc.sigma_el < 0):
        raise AceFormatError("ESZ cross sections must be non-negative")

    # NU
    if jxs[1] > 0:
        knu = c.i(int(jxs[1]))
        if knu < 0:
            nuc.nu_prompt = _read_nu(c, int(jxs[1]) + 1)
            nuc.nu_total = _read_nu(c, int(jxs[1]) + 1 + abs(knu))
        else:
            nuc.nu_total = _read_nu(c, int(jxs[1]))

    mts = c.ia(int(jxs[2]), ntr) if ntr else np.zeros(0, dtype=np.int64)
    qs = c.fa(int(jxs[3]), ntr) * MEV_TO_EV if ntr else np.zeros(0)
    tyr = c.ia(int(jxs[4]), ntr) if ntr else np.zeros(0, dtype=np.int64)
    lsig = c.ia(int(jxs[5]), ntr) if ntr else np.zeros(0, dtype=np.int64)
    sig_start = int(jxs[6])

    for k in range(ntr):
        spos = sig_start + int(lsig[k]) - 1
        ie = c.i(spos)
        ne = c.i(spos + 1)
        ty = int(tyr[k])
        rxn = Reaction(
            mt=int(mts[k]),
            q=float(qs[k]),
            frame="cm" if ty < 0 else "lab",
            multiplicity=0,
            threshold_idx=ie - 1,
            sigma=c.fa(spos + 2, ne),
        )
        aty = abs(ty)
        if aty == 19:
            rxn.multiplicity = 19
        elif aty > 100:
            rxn.multiplicity = 1  # actual yield from table, read after DLW start known
        else:
            rxn.multiplicity = aty
        nuc.reactions[rxn.mt] = rxn

    # LAND / AND: first entry elastic, then reactions with secondary neutrons in MTR order
    with_sec = [int(mt) for k, mt in enumerate(mts) if abs(int(tyr[k])) != 0]
    if jxs[7] > 0:
        land = c.ia(int(jxs[7]), nr + 1)
        and_start = int(jxs[8])
        if land[0] > 0:
            nuc.elastic_angular = _read_angular_dist(c, and_start, int(land[0]))
        elif land[0] == 0:
            nuc.elastic_angular = None  # isotropic at all energies
        for k, mt in enumerate(with_sec):
            loc = int(land[k + 1])
            if loc == -1:
                nuc.reactions[mt].angular_in_dlw = True
            elif loc > 0:
                nuc.reactions[mt].angular = _read_angular_dist(c, and_start, loc)

    # LDLW / DLW
    if nr and jxs[9] > 0:
        ldlw = c.ia(int(jxs[9]), nr)
        dlw_start = int(jxs[10])
        for k, mt in enumerate(with_sec):
            nuc.reactions[mt].energy_dists = _read_law_chain(c, dlw_start, int(ldlw[k]))
        # energy-dependent yields
        for k in range(ntr):
            aty = abs(int(tyr[k]))
            if aty > 100:
                tab, _ = _read_tab1(c, dlw_start + (aty - 100) - 1, xscale=MEV_TO_EV)
                nuc.reactions[int(mts[k])].yield_tab = tab

    # Delayed-neutron blocks
    if jxs[23] > 0:
        nuc.nu_delayed = _read_nu(c, int(jxs[23]))
    if npcr and jxs[24] > 0:
        pos = int(jxs[24])
        for _ in range(npcr):
            dec = c.f(pos) / SHAKE  # 1/shake -> 1/s
            prob, pos = _read_tab1(c, pos + 1, xscale=MEV_TO_EV)
            nuc.precursors.append(Precursor(decay_const=dec, probability=prob))
        if jxs[25] > 0:
            dnedl = c.ia(int(jxs[25]), npcr)
            dned_start = int(jxs[26])
            for loc in dnedl:
                chain = _read_law_chain(c, dned_start, int(loc))
                nuc.delayed_spectra.append(chain[0])

    return nuc


def read_ace(path: str | Path, name_hint: str | None = None) -> Nuclide:
    """Read the (single) ACE table in an ASCII file."""
    return parse_ascii(Path(path).read_text(), name_hint=name_hint)
