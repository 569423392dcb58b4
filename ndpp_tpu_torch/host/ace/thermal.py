"""Thermal S(alpha,beta) ACE table codec (class 't' tables).

Counterpart of ndpp_tpu/host/ace/thermal.py; the XSS block is tokenized
with numpy, as host/ace/parse.py does for nuclides.

Bound-thermal scattering libraries (lwtr/grph/...-style) carry the
temperature-dependent double-differential data the free-gas model cannot:
chemical binding and coherent lattice effects. This module implements the
published thermal ACE layout (MCNP manual appendix F; the counterpart of
the reference's thermal branch of its ACE reader, SURVEY.md section 2 'ACE
reader' — per-claim file:line citations impossible with the mount empty,
SURVEY.md section 0):

  NXS(2) IDPNI  inelastic distribution type (3 = equiprobable-discrete /
                continuous per IFENG)
  NXS(3) NIL    inelastic angular dimensioning: IFENG<2 -> NIL+1
                equiprobable cosines per outgoing line; IFENG=2 -> NIL-1
                discrete cosines per outgoing knot
  NXS(4) NIEB   number of inelastic exiting energies (IFENG<2)
  NXS(5) IDPNC  elastic distribution type (4 = coherent, 3 = incoherent)
  NXS(6) NCL    elastic angular dimensioning: NCL+1 equiprobable cosines
                (incoherent); -1 for coherent
  NXS(7) IFENG  secondary-energy mode: 0 = discrete equally likely,
                1 = discrete skewed, 2 = continuous tabular
  JXS(1) ITIE   inelastic energy table: NEin, E[NEin], sigma[NEin]
  JXS(2) ITIX   inelastic cross-section position
  JXS(3) ITXE   inelastic energy/angle distributions
  JXS(4) ITCE   elastic energy table (0 = no elastic channel)
  JXS(5) ITCX   elastic cross-section position
  JXS(6) ITCA   elastic angular distributions (incoherent only)

ITXE layout, IFENG<2 (discrete): for each incident energy, NIEB rows of
[E'_ij, mu_ij0..mu_ijNIL] — equally likely rows (IFENG=0) or the standard
skewed weighting (IFENG=1: relative weights 0.1, 0.4, 1, ..., 1, 0.4, 0.1
normalized by NIEB-3).

ITXE layout, IFENG=2 (continuous): NEin locators (1-based, relative to
JXS(3)) + NEin counts, then per incident energy NEP_i rows of
[E'_j, pdf_j, cdf_j, mu_j1..mu_j(NIL-1)]. Locator conventions for the
continuous form differ across historical processors; ours is documented
here and round-trips exactly — reconcile against the reference if the
mount appears (SURVEY.md section 0 protocol).

Coherent elastic ITCE stores Bragg-edge energies E_k and CUMULATIVE
structure sums P_k (b*MeV): sigma(E) = P_k / E for E_k <= E < E_{k+1};
scattering off edge k deflects to mu_k(E) = 1 - 2 E_k / E with probability
(P_k - P_{k-1}) / P(E).

Energies are eV in memory (converted at the parse/write boundary, same
convention as records.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ndpp_tpu_torch import native
from ndpp_tpu_torch.host.ace.parse import _Cursor
from ndpp_tpu_torch.host.ace.records import MEV_TO_EV
from ndpp_tpu_torch.host.ace.write import _Xss
from ndpp_tpu_torch.utils.errors import AceFormatError

_EV = 1.0 / MEV_TO_EV


# --------------------------------------------------------------------------
# Records


@dataclass
class ThermalInelasticDiscrete:
    """IFENG 0/1: per incident energy, NIEB outgoing lines with equiprobable cosines.

    e_out: (NEin, NIEB) eV; mu: (NEin, NIEB, NIL+1).
    """

    skewed: bool  # IFENG == 1
    e_out: np.ndarray
    mu: np.ndarray

    def weights(self) -> np.ndarray:
        """Per-line probabilities (NIEB,) — equal or the standard skewed set."""
        nieb = self.e_out.shape[1]
        if not self.skewed:
            return np.full(nieb, 1.0 / nieb)
        if nieb < 5:
            raise AceFormatError("skewed (IFENG=1) thermal table needs NIEB >= 5")
        w = np.ones(nieb)
        w[0] = w[-1] = 0.1
        w[1] = w[-2] = 0.4
        return w / (nieb - 3.0)


@dataclass
class ThermalInelasticContinuous:
    """IFENG=2: per incident energy, a tabulated E' pdf with discrete cosines.

    Ragged across incident energies: lists of (NEP_i,) / (NEP_i, NIL-1).
    pdf is 1/eV; rows are lin-lin in E' between knots (the standard
    continuous-representation convention).
    """

    e_out: list[np.ndarray]
    pdf: list[np.ndarray]
    cdf: list[np.ndarray]
    mu: list[np.ndarray]


@dataclass
class ThermalElastic:
    """Elastic channel: coherent (Bragg) or incoherent (equiprobable cosines)."""

    coherent: bool
    energy: np.ndarray  # (NEel,) eV: grid (incoherent) or Bragg edges (coherent)
    # incoherent: sigma(E) barns on `energy`; coherent: cumulative P_k (b*eV)
    sigma: np.ndarray
    mu: np.ndarray | None = None  # incoherent: (NEel, NCL+1)

    def sigma_at(self, e: np.ndarray) -> np.ndarray:
        e = np.asarray(e, dtype=np.float64)
        if self.coherent:
            k = np.searchsorted(self.energy, e, side="right") - 1
            out = np.where(k >= 0, self.sigma[np.clip(k, 0, None)] / np.maximum(e, 1e-30), 0.0)
            return out
        return np.interp(e, self.energy, self.sigma, left=0.0, right=0.0)


@dataclass
class ThermalTable:
    """One thermal S(alpha,beta) ACE table (e.g. lwtr.20t)."""

    name: str
    zaids: list[int]  # nuclide ZAs this table applies to (IZ entries)
    awr: float
    kT: float  # eV
    inelastic_energy: np.ndarray = field(default_factory=lambda: np.zeros(0))  # (NEin,) eV
    inelastic_sigma: np.ndarray = field(default_factory=lambda: np.zeros(0))  # barns
    inelastic: ThermalInelasticDiscrete | ThermalInelasticContinuous | None = None
    elastic: ThermalElastic | None = None

    @property
    def ifeng(self) -> int:
        if isinstance(self.inelastic, ThermalInelasticContinuous):
            return 2
        assert isinstance(self.inelastic, ThermalInelasticDiscrete)
        return 1 if self.inelastic.skewed else 0

    @property
    def e_max(self) -> float:
        """Upper validity energy: the inelastic table's last incident energy."""
        return float(self.inelastic_energy[-1])


# --------------------------------------------------------------------------
# Encoder


def encode_thermal(tab: ThermalTable) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    nxs = np.zeros(16, dtype=np.int64)
    jxs = np.zeros(32, dtype=np.int64)
    xss = _Xss()

    ne = tab.inelastic_energy.size
    if ne == 0 or tab.inelastic is None:
        raise AceFormatError("thermal table must carry an inelastic channel")
    if tab.inelastic_sigma.size != ne:
        raise AceFormatError("thermal inelastic grid/sigma size mismatch")

    # ITIE / ITIX
    jxs[0] = xss.pos
    xss.append(ne)
    xss.append(tab.inelastic_energy * _EV)
    jxs[1] = xss.pos
    xss.append(tab.inelastic_sigma)

    # ITXE
    jxs[2] = itxe = xss.pos
    inel = tab.inelastic
    if isinstance(inel, ThermalInelasticDiscrete):
        nieb = inel.e_out.shape[1]
        nil = inel.mu.shape[2] - 1
        if inel.e_out.shape != (ne, nieb) or inel.mu.shape != (ne, nieb, nil + 1):
            raise AceFormatError("thermal discrete inelastic shape mismatch")
        for i in range(ne):
            for j in range(nieb):
                xss.append(inel.e_out[i, j] * _EV)
                xss.append(inel.mu[i, j])
        nxs[2] = nil
        nxs[3] = nieb
        nxs[6] = 1 if inel.skewed else 0
    else:
        ncos = inel.mu[0].shape[1] if inel.mu and inel.mu[0].ndim == 2 else 0
        nil = ncos + 1
        loc_pos = xss.append(np.zeros(ne))
        xss.append([float(e.size) for e in inel.e_out])
        for i in range(ne):
            xss.set(loc_pos + i, xss.pos - itxe + 1)
            nep = inel.e_out[i].size
            if inel.mu[i].shape != (nep, ncos):
                raise AceFormatError("thermal continuous inelastic mu shape mismatch")
            for j in range(nep):
                xss.append(inel.e_out[i][j] * _EV)
                xss.append(inel.pdf[i][j] / _EV)
                xss.append(inel.cdf[i][j])
                xss.append(inel.mu[i][j])
        nxs[2] = nil
        nxs[3] = 0
        nxs[6] = 2
    nxs[1] = 3  # IDPNI

    # Elastic
    el = tab.elastic
    if el is not None:
        nel = el.energy.size
        jxs[3] = xss.pos
        xss.append(nel)
        xss.append(el.energy * _EV)
        jxs[4] = xss.pos
        if el.coherent:
            xss.append(el.sigma * _EV)  # cumulative b*eV -> b*MeV
            nxs[4] = 4
            nxs[5] = -1
        else:
            xss.append(el.sigma)
            assert el.mu is not None
            ncl = el.mu.shape[1] - 1
            if el.mu.shape != (nel, ncl + 1):
                raise AceFormatError("thermal incoherent elastic mu shape mismatch")
            jxs[5] = xss.pos
            for i in range(nel):
                xss.append(el.mu[i])
            nxs[4] = 3
            nxs[5] = ncl

    nxs[0] = len(xss.data)
    return nxs, jxs, xss.array()


def format_thermal_ascii(tab: ThermalTable, date: str = "08/17/26", comment: str | None = None) -> str:
    nxs, jxs, xss = encode_thermal(tab)
    lines = []
    lines.append(f"{tab.name:<10s}{tab.awr:12.6f}{tab.kT * _EV:12.4E} {date:<10s}")
    lines.append(f"{(comment or 'ndpp-tpu synthetic thermal fixture'):<70s}{'mat 0':<10s}")
    # IZ/AW pairs: the applicable ZAs
    izaw = list(tab.zaids[:16]) + [0] * (16 - len(tab.zaids[:16]))
    for row in range(4):
        lines.append("".join(f"{int(z):7d}{0.0:11.0f}" for z in izaw[row * 4 : row * 4 + 4]))
    for row in range(2):
        lines.append("".join(f"{int(v):9d}" for v in nxs[row * 8 : row * 8 + 8]))
    for row in range(4):
        lines.append("".join(f"{int(v):9d}" for v in jxs[row * 8 : row * 8 + 8]))
    for i in range(0, xss.size, 4):
        lines.append("".join(f"{v:20.12E}" for v in xss[i : i + 4]))
    return "\n".join(lines) + "\n"


def write_thermal_ace(tab: ThermalTable, path: str | Path, **kw) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(format_thermal_ascii(tab, **kw))
    return p


# --------------------------------------------------------------------------
# Parser


def parse_thermal_ascii(text: str, name_hint: str | None = None) -> ThermalTable:
    try:
        return _parse_thermal(text, name_hint)
    except AceFormatError:
        raise
    except (ValueError, IndexError) as e:
        raise AceFormatError(f"malformed thermal ACE content: {e}") from e


def _parse_thermal(text: str, name_hint: str | None) -> ThermalTable:
    lines = text.splitlines()
    if not lines:
        raise AceFormatError("empty thermal ACE file")
    line0 = lines[0]
    name = line0[:10].strip() or (name_hint or "unknown")
    rest = line0[10:].split()
    awr = float(rest[0])
    kt_ev = float(rest[1]) * MEV_TO_EV
    body_start = 2
    izaw_end = body_start + 4
    zaids = []
    for row in range(4):
        ln = lines[body_start + row]
        for c in range(4):
            z = int(ln[c * 18 : c * 18 + 7])
            if z:
                zaids.append(z)
    nxs_tokens = "".join(lines[izaw_end : izaw_end + 2])
    nxs = np.array([int(nxs_tokens[i : i + 9]) for i in range(0, 16 * 9, 9)], dtype=np.int64)
    jxs_tokens = "".join(lines[izaw_end + 2 : izaw_end + 6])
    jxs = np.array([int(jxs_tokens[i : i + 9]) for i in range(0, 32 * 9, 9)], dtype=np.int64)
    xss = native.tokenize_floats("\n".join(lines[izaw_end + 6 :]))
    if xss.size < nxs[0]:
        raise AceFormatError(f"thermal XSS truncated: have {xss.size}, NXS(1)={nxs[0]}")
    xss = xss[: nxs[0]]

    c = _Cursor(xss)
    nil, nieb, ifeng = int(nxs[2]), int(nxs[3]), int(nxs[6])
    ncl = int(nxs[5])

    itie = int(jxs[0])
    ne = c.i(itie)
    e_in = c.fa(itie + 1, ne) * MEV_TO_EV
    sig_in = c.fa(int(jxs[1]), ne)

    itxe = int(jxs[2])
    inelastic: ThermalInelasticDiscrete | ThermalInelasticContinuous
    if ifeng < 2:
        stride = nieb * (nil + 2)
        block = c.fa(itxe, ne * stride).reshape(ne, nieb, nil + 2)
        inelastic = ThermalInelasticDiscrete(
            skewed=(ifeng == 1), e_out=block[:, :, 0] * MEV_TO_EV, mu=block[:, :, 1:].copy()
        )
    else:
        ncos = nil - 1
        locs = c.ia(itxe, ne)
        neps = c.ia(itxe + ne, ne)
        e_out, pdf, cdf, mu = [], [], [], []
        for i in range(ne):
            pos = itxe + int(locs[i]) - 1
            nep = int(neps[i])
            rows = c.fa(pos, nep * (3 + ncos)).reshape(nep, 3 + ncos)
            e_out.append(rows[:, 0] * MEV_TO_EV)
            pdf.append(rows[:, 1] / MEV_TO_EV)
            cdf.append(rows[:, 2])
            mu.append(rows[:, 3:].copy())
        inelastic = ThermalInelasticContinuous(e_out=e_out, pdf=pdf, cdf=cdf, mu=mu)

    elastic = None
    if jxs[3] > 0:
        itce = int(jxs[3])
        nel = c.i(itce)
        e_el = c.fa(itce + 1, nel) * MEV_TO_EV
        vals = c.fa(int(jxs[4]), nel)
        if ncl == -1:  # coherent: cumulative b*MeV -> b*eV
            elastic = ThermalElastic(coherent=True, energy=e_el, sigma=vals * MEV_TO_EV)
        else:
            mu_el = c.fa(int(jxs[5]), nel * (ncl + 1)).reshape(nel, ncl + 1)
            elastic = ThermalElastic(coherent=False, energy=e_el, sigma=vals, mu=mu_el)

    return ThermalTable(
        name=name,
        zaids=zaids,
        awr=awr,
        kT=kt_ev,
        inelastic_energy=e_in,
        inelastic_sigma=sig_in,
        inelastic=inelastic,
        elastic=elastic,
    )


def read_thermal_ace(path: str | Path) -> ThermalTable:
    p = Path(path)
    return parse_thermal_ascii(p.read_text(), name_hint=p.stem)
