"""Typed in-memory model of a continuous-energy ACE neutron table.

Mirrors the block structure of the published ACE format (SURVEY.md section
8.1; the reference's ``ace.F90``/``ace_header.F90`` derived types play the
same role, SURVEY.md section 2 'ACE reader') but normalized for this
framework:

  - All energies/Q-values are converted to **eV** at the parse boundary
    (raw ACE stores MeV); the writer converts back. Everything outside
    ``host/ace`` works in eV.
  - All three ACE angular encodings (isotropic, 32-equiprobable-bin,
    tabulated) are normalized to the tabulated form (``AngularTable``), so
    downstream batching has exactly one representation to pad
    (SURVEY.md section 2, 'Angular-dist evaluation').

Law coverage follows ACE LDLW/DLW: 1, 3, 4, 5, 7, 9, 11, 44, 61, 66
(SURVEY.md section 8.1). Law 67 (lab angle-energy) parses to an opaque
record and is rejected by the moment engine with a clear error.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import interp as interp_mod
from .errors import AceFormatError

MEV_TO_EV = 1.0e6


# --------------------------------------------------------------------------
# Small shared tables


@dataclass
class Tab1:
    """An (x, y) table with ENDF region-wise interpolation (NBT/INT)."""

    x: np.ndarray
    y: np.ndarray
    nbt: np.ndarray | None = None  # 1-based region ends; None => single region
    law: np.ndarray | int = interp_mod.LINLIN

    def __post_init__(self) -> None:
        self.x = np.asarray(self.x, dtype=np.float64)
        self.y = np.asarray(self.y, dtype=np.float64)
        if self.x.shape != self.y.shape:
            raise AceFormatError("Tab1: x/y shape mismatch")

    def __call__(self, x):
        return interp_mod.interp_tab1(x, self.x, self.y, self.nbt, self.law)


# --------------------------------------------------------------------------
# Angular distributions


@dataclass
class AngularTable:
    """p(mu) at one incident energy: tabulated pdf with ACE JJ interpolation."""

    interp: int  # 1 = histogram, 2 = lin-lin (ACE JJ flag)
    mu: np.ndarray
    pdf: np.ndarray
    cdf: np.ndarray

    def __post_init__(self) -> None:
        self.mu = np.asarray(self.mu, dtype=np.float64)
        self.pdf = np.asarray(self.pdf, dtype=np.float64)
        self.cdf = np.asarray(self.cdf, dtype=np.float64)
        if self.mu[0] < -1.0 - 1e-12 or self.mu[-1] > 1.0 + 1e-12:
            raise AceFormatError("angular table mu outside [-1, 1]")

    @classmethod
    def isotropic(cls) -> "AngularTable":
        return cls(interp=2, mu=np.array([-1.0, 1.0]), pdf=np.array([0.5, 0.5]), cdf=np.array([0.0, 1.0]))

    @classmethod
    def from_tabulated(cls, interp: int, mu: np.ndarray, pdf: np.ndarray, cdf: np.ndarray | None = None) -> "AngularTable":
        mu = np.asarray(mu, dtype=np.float64)
        pdf = np.asarray(pdf, dtype=np.float64)
        if cdf is None:
            cdf = (interp_mod.hist_pdf_to_cdf(mu, pdf) if interp == 1 else interp_mod.trapz_pdf_to_cdf(mu, pdf))
        return cls(interp=interp, mu=mu, pdf=pdf, cdf=np.asarray(cdf, dtype=np.float64))

    @classmethod
    def from_equiprobable(cls, bin_bounds_33: np.ndarray) -> "AngularTable":
        """Normalize the legacy 32-equiprobable-cosine-bin encoding to a histogram pdf.

        Each of the 32 bins carries probability 1/32, so the pdf on bin i is
        (1/32) / (mu[i+1] - mu[i]).
        """
        b = np.asarray(bin_bounds_33, dtype=np.float64)
        if b.size != 33:
            raise AceFormatError("equiprobable angular bins need 33 boundaries")
        widths = np.diff(b)
        if np.any(widths <= 0):
            raise AceFormatError("equiprobable angular bins must be strictly ascending")
        pdf = np.concatenate([(1.0 / 32.0) / widths, [0.0]])  # histogram: last value unused
        cdf = np.concatenate([[0.0], np.cumsum(np.full(32, 1.0 / 32.0))])
        return cls(interp=1, mu=b, pdf=pdf, cdf=cdf)

    def norm(self) -> float:
        if self.interp == 1:
            return float(np.sum(self.pdf[:-1] * np.diff(self.mu)))
        return float(np.trapezoid(self.pdf, self.mu))


@dataclass
class AngularDistribution:
    """Angular distribution vs incident energy (normalized AND-block content)."""

    energies: np.ndarray  # (NE,) eV, ascending
    tables: list[AngularTable]  # len NE
    # Provenance of the original encoding per energy table, for round-trip
    # fidelity: 'tabular' | 'isotropic' | 'equiprobable'.
    encodings: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.energies = np.asarray(self.energies, dtype=np.float64)
        if len(self.tables) != self.energies.size:
            raise AceFormatError("angular distribution: energies/tables length mismatch")
        if not self.encodings:
            self.encodings = ["tabular"] * len(self.tables)

    @classmethod
    def isotropic(cls, emin: float, emax: float) -> "AngularDistribution":
        return cls(
            energies=np.array([emin, emax]),
            tables=[AngularTable.isotropic(), AngularTable.isotropic()],
            encodings=["isotropic", "isotropic"],
        )


# --------------------------------------------------------------------------
# Energy (secondary-energy / angle-energy) distribution laws


@dataclass
class AngleEnergySlice:
    """One mu entry of a law-67 table: the E' distribution at that cosine.

    Convention (documented in docs/design.md; ENDF-6 File 6 LAW=7 faithful,
    unverifiable against the reference with the mount empty — SURVEY.md
    section 0): ``pdf`` carries the JOINT density f(mu, E') per (eV x unit
    cosine); integrating a slice over E' yields the angular marginal at its
    mu. Our ACE writer emits the same convention, so round-trips are exact.
    """

    intep: int  # 1 = histogram, 2 = lin-lin in E'
    e_out: np.ndarray  # (NP,) eV
    pdf: np.ndarray  # (NP,) joint density 1/(eV * unit-mu)
    cdf: np.ndarray  # (NP,)


@dataclass
class AngleEnergyTable:
    """One incident-energy entry of a law-67 (lab angle-energy) table."""

    intmu: int  # 1 = histogram, 2 = lin-lin between mu slices
    mu: np.ndarray  # (NMU,)
    slices: list[AngleEnergySlice]


@dataclass
class ContinuousTable:
    """One incident-energy entry of a law 4/44/61 table."""

    intt: int  # 1 = histogram, 2 = lin-lin (low digit of ACE INTT')
    nd: int  # number of discrete (delta) lines at the head of the table
    e_out: np.ndarray  # (NP,) eV
    pdf: np.ndarray  # (NP,) 1/eV (continuous part); discrete lines carry probability directly
    cdf: np.ndarray  # (NP,)
    # law 44 extras
    r: np.ndarray | None = None  # Kalbach precompound fraction
    a: np.ndarray | None = None  # Kalbach slope (1/?) — dimensionless in ACE usage here
    # law 61 extras: per-e_out angular table (None = isotropic)
    angular: list[AngularTable | None] | None = None


@dataclass
class LawData:
    """Union of law payloads; exactly one group of fields is populated per law."""

    law: int
    # laws 4/44/61
    energies: np.ndarray | None = None  # incident grid (eV)
    nbt: np.ndarray | None = None
    int_law: np.ndarray | int = interp_mod.LINLIN
    tables: list[ContinuousTable] | None = None
    # law 3
    c1: float | None = None  # threshold term (A+1)/A * |Q|, eV
    c2: float | None = None  # (A/(A+1))^2
    # laws 7/9: theta(E); law 5: T(E) + X table; law 11: a(E), b(E)
    theta: Tab1 | None = None
    a_tab: Tab1 | None = None
    b_tab: Tab1 | None = None
    restriction_u: float | None = None  # eV
    x_grid: np.ndarray | None = None  # law 5 X function values
    # law 1: equiprobable outgoing-energy bins
    net: int | None = None
    e_out_bins: np.ndarray | None = None  # (NE, NET)
    # law 66
    npsx: int | None = None
    ap: float | None = None
    # law 67 (lab angle-energy): per-incident-energy joint (mu, E') tables
    ae_tables: list["AngleEnergyTable"] | None = None
    # unknown laws: raw payload retained
    raw: np.ndarray | None = None


@dataclass
class EnergyDistribution:
    """One law in a reaction's DLW chain with its applicability probability."""

    law: int
    applicability: Tab1  # p(E): probability that this law applies
    data: LawData


# --------------------------------------------------------------------------
# Reactions / nuclide


@dataclass
class Reaction:
    mt: int
    q: float  # eV
    frame: str  # 'cm' | 'lab' (sign of TYR)
    multiplicity: int  # |TYR| for simple yields; 19 => fission; 0 => no secondary neutrons
    yield_tab: Tab1 | None = None  # energy-dependent yield when |TYR| > 100
    threshold_idx: int = 0  # 0-based index into the union grid where sigma starts (ACE IE-1)
    sigma: np.ndarray = field(default_factory=lambda: np.zeros(0))  # from threshold_idx
    angular: AngularDistribution | None = None  # None => given in DLW (law 44/61) or isotropic
    angular_in_dlw: bool = False  # ACE LAND = -1
    energy_dists: list[EnergyDistribution] = field(default_factory=list)

    @property
    def is_fission(self) -> bool:
        return self.mt in (18, 19, 20, 21, 38) or self.multiplicity == 19

    @property
    def has_secondary_neutrons(self) -> bool:
        return self.multiplicity != 0


@dataclass
class NuBar:
    """nu-bar: polynomial (LNU=1) or tabular (LNU=2)."""

    form: str  # 'polynomial' | 'tabular'
    coeffs: np.ndarray | None = None  # polynomial in E (eV) — coefficients vs E in MeV are
    # converted so that __call__ takes eV directly
    tab: Tab1 | None = None

    def __call__(self, e_ev):
        if self.form == "polynomial":
            assert self.coeffs is not None
            return np.polynomial.polynomial.polyval(np.asarray(e_ev, dtype=np.float64), self.coeffs)
        assert self.tab is not None
        return self.tab(e_ev)


@dataclass
class Precursor:
    decay_const: float  # 1/s (ACE stores 1/shake = 1e-8 s; converted at parse)
    probability: Tab1  # fraction of delayed neutrons in this group vs E


@dataclass
class Nuclide:
    name: str  # ZAID.suffix as listed, e.g. '1001.80c'
    zaid: int
    awr: float  # atomic weight ratio A
    kT: float  # table temperature, eV
    # ESZ block (union grid)
    energy: np.ndarray = field(default_factory=lambda: np.zeros(0))  # eV ascending
    sigma_t: np.ndarray = field(default_factory=lambda: np.zeros(0))
    sigma_a: np.ndarray = field(default_factory=lambda: np.zeros(0))
    sigma_el: np.ndarray = field(default_factory=lambda: np.zeros(0))
    heating: np.ndarray = field(default_factory=lambda: np.zeros(0))
    elastic_angular: AngularDistribution | None = None
    reactions: dict[int, Reaction] = field(default_factory=dict)  # MT -> Reaction (excl. elastic)
    nu_prompt: NuBar | None = None
    nu_total: NuBar | None = None
    nu_delayed: NuBar | None = None
    precursors: list[Precursor] = field(default_factory=list)
    delayed_spectra: list[EnergyDistribution] = field(default_factory=list)

    @property
    def elastic(self) -> Reaction:
        """Elastic scattering as a Reaction (MT=2): always CM, multiplicity 1, no threshold."""
        return Reaction(
            mt=2,
            q=0.0,
            frame="cm",
            multiplicity=1,
            threshold_idx=0,
            sigma=self.sigma_el,
            angular=self.elastic_angular,
        )

    @property
    def fissionable(self) -> bool:
        return any(r.is_fission for r in self.reactions.values())

    def scattering_reactions(self, include_fission: bool = False) -> list[Reaction]:
        """Elastic + every reaction with secondary neutrons (optionally incl. fission)."""
        out = [self.elastic]
        for mt in sorted(self.reactions):
            r = self.reactions[mt]
            if r.has_secondary_neutrons and (include_fission or not r.is_fission):
                out.append(r)
        return out

    def sigma_on_grid(self, rxn: Reaction) -> np.ndarray:
        """Reaction cross section expanded to the full union grid (zero below threshold)."""
        if rxn.mt == 2:
            return self.sigma_el
        full = np.zeros_like(self.energy)
        full[rxn.threshold_idx : rxn.threshold_idx + rxn.sigma.size] = rxn.sigma
        return full
