"""The free-gas replacement of one 0 K row, at one temperature.

Between 0 and the cutoff (thermal_cutoff_kt x kT) the elastic channel of a
nuclide the configuration names (all of them where `freegas_for` is empty)
is the free gas, weighted by the ratio of the free gas's effective cross
sections at the requested and the file's temperature:

    f = [f0 s_s - s_el f_el0 + r s_el f_fg] / (s_s + s_el (r - 1))

Plain NumPy (the free gas plain PyTorch).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import freegas
from .nuclide import elastic_row

BOLTZMANN_EV_PER_K = 8.617333262e-5


def doppler_ratio(e: float, awr: float, kt: float) -> float:
    """sigma_eff / sigma_free of a Maxwellian free gas, constant sigma."""
    x = math.sqrt(max(awr * e / kt, 1e-30))
    return (1.0 + 0.5 / x**2) * math.erf(x) + math.exp(-(x**2)) / (math.sqrt(math.pi) * x)


def freegas_on(nuc, run) -> bool:
    names = run.get("freegas_for")
    return names != ["none"] and (not names or nuc.name in names)


def region(nuc, run, i, temp) -> str:
    """Which physics a row takes at one temperature: freegas or 0K."""
    e = float(nuc.energy[i])
    kt = BOLTZMANN_EV_PER_K * temp
    return "freegas" if freegas_on(nuc, run) and e < run["thermal_cutoff_kt"] * kt else "0K"


def replace_row(nuc, run, i, temp, base, sig, sigma_s, bounds, dtype=np.float64, device="cpu"):
    """The row at one temperature after the free-gas replacement."""
    if region(nuc, run, i, temp) != "freegas":
        return base
    e = float(nuc.energy[i])
    kt = BOLTZMANN_EV_PER_K * temp
    order, clamp = run["legendre_order"], run["clamp_outside"]
    s_s, s_el0 = float(sigma_s[i]), float(sig[2][i])
    r = doppler_ratio(e, nuc.awr, kt) / doppler_ratio(e, nuc.awr, max(nuc.kT, 1e-12))
    den = s_s + s_el0 * (r - 1.0)
    if den <= 0:
        return base
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    f_fg = freegas.moments(e, nuc.awr, kt, bounds, order, clamp, device=device, dtype=tdt).astype(dtype)
    f0 = elastic_row(nuc, i, bounds, order, clamp, dtype)
    return ((base * s_s - s_el0 * f0 + s_el0 * r * f_fg) / den).astype(dtype)
