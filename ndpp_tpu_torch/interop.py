"""Hand the same state to both packages (the reference ndpp_tpu and this port).

This system has no weights: what the two packages share is inputs — kernel
operands, group structures and run configurations. Each function here takes
plain numpy / Python values (what the reference's arrays and
``RunConfig.to_dict()`` give) and returns the port's objects. Nothing here
imports ndpp_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from ndpp_tpu_torch.config import DeviceConfig, OutputConfig, RunConfig
from ndpp_tpu_torch.groups import GroupStructure


def _f64(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64), device=device)


def twobody_inputs(e, knots, pdf, bounds, c1, c2, awr, *, device):
    """Two-body kernel operands (ops.twobody.twobody_moments order) as float64
    tensors on `device`; c1, c2, awr may be scalars or (T,) arrays."""
    dev = torch.device(device)
    return tuple(_f64(x, dev) for x in (e, knots, pdf, bounds, c1, c2, awr))


_CONTINUUM_FIELDS = (
    "e", "e_knots", "pdf", "mom_knots", "r_rows", "a_rows", "mu_knots", "mu_pdf", "nbody_emax",
)


def continuum_inputs(prep, bounds, *, device) -> dict:
    """The tensors of a ContinuumPrepared (host.prep_continuum, of either
    package: its fields are numpy arrays) for ops.continuum, as float64 on
    `device`, keyed by field name, plus "bounds". A field the law kind does
    not carry stays None."""
    dev = torch.device(device)
    out = {f: None if getattr(prep, f) is None else _f64(getattr(prep, f), dev) for f in _CONTINUUM_FIELDS}
    out["bounds"] = _f64(bounds, dev)
    return out


def chi_inputs(prep, bounds, *, device) -> tuple:
    """Arguments of the ops.chi function that collapses this spectrum, from a
    ContinuumPrepared of either package: (e, theta, b, u, bounds, law) for
    analytic_group_fractions on a 'lab-analytic' law, else (e_knots, pdf,
    bounds) for tabular_group_fractions."""
    dev = torch.device(device)
    if prep.kind == "lab-analytic":
        x = prep.extra
        return (
            _f64(prep.e, dev), _f64(x["theta"], dev), _f64(x["b"], dev), float(x["u"]), _f64(bounds, dev),
            int(x["law"]),
        )
    return _f64(prep.e_knots, dev), _f64(prep.pdf, dev), _f64(bounds, dev)


def group_structure(name: str, bounds) -> GroupStructure:
    """A GroupStructure with the given ascending boundaries (eV)."""
    return GroupStructure(name=name, bounds=np.asarray(bounds, dtype=np.float64))


def config_from_dict(d: dict) -> RunConfig:
    """RunConfig from ndpp_tpu.config.RunConfig.to_dict() (same schema)."""
    top = {k: v for k, v in d.items() if k not in ("output", "device")}
    cfg = RunConfig(
        **{k: (list(v) if isinstance(v, (list, tuple)) else v) for k, v in top.items()},
        output=OutputConfig(**d.get("output", {})),
        device=DeviceConfig(**d.get("device", {})),
    )
    cfg.sab = {str(k): list(v) for k, v in cfg.sab.items()}
    cfg.validate()
    return cfg
