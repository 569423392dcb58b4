"""A small continuum-and-fission deck for the CPU tests: every law the
generator makes (Kalbach 44 in the CM frame, 61 in the CM and the lab
frames, 66, 4 in the lab frame; a tabulated fission spectrum with delayed
groups, and a pair of analytic ones, 9 and 11, sharing the incident range
under a restriction energy), at a size the CPU holds."""

from __future__ import annotations

import copy

RUN = {"groups": "uniform-lethargy-47", "legendre_order": 3, "temperatures": [293.6], "thermal_cutoff_kt": 400.0,
       "freegas_for": ["none"], "include_yield": True, "clamp_outside": True, "quad_points": 16, "e_tile": 512,
       "output_format": "ascii"}

CATALOG = {
    "u235": {"zaid": 92235, "awr": 233.025, "n_base": 60, "resonances": 1, "levels": 2, "level_mev": [7.68e-5, 1.0],
             "sigma_el_base": 12.0, "angular_tables": 3,
             "continuum": [{"mt": 16, "law": 44, "frame": "cm", "multiplicity": 2, "threshold_mev": 5.3,
                            "incident": 4, "outgoing": 12},
                           {"mt": 91, "law": 4, "frame": "lab", "multiplicity": 1, "threshold_mev": 1.0,
                            "incident": 4, "outgoing": 12, "cosines": 5}],
             "fission": {"laws": [4], "incident": 3, "outgoing": 20, "thermal_barns": 580.0, "fast_barns": 1.2,
                         "nu": 4, "precursors": 2, "delayed_incident": 2, "delayed_outgoing": 10}},
    "u238": {"zaid": 92238, "awr": 236.006, "n_base": 60, "resonances": 1, "levels": 2, "level_mev": [0.0449, 1.2],
             "sigma_el_base": 10.0, "angular_tables": 3,
             "continuum": [{"mt": 16, "law": 44, "frame": "cm", "multiplicity": 2, "threshold_mev": 6.2,
                            "incident": 3, "outgoing": 10}],
             "fission": {"laws": [9, 11], "incident": 3, "restriction_mev": -20.0, "threshold_mev": 1.0,
                         "fast_barns": 0.55, "nu": 4, "precursors": 2, "delayed_incident": 2,
                         "delayed_outgoing": 10}},
    "be9": {"zaid": 4009, "awr": 8.935, "n_base": 60, "resonances": 0, "levels": 0, "sigma_el_base": 6.0,
            "angular_tables": 3,
            "continuum": [{"mt": 16, "law": 61, "frame": "cm", "multiplicity": 2, "threshold_mev": 1.85,
                           "incident": 3, "outgoing": 8, "cosines": 5},
                          {"mt": 22, "law": 61, "frame": "lab", "multiplicity": 1, "threshold_mev": 2.5,
                           "incident": 3, "outgoing": 8, "cosines": 5}]},
    "h2": {"zaid": 1002, "awr": 1.9968, "n_base": 60, "resonances": 0, "levels": 0, "sigma_el_base": 3.4,
           "angular_tables": 3,
           "continuum": [{"mt": 16, "law": 66, "frame": "cm", "multiplicity": 2, "threshold_mev": 3.339,
                          "npsx": 3, "ap": 2.9968}]},
}


def continuum_fission(nuclides=("u235", "u238", "be9", "h2")) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the small deck, for run_cell."""
    config = {"name": "small-continuum-fission", "run": dict(RUN),
              "tolerance": {"rtol": 1e-08, "from": "BASELINE.json's 1e-8 at each row's scale"},
              "catalog": copy.deepcopy({k: CATALOG[k] for k in nuclides})}
    traffic = {"deck": list(nuclides), "warmup": {"nuclides": list(nuclides), "n_base": 30},
               "check": {"nuclides": len(nuclides), "rows": 4}}
    cell = {"name": "small-continuum-fission", "config": config["name"], "traffic": "small-continuum-fission",
            "chips": 1, "why": "the CPU tests' continuum and fission deck"}
    return cell, config, traffic
