"""Microseconds of self time of the family drivers (_tiled_twobody_multi,
batched_continuum_moments, apply_freegas, apply_sab, chi_collapse; the host
preparation and family calls nested in them taken out) in the window, per
scatter value that reached the library: enqueue, lock waits, device waits
and landing of results."""

FAMILIES = ("family.twobody", "family.continuum", "family.freegas", "family.sab", "family.chi")


def read(run):
    spans = [s for s in run.spans_named(*FAMILIES) if s.t0 >= 0.0 and s.t1 <= run.window_s]
    return 1e6 * sum(s.self_s for s in spans) / run.moments if run.moments else None
