"""Microseconds of host parse and preparation (read_ace, read_thermal_ace,
prepare_twobody, prepare_continuum, prepare_thermal, as the driver modules
call them) in the window, per scatter value that reached the library."""


def read(run):
    busy = sum(max(0.0, min(s.t1, run.window_s) - max(s.t0, 0.0)) for s in run.spans_named("parse", "host.prep"))
    return 1e6 * busy / run.moments if run.moments else None
