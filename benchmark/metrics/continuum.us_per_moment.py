"""Microseconds in batched_continuum_moments (the family.continuum spans
that ended in the window, counted whole: host preparation, dispatch and
device waits nested in them included) per scatter value that reached the
library."""


def read(run):
    spans = [s for s in run.spans_named("family.continuum") if s.t0 >= 0.0 and s.t1 <= run.window_s]
    if not spans or not run.moments:
        return None
    return 1e6 * sum(s.t1 - s.t0 for s in spans) / run.moments
