"""Microseconds in AsciiLibraryWriter.write_nuclide per scatter value it
wrote, over the calls that ended in the window."""


def read(run):
    calls = [s for s in run.spans_named("write_nuclide") if s.t1 <= run.window_s and s.moments]
    n = sum(s.moments for s in calls)
    return 1e6 * sum(s.t1 - s.t0 for s in calls) / n if n else None
