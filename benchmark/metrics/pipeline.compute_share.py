"""Share of the window (%) the main thread spends in
driver._process_with_oom_retry (a nuclide's compute), the tracer's own
work taken out."""


def read(run):
    busy = sum(max(0.0, min(s.t1, run.window_s) - max(s.t0, 0.0)) - s.overhead for s in run.spans_named("compute"))
    return 100.0 * busy / run.window_s if run.window_s > 0 else None
