"""Share of the window (%) the writer thread spends in
AsciiLibraryWriter.write_nuclide."""


def read(run):
    busy = sum(max(0.0, min(s.t1, run.window_s) - max(s.t0, 0.0)) for s in run.spans_named("write_nuclide"))
    return 100.0 * busy / run.window_s if run.window_s > 0 else None
