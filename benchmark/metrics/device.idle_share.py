"""Share of the window (%) in which no kernel, copy or memset ran on the
card: 1 minus the union of their intervals (torch.profiler)."""

from benchmark.harness import trace


def read(run):
    if not run.device_events:
        return None
    busy = trace.union([(a, b) for a, b, _, _ in run.device_events])
    return 100.0 * (1.0 - trace.clipped_total(busy, 0.0, run.window_s) / run.window_s)
