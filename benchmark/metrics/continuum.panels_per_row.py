"""Outer w-panels the CM path integrated per CM row, over the
batched_continuum_moments calls that ended in the window: the program's
RunMetrics counters continuum_outer_panels and continuum_rows (keyed by
(ENDF law, frame)), read through the call's `metrics` argument. A program
without those counters reads nothing."""

# id of a pass's RunMetrics -> (that RunMetrics, (panels, CM rows) it held
# after the last call seen); holding it keeps its id from being reused
_SEEN: dict[int, tuple[object, tuple[int, int]]] = {}


def _totals(metrics) -> tuple[int, int] | None:
    panels = getattr(metrics, "continuum_outer_panels", None)
    rows = getattr(metrics, "continuum_rows", None)
    if panels is None or rows is None:
        return None
    return sum(panels.values()), sum(n for (_, frame), n in rows.items() if frame == "cm")


def on_call(span, args, result, run):
    """The counters' growth over one call."""
    if span.name != "family.continuum" or len(args) < 7 or args[6] is None:
        return
    now = _totals(args[6])
    if now is None:
        return
    _, before = _SEEN.get(id(args[6]), (None, (0, 0)))
    _SEEN[id(args[6])] = (args[6], now)
    run.kernel_calls.setdefault("continuum_panels", []).append(
        (span.t0, span.t1, now[0] - before[0], now[1] - before[1]))


def read(run):
    calls = [c for c in run.kernel_calls.get("continuum_panels", []) if c[0] >= 0.0 and c[1] <= run.window_s]
    rows = sum(c[3] for c in calls)
    return sum(c[2] for c in calls) / rows if rows else None
