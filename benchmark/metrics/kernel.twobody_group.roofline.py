"""twobody_group_kernel's share (%) of its roofline: the least time the
card could take for the work of the two-body calls that completed in the
window (benchmark/harness/work.py, counted from their rows), over the
kernel's device time in those calls."""

from benchmark.harness import work


def on_call(span, args, result, run):
    """Each pooled two-body dispatch: its work, from the rows it was given."""
    if span.name != "family.twobody":
        return
    preps, bounds, order, nq, _, _, clamp, _ = args
    flops, nbytes = work.twobody_call_work(preps, bounds, order, nq, clamp)
    run.kernel_calls.setdefault("twobody_group", []).append((span.t0, span.t1, flops, nbytes))


def read(run):
    calls = [c for c in run.kernel_calls.get("twobody_group", []) if c[0] >= 0.0 and c[1] <= run.window_s]
    t_kernel = sum(run.kernel_seconds("twobody_group", a, b) for a, b, _, _ in calls)
    if not calls or t_kernel <= 0:
        return None
    peaks = work.peaks_for(run.device_name)
    flops, nbytes = sum(c[2] for c in calls), sum(c[3] for c in calls)
    t_bound, side = work.bound_seconds(flops, nbytes, peaks)
    run.notes.append(f"kernel.twobody_group.roofline bound_by {side} flops {flops} bytes {nbytes} "
                     f"bound_s {t_bound} kernel_s {t_kernel} calls {len(calls)}")
    return 100.0 * t_bound / t_kernel
