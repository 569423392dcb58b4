"""cm_inner_kernel's share (%) of its roofline: the least time the card
could take for the CM inner integrals of the continuum calls that
completed in the window (benchmark/harness/work_cm.py, counted from their
rows), over the kernel's device time in those calls."""

from benchmark.harness import work, work_cm


def on_call(span, args, result, run):
    """Each batched_continuum_moments call: its work, from the rows it was given."""
    if span.name != "family.continuum":
        return
    nuc, rxn_rows, gs, order, cfg = args[:5]
    flops, nbytes = work_cm.continuum_call_work(nuc, rxn_rows, gs.bounds, order, cfg.clamp_outside)
    if flops > 0:
        run.kernel_calls.setdefault("cm_inner", []).append((span.t0, span.t1, flops, nbytes))


def read(run):
    calls = [c for c in run.kernel_calls.get("cm_inner", []) if c[0] >= 0.0 and c[1] <= run.window_s]
    t_kernel = sum(run.kernel_seconds("cm_inner", a, b) for a, b, _, _ in calls)
    if not calls or t_kernel <= 0:
        return None
    peaks = work.peaks_for(run.device_name)
    flops, nbytes = sum(c[2] for c in calls), sum(c[3] for c in calls)
    t_bound, side = work.bound_seconds(flops, nbytes, peaks)
    run.notes.append(f"kernel.cm_inner.roofline bound_by {side} flops {flops} bytes {nbytes} "
                     f"bound_s {t_bound} kernel_s {t_kernel} calls {len(calls)}")
    return 100.0 * t_bound / t_kernel
