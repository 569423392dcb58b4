"""Kernel launches on the card in the window other than the three hand
kernels (the torch ops around them), per thousand scatter values that
reached the library."""

HAND = ("twobody_group_kernel", "freegas_sab_kernel", "cm_inner_kernel")


def read(run):
    if not run.device_events or not run.moments:
        return None
    n = sum(1 for a, b, name, cat in run.device_events if cat == "kernel" and not any(h in name for h in HAND))
    return 1000.0 * n / run.moments
