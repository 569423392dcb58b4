"""Scatter values (NT x NE x (L+1) x G a nuclide) that reached the library
in the window, whole nuclides by their end_nuclide marker and the nuclide in
progress by its scatter lines, over the window's length."""


def read(run):
    return run.moments / run.window_s if run.window_s > 0 else None
