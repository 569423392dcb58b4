"""Seconds from the process's start to the window's opening: imports, the
CUDA context, the kernel libraries (built on a checkout's first run), the
deck made from the seed, and the warm-up pass."""


def read(run):
    return run.setup_s
