"""Seconds from the process's start to the window's start: imports, the
card's context, the kernel library's load (and build, the first time in a
checkout), the weights, the warm-up."""


def read(run):
    return run.setup_s
