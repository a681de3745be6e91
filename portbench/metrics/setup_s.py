"""Seconds from the start of the process to the start of the window: Python
and torch, CUDA, the data made and copied to host tables, the resident tiles
uploaded, the kernels built or loaded and one warm query of each kind."""


def read(run):
    return run.setup_s
