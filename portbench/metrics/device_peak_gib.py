"""``torch.cuda.max_memory_allocated()`` over the window, after a reset at its
start, in GiB: the resident tiles and everything the queries allocate."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2**30
