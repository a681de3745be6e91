"""Share of the profiled stretch in which no kernel, copy or fill ran on the
card: 1 - (union of the device intervals) / (the stretch), in %."""


def read(run):
    prof = run.profile
    if prof is None or prof.window_s <= 0:
        return None
    busy = prof.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / prof.window_s)
