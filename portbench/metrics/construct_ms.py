"""Mean ms a query spends constructing its executor (``LocalExecutor.__init__``:
plan rewrites, linearisation, the join build sides scanned and uploaded from
host tables, the piece-path decision), over the profiled stretch; each span
is closed by a device synchronisation."""


def read(run):
    spans = [q.construct_s for q in run.profiled()]
    return sum(spans) / len(spans) * 1e3 if spans else None
