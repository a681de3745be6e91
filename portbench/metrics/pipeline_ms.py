"""Mean ms a query spends in ``LocalExecutor.run`` over its resident tiles
(expressions, probe, grouping, TopN, the fetch of the result), over the
profiled stretch; each span is closed by a device synchronisation."""


def read(run):
    spans = [q.pipeline_s for q in run.profiled()]
    return sum(spans) / len(spans) * 1e3 if spans else None
