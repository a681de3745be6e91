"""Rows of every base table the completed queries scan, counted before
filters, over the whole window."""


def read(run):
    rows = sum(q.rows for q in run.completed())
    return rows / run.window_s if rows else None
