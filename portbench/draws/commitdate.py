"""Commit dates, 30-90 days after the order."""

def make(g):
    off = g.draw("lineitem", "commitdate", 30, 90, g.lines_total())
    return g.shared("line_orderdate") + off
