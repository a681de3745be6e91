"""Ship dates, 1-121 days after the order."""

def make(g):
    off = g.draw("lineitem", "shipdate", 1, 121, g.lines_total())
    return g.shared("line_orderdate") + off
