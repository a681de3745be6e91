"""Receipt dates, 1-30 days after shipping."""

def make(g):
    off = g.draw("lineitem", "receiptdate", 1, 30, g.lines_total())
    return g.shared("shipdate") + off
