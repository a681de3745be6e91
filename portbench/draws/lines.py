"""Lines an order, uniform in 1-7."""

def make(g):
    return g.draw("orders", "lines", 1, 7, g.n_orders)
