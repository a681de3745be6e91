"""orders.o_custkey: a customer whose key is not a multiple of 3, uniformly."""

TYPE = "BIGINT"
CATEGORIES = None


def make(g):
    placing = g.n_customers - g.n_customers // 3
    cand = g.draw("orders", "custkey", 0, placing - 1, g.n_orders)
    return cand + cand // 2 + 1
