"""lineitem.l_extendedprice: quantity x the retail price of a part drawn uniformly."""

from ...datagen import DEC, retail_price_cents

TYPE = DEC
CATEGORIES = None


def make(g):
    partkey = g.draw("lineitem", "partkey", 1, g.n_parts, g.lines_total())
    return g.shared("quantity") * retail_price_cents(partkey)
