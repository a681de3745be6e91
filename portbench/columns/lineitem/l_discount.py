"""lineitem.l_discount: discount 0-10 %, DECIMAL(12,2) unscaled."""

from ...datagen import DEC

TYPE = DEC
CATEGORIES = None


def make(g):
    return g.draw("lineitem", "discount", 0, 10, g.lines_total())
