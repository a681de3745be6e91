"""lineitem.l_tax: tax 0-8 %, DECIMAL(12,2) unscaled."""

from ...datagen import DEC

TYPE = DEC
CATEGORIES = None


def make(g):
    return g.draw("lineitem", "tax", 0, 8, g.lines_total())
