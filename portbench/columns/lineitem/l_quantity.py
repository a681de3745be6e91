"""lineitem.l_quantity: quantity 1-50, DECIMAL(12,2) unscaled."""

from ...datagen import DEC

TYPE = DEC
CATEGORIES = None


def make(g):
    return g.shared("quantity") * 100
