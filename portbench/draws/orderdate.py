"""Order dates, uniform in [STARTDATE, ENDDATE - 151]."""

from ..datagen import ENDDATE, STARTDATE


def make(g):
    return g.draw("orders", "orderdate", STARTDATE, ENDDATE - 151, g.n_orders)
