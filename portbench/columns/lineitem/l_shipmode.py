"""lineitem.l_shipmode: ship mode, uniform over 7."""

import torch

from ...datagen import SHIPMODES

TYPE = "VARCHAR"
CATEGORIES = SHIPMODES


def make(g):
    return (g.draw("lineitem", "shipmode", 0, 6, g.lines_total()) + 1).to(torch.int32)
