"""orders.o_orderpriority: priority, uniform over 5."""

import torch

from ...datagen import PRIORITIES

TYPE = "VARCHAR"
CATEGORIES = PRIORITIES


def make(g):
    return (g.draw("orders", "priority", 0, 4, g.n_orders) + 1).to(torch.int32)
