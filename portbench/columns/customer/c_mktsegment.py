"""customer.c_mktsegment: market segment, uniform over 5."""

import torch

from ...datagen import SEGMENTS

TYPE = "VARCHAR"
CATEGORIES = SEGMENTS


def make(g):
    return (g.draw("customer", "segment", 0, 4, g.n_customers) + 1).to(torch.int32)
