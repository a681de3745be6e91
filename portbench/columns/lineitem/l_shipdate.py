"""lineitem.l_shipdate: ship date, 1-121 days after the order."""

import torch

TYPE = "DATE"
CATEGORIES = None


def make(g):
    return g.shared("shipdate").to(torch.int32)
