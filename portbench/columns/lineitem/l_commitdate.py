"""lineitem.l_commitdate: commit date, 30-90 days after the order."""

import torch

TYPE = "DATE"
CATEGORIES = None


def make(g):
    return g.shared("commitdate").to(torch.int32)
