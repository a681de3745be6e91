"""lineitem.l_linestatus: O once shipped after CURRENTDATE, F before."""

import torch

from ...datagen import CURRENTDATE, LINESTATUSES

TYPE = "VARCHAR"
CATEGORIES = LINESTATUSES


def make(g):
    return (g.shared("shipdate") > CURRENTDATE).to(torch.int32) + 1
