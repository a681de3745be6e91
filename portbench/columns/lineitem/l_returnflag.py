"""lineitem.l_returnflag: R or A by a coin once received by CURRENTDATE, N after it."""

import torch

from ...datagen import CURRENTDATE, RETURNFLAGS

TYPE = "VARCHAR"
CATEGORIES = RETURNFLAGS


def make(g):
    coin = g.draw("lineitem", "returnflag", 0, 1, g.lines_total())
    received = g.shared("receiptdate") <= CURRENTDATE
    return (torch.where(received, coin, 2) + 1).to(torch.int32)
