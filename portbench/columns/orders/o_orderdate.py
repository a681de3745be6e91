"""orders.o_orderdate: order date, uniform in [STARTDATE, ENDDATE - 151]."""

import torch

TYPE = "DATE"
CATEGORIES = None


def make(g):
    return g.shared("orderdate").to(torch.int32)
