"""lineitem.l_receiptdate: receipt date, 1-30 days after shipping."""

import torch

TYPE = "DATE"
CATEGORIES = None


def make(g):
    return g.shared("receiptdate").to(torch.int32)
