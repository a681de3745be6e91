"""lineitem.l_orderkey: each line's order key."""

import torch

from ...datagen import sparse_orderkey

TYPE = "BIGINT"
CATEGORIES = None


def make(g):
    keys = sparse_orderkey(torch.arange(g.n_orders, device=g.device))
    return torch.repeat_interleave(keys, g.shared("lines"))
