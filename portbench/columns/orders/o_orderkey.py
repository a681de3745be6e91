"""orders.o_orderkey: sparse order keys: 8 used of every 32."""

import torch

from ...datagen import sparse_orderkey

TYPE = "BIGINT"
CATEGORIES = None


def make(g):
    return sparse_orderkey(torch.arange(g.n_orders, device=g.device))
