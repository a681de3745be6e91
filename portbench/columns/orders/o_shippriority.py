"""orders.o_shippriority: ship priority, 0."""

import torch

TYPE = "INTEGER"
CATEGORIES = None


def make(g):
    return torch.zeros(g.n_orders, dtype=torch.int32, device=g.device)
