"""customer.c_custkey: customer keys 1..n."""

import torch

TYPE = "BIGINT"
CATEGORIES = None


def make(g):
    return torch.arange(1, g.n_customers + 1, device=g.device)
