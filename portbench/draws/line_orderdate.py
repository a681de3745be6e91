"""Each line's order date."""

import torch


def make(g):
    return torch.repeat_interleave(g.shared("orderdate"), g.shared("lines"))
