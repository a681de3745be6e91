"""Q3, except that from its second plan on (the first is set-up's warm
query) rank 1 hands its executor no plan: the query raises on rank 1 alone,
while the other ranks wait for it in the program's collectives."""

import torch.distributed as dist

from portbench.queries.q3 import TABLES  # noqa: F401
from portbench.queries.q3 import build as q3_build

_built = 0


def build(tables, p):
    global _built
    _built += 1
    plan = q3_build(tables, p)
    return None if _built > 1 and dist.get_rank() == 1 else plan
