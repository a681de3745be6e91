"""The 22 TPC-H plans distributed, part f of eleven: plan 8.

Mirrors tests/test_distributed_tpch.py, which holds the JAX package's
distributed rows to its local ones: here the port's DistributedExecutor on
4 gloo ranks on the CPU (every rank maps the same tables, shared once as
files) is held to the JAX package's LocalExecutor at SF 0.01, the same rows
in the same order (integers, dates and strings exactly, DOUBLE to rtol
1e-9).  The plans are split over eleven files by the JAX package's time,
so that each file stays well inside the tier-1 budget.
"""

import pytest

from torch_world_helpers import check_tpch, world_fixture

world = world_fixture()


@pytest.mark.parametrize("num", [8])
def test_tpch_distributed_matches_reference_local(world, num):
    check_tpch(world, num)
