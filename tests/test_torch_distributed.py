"""Distributed execution of the port on 4 gloo ranks on the CPU, against the
JAX package's DistributedExecutor on 4 of the conftest's virtual devices.

Mirrors the TPC-H tests of tests/test_distributed.py (Q6, Q1 and Q3): the
same rows in the same order, the same carry slots.  The other tests of that
file are in test_torch_distributed_grouping.py (sort-mode grouping),
test_torch_distributed_skew.py (the carry's growth, the exchange re-probe)
and test_torch_distributed_exchange.py (the exchange functions).
"""

import pytest

from torch_world_helpers import check_case, world_fixture

world = world_fixture()


@pytest.mark.parametrize("name", ["q6", "q1", "q3"])
def test_tpch_distributed_matches_reference(world, name):
    """Q6 and Q1 (direct_agg over broadcast-free pipelines) and Q3 (a join
    feeding sort-mode grouping through the group exchange)."""
    got, ref = check_case(world, name)
    assert got["after"]["kind"] == ("sort_agg_exchange" if name == "q3" else "direct_agg")
