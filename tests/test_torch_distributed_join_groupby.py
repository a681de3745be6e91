"""Shuffle joins feeding sort-mode grouping and the group exchange on 4
gloo ranks on the CPU, against the JAX package's DistributedExecutor on 4
of the conftest's virtual devices: a unique-key build and a duplicate-key
(N:M) build, each the same rows in the same order with the same buckets,
output capacities and carry slots.  Mirrors tests/test_distributed_joins.py.
"""

from torch_world_helpers import check_case, world_fixture

world = world_fixture()


def test_shuffle_join_into_groupby(world):
    """A shuffle join feeding sort-mode grouping and the group exchange."""
    got, _ = check_case(world, "shuffle_join_into_groupby")
    assert got["after"]["segments"] == 1 and got["after"]["kind"] == "sort_agg_exchange"


def test_nm_shuffle_join_into_groupby(world):
    got, _ = check_case(world, "nm_into_groupby")
    assert got["after"]["expansion"] == [True] and got["after"]["kind"] == "sort_agg_exchange"
