"""Duplicate-key (N:M) shuffle joins on 4 gloo ranks on the CPU, against
the JAX package's DistributedExecutor on 4 of the conftest's virtual
devices.

Mirrors the N:M collect tests of tests/test_distributed_joins.py (INNER
and LEFT expansion joins, an expansion past its 2x output bucket that
re-probes, a 90 % skewed probe, the LEFT + non-equi filter re-planned
through uid / inner / left): the same rows in the same order, the same
buckets and output capacities after the same re-probes.  Its expansion into
grouping is in test_torch_distributed_join_groupby.py.
"""

import pytest

from torch_world_helpers import check_case, world_fixture

world = world_fixture()


@pytest.mark.parametrize("join_type", ["inner", "left"])
def test_nm_shuffle_join_matches_reference(world, join_type):
    got, _ = check_case(world, f"nm_{join_type}")
    assert got["after"]["expansion"] == [True], "a duplicate-key build takes the expansion path"


def test_nm_shuffle_join_expansion_overflow_reprobes(world):
    """High multiplicity pushes a rank's expansion total past the default 2x
    output bucket: every rank re-probes the exact sizes and runs again."""
    got, _ = check_case(world, "nm_expansion_overflow")
    assert got["after"]["sjoin_outcaps"] != got["before"]["sjoin_outcaps"]
    assert got["reprobes"] == 1


def test_nm_shuffle_join_skewed(world):
    check_case(world, "nm_skewed")


def test_nm_left_filter_replans_distributed(world):
    """LEFT + non-equi filter over an N:M build re-plans (uid / inner / left)
    instead of nulling per expanded row."""
    check_case(world, "nm_left_filter")
