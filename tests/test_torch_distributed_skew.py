"""A skewed grouping distributed on 4 gloo ranks on the CPU, against the
JAX package's DistributedExecutor on 4 of the conftest's virtual devices:
90 % of the rows fall on few ranks, whose undersized carry grows 4x and
retries on every rank (tests/test_distributed_joins.py).  The same rows in
the same order, the same carry slots after the same retries.
"""

from torch_world_helpers import check_case, world_fixture

world = world_fixture()


def test_skewed_groupby_grows_carry_and_completes(world):
    """The skew concentrates whole groups on one rank; the carry starts
    deliberately undersized (32 slots) and every rank grows it 4x and
    retries together, to the JAX package's size."""
    got, ref = check_case(world, "skewed_groupby_grows_carry")
    assert got["before"]["carry_rows"] == 32
    assert got["after"]["carry_rows"] == ref._carry_rows > 32
    assert got["carry_retries"] >= 1
