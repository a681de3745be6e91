"""Shuffle joins, distributed collects and the carry's growth on 4 gloo
ranks on the CPU, against the JAX package's DistributedExecutor on 4 of the
conftest's virtual devices.

Mirrors the 1:1 collect tests of tests/test_distributed_joins.py
(hash-partitioned builds with a probe-row exchange for INNER / LEFT /
LEFT_SEMI / ANTI, broadcast chosen for a small build, a duplicate-key semi
build, a collect pipeline, a multi-key shuffle join) and the exchange
overflow re-probe of tests/test_distributed.py: the same rows in the same
order, the same buckets after the same re-probes.  Its joins into grouping are in
test_torch_distributed_join_groupby.py, its skewed grouping in
test_torch_distributed_skew.py and its N:M half in
test_torch_distributed_nm.py.
"""

import numpy as np
import pytest

from torch_world_helpers import check_case, world_fixture

world = world_fixture()


@pytest.mark.parametrize("join_type", ["inner", "left", "left_semi", "anti"])
def test_shuffle_join_collect_matches_reference(world, join_type):
    got, _ = check_case(world, f"shuffle_{join_type}")
    assert got["after"]["segments"] == 1, "expected a shuffle-join segment"
    assert got["after"]["kind"] == "collect"


def test_broadcast_chosen_for_small_build(world):
    got, _ = check_case(world, "broadcast_small_build")
    assert got["after"]["segments"] == 0, "small build must broadcast"


def test_duplicate_build_semi_shuffles(world):
    """A semi join deduplicates its build, so a duplicate-key build shuffles."""
    got, _ = check_case(world, "duplicate_build_semi")
    assert got["after"]["segments"] == 1 and got["after"]["expansion"] == [False]


def test_distributed_collect_filter_project(world):
    got, _ = check_case(world, "collect_filter_project")
    assert got["after"]["kind"] == "collect" and got["result"].num_rows > 0


def test_shuffle_join_multi_key(world):
    got, _ = check_case(world, "shuffle_join_multi_key")
    assert got["after"]["segments"] == 1


def test_exchange_overflow_reprobe(world):
    """A deliberately undersized shuffle bucket on skewed keys trips the
    overflow counter on one rank; every rank re-probes the exact per-source
    maxima (the two-phase protocol) and retries, as the JAX package does."""
    got, ref = check_case(world, "exchange_overflow_reprobe")
    assert got["before"]["sjoin_buckets"] == [32]
    assert got["reprobes"] == 1
    rng = np.random.default_rng(11)
    keys = np.where(rng.random(4096) < 0.9, 7, rng.integers(0, 4000, 4096))
    hot = int((keys == 7).sum())
    assert got["after"]["sjoin_buckets"][0] >= min(hot, 512)
