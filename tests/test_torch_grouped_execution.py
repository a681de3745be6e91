"""Grouped (bucketed) execution over split groups in the port.

Mirrors ``tests/test_grouped_execution.py`` (split groups and a grouped run,
checkpoint and restart, ``concat_tables``) on the same dataset, each result
held to the JAX package's ``GroupedExecution`` over the same files; then a
group whose result holds NULLs through a checkpoint (the port's parquet
keeps them; the JAX package's writer drops the validity, so its restored
rows read 0 — ``ROADMAP.md`` Queue 3), and two groups at once against one at
a time.  Integers exact."""

import numpy as np
import pytest

from velox_tpu.exec.grouped import GroupedExecution as RefGrouped
from velox_tpu.exec.grouped import split_groups as ref_split_groups
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu_torch.connectors.hive import write_table
from velox_tpu_torch.exec.grouped import GroupedExecution, concat_tables, split_groups
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.utils import testvalue


def make_dataset(tmp_path, v_valid=None):
    regions = ["", "eu", "us", "ap"]
    t = table_from_numpy(
        ["region", "k", "v"], ["VARCHAR", "BIGINT", "BIGINT"],
        {"region": np.array([1, 1, 2, 2, 3, 3], np.int32),
         "k": np.array([1, 2, 1, 2, 1, 1], np.int64),
         "v": np.array([10, 20, 30, 40, 50, 60], np.int64)},
        {"region": regions},
        None if v_valid is None else {"v": np.asarray(v_valid)},
    )
    root = str(tmp_path / "ds")
    write_table(root, t, partition_by=["region"])
    return root


def make_plan(builder):
    return lambda table: (
        builder().table_scan(table).aggregation(["region", "k"], ["sum(v) as s"]).build()
    )


def rows(table):
    df = table.to_pandas().sort_values(["region", "k"])
    return [(r, int(k), None if s is None or s != s else int(s))
            for r, k, s in df.itertuples(index=False)]


def test_split_groups_and_grouped_run(tmp_path):
    root = make_dataset(tmp_path)
    groups = split_groups(root)
    assert [k for k, _ in groups] == ["region=ap", "region=eu", "region=us"]
    runs = []
    with testvalue.scoped("GroupedExecution::runGroup", runs.append):
        ge = GroupedExecution(make_plan(PlanBuilder), groups, concurrent_groups=2, device="cpu")
        out = ge.run()
    assert sorted(runs) == ["region=ap", "region=eu", "region=us"]
    assert rows(out) == [("ap", 1, 110), ("eu", 1, 10), ("eu", 2, 20), ("us", 1, 30),
                         ("us", 2, 40)]
    assert ge.groups_run == 3
    ref = RefGrouped(make_plan(RefBuilder), ref_split_groups(root), concurrent_groups=2).run()
    assert rows(out) == rows(ref)


def test_checkpoint_restart(tmp_path):
    root = make_dataset(tmp_path)
    groups = split_groups(root)
    ckpt = str(tmp_path / "ckpt")

    # first attempt: the 'us' group fails after the others complete
    def boom(key):
        if key == "region=us":
            raise RuntimeError("injected group failure")

    ge1 = GroupedExecution(make_plan(PlanBuilder), groups, concurrent_groups=1,
                           checkpoint_dir=ckpt, device="cpu")
    with testvalue.scoped("GroupedExecution::runGroup", boom):
        with pytest.raises(RuntimeError):
            ge1.run()

    # restart: finished groups restore from checkpoints; only 'us' runs again
    runs = []
    with testvalue.scoped("GroupedExecution::runGroup", runs.append):
        ge2 = GroupedExecution(make_plan(PlanBuilder), groups, concurrent_groups=1,
                               checkpoint_dir=ckpt, device="cpu")
        out = ge2.run()
    assert ge2.groups_run == 1 and runs == ["region=us"]  # the elastic-restart unit
    assert [r[2] for r in rows(out)] == [110, 10, 20, 30, 40]


def test_concat_tables_remaps_dictionaries():
    a = table_from_numpy(["s"], ["VARCHAR"], {"s": np.array([1, 2], np.int32)},
                         {"s": ["", "x", "y"]})
    b = table_from_numpy(["s"], ["VARCHAR"], {"s": np.array([1, 2], np.int32)},
                         {"s": ["", "y", "z"]})
    out = concat_tables([a, b]).to_pandas()
    assert out["s"].tolist() == ["x", "y", "y", "z"]


def test_checkpoint_keeps_null_results(tmp_path):
    """A group whose sum is NULL (every v NULL) restores from its checkpoint
    as NULL: the expected rows.  The JAX package's parquet writer drops the
    validity, so its restored rows read 0 there (Queue 3)."""
    root = make_dataset(tmp_path, v_valid=[True, True, False, False, True, True])
    want = [("ap", 1, 110), ("eu", 1, 10), ("eu", 2, 20), ("us", 1, None), ("us", 2, None)]
    ckpt = str(tmp_path / "ckpt")
    for attempt in range(2):
        ge = GroupedExecution(make_plan(PlanBuilder), split_groups(root), checkpoint_dir=ckpt,
                              device="cpu")
        assert rows(ge.run()) == want
        assert ge.groups_run == (3 if attempt == 0 else 0)
    ref_ckpt = str(tmp_path / "ref_ckpt")
    ref_rows = []
    for _ in range(2):
        ref_rows.append(rows(RefGrouped(make_plan(RefBuilder), ref_split_groups(root),
                                        checkpoint_dir=ref_ckpt).run()))
    assert ref_rows[0] == want
    assert ref_rows[1] == [r if r[2] is not None else (r[0], r[1], 0) for r in want]


def test_concurrent_groups_give_the_same_rows(tmp_path):
    """Groups in flight together give the rows of one group at a time."""
    rng = np.random.default_rng(3)
    n = 4000
    t = table_from_numpy(
        ["p", "k", "v"], ["BIGINT", "BIGINT", "BIGINT"],
        {"p": rng.integers(0, 6, n), "k": rng.integers(0, 50, n), "v": rng.integers(-9, 9, n)},
    )
    root = str(tmp_path / "ds")
    write_table(root, t, partition_by=["p"])

    def plan(table):
        return PlanBuilder().table_scan(table).aggregation(["p", "k"], ["sum(v) as s"]).build()

    groups = split_groups(root)
    outs = [GroupedExecution(plan, groups, concurrent_groups=c, tile_rows=256,
                             device="cpu").run().to_pandas().sort_values(["p", "k"])
            for c in (1, 4)]
    assert outs[0].values.tolist() == outs[1].values.tolist()
    assert int(outs[0]["s"].sum()) == int(np.asarray(t.columns["v"]).sum())
