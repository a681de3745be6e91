"""Memory pools, arbitration and the spill of the host merge in the port.

Mirrors ``tests/test_memory.py`` (pool limits and arbitration, the spiller's
round trip, a query with a forced spill, the executor's reservations, the
carry's fallback to the host merge under a tight budget, the data cache as
the first thing reclaimed) on the same numpy inputs, each query's rows held
to the JAX package's (integers exact), and each path to its injection point
(``utils/testvalue.py``).  The budget of the tight-limit test is computed
from the port's own reservations, as the JAX test computes it from the JAX
package's."""

import numpy as np
import pytest
import torch

import velox_tpu as vt
from velox_tpu.exec.memory import Spiller as RefSpiller
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu_torch.config import QueryConfig
from velox_tpu_torch.exec.memory import (
    MemoryPool,
    MemoryPoolError,
    Spiller,
    device_tree_bytes,
    table_nbytes,
)
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.utils import reporter, testvalue


def _pair(cols):
    """(JAX Table, port Table) of the same BIGINT numpy columns."""
    names = list(cols)
    ref = RefTable(vt.RowType(names, [vt.BIGINT] * len(names)), dict(cols))
    return ref, table_from_numpy(names, ["BIGINT"] * len(names), cols)


def _frame_rows(table, keys):
    df = table.to_pandas()
    return [tuple(int(v) for v in r) for r in df.sort_values(keys).itertuples(index=False)]


def test_pool_hierarchy_and_limits():
    root = MemoryPool("root", limit=1000)
    op1 = root.add_child("agg")
    op2 = root.add_child("join")
    op1.reserve(400)
    op2.reserve(500)
    assert root.reserved == 900
    with pytest.raises(MemoryPoolError):
        op1.reserve(200)
    op2.release(500)
    op1.reserve(200)
    assert root.peak == 900
    assert "agg" in root.usage_tree()


def test_arbitration_reclaims():
    root = MemoryPool("root", limit=1000)
    op = root.add_child("agg")
    op.reserve(900)

    def reclaimer(target):
        freed = op.reserved  # spill: release everything
        op.release(freed)
        return freed

    op.add_reclaimer(reclaimer)
    op.reserve(500)  # arbitration instead of failing
    assert op.reserved == 500


def test_spiller_roundtrip(tmp_path):
    """Pages restore in spill order, and their bytes are the JAX package's
    spiller's bytes for the same table; the reporter's spilled-bytes counter
    grows by the bytes written."""
    ref_t, t = _pair({"k": np.arange(100), "v": np.arange(100) * 3})
    sp = Spiller(str(tmp_path / "port"))
    (tmp_path / "port").mkdir()
    before = reporter.reporter().counter(reporter.METRIC_SPILLED_BYTES)
    sp.spill(t)
    sp.spill(t)
    assert sp.spilled_rows == 200
    report = sp.report()
    assert report["spill_files"] == 2 and report["spilled_bytes"] == sp.spilled_bytes
    spilled = reporter.reporter().counter(reporter.METRIC_SPILLED_BYTES) - before
    assert spilled == sp.spilled_bytes > 0
    back = list(sp.restore())
    assert len(back) == 2
    np.testing.assert_array_equal(back[0].columns["v"], t.columns["v"])
    (tmp_path / "ref").mkdir()
    ref = RefSpiller(str(tmp_path / "ref"))
    ref.spill(ref_t)
    with open(sp.files[0], "rb") as a, open(ref.files[0], "rb") as b:
        assert a.read() == b.read()
    sp.cleanup()
    ref.cleanup()
    assert not sp.files and table_nbytes(t) == 100 * 8 * 2


def test_device_tree_bytes():
    tree = (torch.zeros(10, dtype=torch.int64), [torch.zeros(3, dtype=torch.int32), None],
            {"a": torch.zeros(4, dtype=torch.bool)})
    assert device_tree_bytes(tree) == 80 + 12 + 4


def test_query_with_forced_spill_matches_no_spill():
    """kTestingSpillPct analog: force spilling and require the JAX package's
    rows; then a carry overflow falls back to the host merge."""
    rng = np.random.default_rng(5)
    n = 3000
    rt, pt = _pair({"k": rng.integers(0, 400, n), "v": rng.integers(-100, 100, n)})

    def make(builder, t):
        return (builder().table_scan(t)
                .aggregation(["k"], ["sum(v) as s", "count(*) as c"]).orderby(["k"]).build())

    want = RefExecutor(make(RefBuilder, rt), tile_rows=4096).run()
    spills = []
    with testvalue.scoped("Spiller::spill", spills.append):
        ex = LocalExecutor(make(PlanBuilder, pt), tile_rows=1024, device="cpu",
                           config=QueryConfig(spill_bytes_threshold=1, device_agg_merge=False))
        forced = ex.run()
    assert len(spills) == 3 and ex.spill_stats["spill_files"] == 3  # one a tile
    assert _frame_rows(forced, ["k"]) == _frame_rows(want, ["k"])
    # ~5000 distinct keys against a 1024-slot carry overflows the device
    # group merge; the executor falls back to the host merge
    rng2 = np.random.default_rng(6)
    n2, nkeys = 8000, 5000
    rt2, pt2 = _pair({"k": rng2.permutation(np.repeat(np.arange(nkeys), 2))[:n2],
                      "v": rng2.integers(-100, 100, n2)})
    want2 = RefExecutor(make(RefBuilder, rt2), tile_rows=1024).run()
    fired = []
    with testvalue.scoped("AggExecutor::carryOverflowFallback", fired.append):
        ex2 = LocalExecutor(make(PlanBuilder, pt2), tile_rows=1024, device="cpu")
        got2 = ex2.run()
    assert fired and ex2.carry_overflowed
    assert _frame_rows(got2, ["k"]) == _frame_rows(want2, ["k"])


def _join_agg(builder, probe, build, keys):
    return (
        builder().table_scan(probe)
        .hash_join(builder().table_scan(build), ["k"], ["bk"], output=["k", "v", "w"])
        .aggregation(keys, ["sum(v) as sv", "count(*) as c"])
        .build()
    )


def test_executor_reserves_join_build_and_tiles():
    """The executor reserves the join build and uploaded scan tiles against
    its query pool and releases the pool when it goes."""
    rng = np.random.default_rng(0)
    n = 4000
    _, probe = _pair({"k": rng.integers(0, 200, n), "v": rng.integers(0, 100, n)})
    _, build = _pair({"bk": np.arange(200), "w": np.arange(200)})
    ex = LocalExecutor(_join_agg(PlanBuilder, probe, build, ["k"]), tile_rows=1 << 12,
                       device="cpu")
    assert ex.pool.reserved > 0, "join build must be reserved"
    before = ex.pool.reserved
    tiles = ex.device_tiles()
    assert ex.pool.reserved > before, "scan tiles must be reserved"
    ex.run(prefetched_tiles=tiles)
    ex.__del__()
    assert ex.pool.parent is None  # detached, root released


def test_tight_limit_degrades_to_host_merge():
    """A join + aggregation under a budget that admits the build but not the
    device carry completes through the host merge (MemoryReclaimer
    contract), with the JAX package's rows."""
    rng = np.random.default_rng(1)
    n = 6000
    rp, pp = _pair({"k": rng.integers(0, 3000, n), "v": rng.integers(0, 100, n)})
    rb, pb = _pair({"bk": np.arange(3000), "w": np.arange(3000)})
    keys = ["k", "w"]
    want = RefExecutor(_join_agg(RefBuilder, rp, rb, keys), tile_rows=1 << 11).run()
    plan = _join_agg(PlanBuilder, pp, pb, keys)
    base = LocalExecutor(plan, tile_rows=1 << 11, device="cpu")
    need = base.pool.reserved  # the build's reservation
    base.run()
    assert base.pool.peak > need + (1 << 16)  # the carry needs more than the margin
    del base
    hits = []
    with testvalue.scoped("LocalExecutor::carryMemoryFallback", hits.append):
        ex = LocalExecutor(plan, tile_rows=1 << 11, device="cpu",
                           config=QueryConfig(query_memory_limit_bytes=need + (1 << 16)))
        got = ex.run()
    assert hits, "expected the carry reservation to fall back"
    assert ex.kind == "sort_agg_device" and ex.carry_groups is None
    assert _frame_rows(got, keys) == _frame_rows(want, keys)


def test_cache_reclaimer_frees_bytes(tmp_path):
    """Under pool pressure the arbitrator shrinks the data cache first."""
    from velox_tpu_torch.exec.memory import ROOT_POOL
    from velox_tpu_torch.io.cache import DEFAULT_CACHE

    t = table_from_numpy(["x"], ["BIGINT"], {"x": np.arange(200000, dtype=np.int64)})
    path = str(tmp_path / "t.parquet")
    t.save_parquet(path)
    DEFAULT_CACHE.clear()
    DEFAULT_CACHE.get_or_load(path)
    assert DEFAULT_CACHE.cached_bytes > 0
    limit_pool = ROOT_POOL.add_child("tight", limit=None)
    old_limit = ROOT_POOL.limit
    try:
        ROOT_POOL.limit = ROOT_POOL.reserved + (1 << 10)
        limit_pool.reserve(1 << 20)  # exceeds the root limit -> arbitration
        assert DEFAULT_CACHE.cached_bytes == 0, "cache must be evicted"
    finally:
        ROOT_POOL.limit = old_limit
        limit_pool.detach()


def test_partials_spill_roundtrip():
    """The host merge's spill unit keeps each partial column's dtype and bits
    through a page (integer and floating accumulators)."""
    rng = np.random.default_rng(9)
    n = 500
    t = table_from_numpy(["k", "v"], ["BIGINT", "DOUBLE"],
                         {"k": rng.integers(0, 50, n), "v": rng.random(n)})
    plan = (PlanBuilder().table_scan(t)
            .aggregation(["k"], ["sum(v) as s", "count(*) as c", "min(v) as m", "avg(v) as a"])
            .build())
    ex = LocalExecutor(plan, tile_rows=128, device="cpu").agg_exec
    keys = [np.arange(7, dtype=np.int64)]
    accs = [
        tuple(torch.arange(7).to(dt).numpy() for dt in agg.acc_dtypes) for agg in ex.aggs
    ]
    assert len({a.dtype for acc in accs for a in acc}) > 1
    sp = Spiller()
    sp.spill(ex.partials_to_table([keys], [accs]))
    [back] = list(sp.restore())
    sp.cleanup()
    keys2, accs2 = ex.table_to_partials(back)
    np.testing.assert_array_equal(keys2[0], keys[0])
    for acc, acc2 in zip(accs, accs2):
        for a, b in zip(acc, acc2):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
