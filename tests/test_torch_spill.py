"""Spill coverage of the port: the Grace hash join, the window chunk spill
and the external sort, against the JAX package's rows on the same numpy
tables.

Mirrors ``tests/test_spill.py`` (the four Grace join types, duplicate build
keys, Grace then aggregation, the window spill, the single hot key, the
null-aware anti join with and without a NULL in the build) with the JAX
package's budgets; each test asserts the injection point of the path it is
there for (``utils/testvalue.py``).  The JAX package runs each plan without
a budget (its own test holds its spilled rows to those).  The device
partition filter (``__grace_hash``) is held to the host partitioner
(``splitmix64_np``) bit for bit, and both to the JAX package's.  Integers
exact, DOUBLE rtol 1e-9."""

import numpy as np
import pandas as pd
import pytest
import torch

import velox_tpu as vt
from velox_tpu.exec.grace import pick_partition_count as ref_pick_partition_count
from velox_tpu.exec.grace import splitmix64_np as ref_splitmix64_np
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.vector.string_table import StringTable as RefStrings
from velox_tpu_torch.config import DEFAULT_CONFIG
from velox_tpu_torch.exec.grace import (
    grace_hash,
    partition_build,
    pick_partition_count,
    probe_filter_expr,
    splitmix64_np,
)
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.utils import testvalue

_REF_TYPES = {"BIGINT": vt.BIGINT, "VARCHAR": vt.VARCHAR, "DOUBLE": vt.DOUBLE}
GRACE_CFG = DEFAULT_CONFIG.copy(query_memory_limit_bytes=80_000)


def _pair(cols, types, strings=None, validities=None):
    """(JAX Table, port Table) of the same numpy columns."""
    names = list(cols)
    port = table_from_numpy(names, types, cols, strings, validities)
    ref = RefTable(
        vt.RowType(names, [_REF_TYPES[t] for t in types]), dict(cols),
        {k: RefStrings.from_values(v) for k, v in (strings or {}).items()},
        dict(validities or {}),
    )
    return ref, port


def probe_table(n=40_000, seed=3):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.05
    return _pair(
        {"k": rng.integers(0, 30_000, n), "x": rng.integers(0, 100, n)},
        ["BIGINT", "BIGINT"], validities={"k": valid},
    )


def build_table(n=20_000, seed=4, dup=False, null_at=None):
    rng = np.random.default_rng(seed)
    k = rng.permutation(30_000)[:n].astype(np.int64)
    if dup:
        k = np.concatenate([k, k[: n // 4]])
    names = ["", "ash", "birch", "cedar", "fir", "oak"]
    codes = rng.integers(1, len(names), len(k)).astype(np.int32)
    validities = None
    if null_at is not None:
        validities = {"bk": np.ones(len(k), bool)}
        validities["bk"][null_at] = False
    return _pair(
        {"bk": k, "y": rng.integers(0, 1000, len(k)), "s": codes},
        ["BIGINT", "BIGINT", "VARCHAR"], {"s": names}, validities,
    )


def assert_same_rows(got, want, ordered=False):
    """The same rows (in the same order when ``ordered``; else as sorted
    multisets): integers and strings exactly, DOUBLE to rtol 1e-9."""
    a, b = got.to_pandas(), want.to_pandas()
    assert list(a.columns) == list(b.columns)
    if not ordered:
        keys = list(a.columns)
        a = a.sort_values(keys, kind="stable", na_position="first")
        b = b.sort_values(keys, kind="stable", na_position="first")
    pd.testing.assert_frame_equal(a.reset_index(drop=True), b.reset_index(drop=True),
                                  check_dtype=False, rtol=1e-9, atol=0)


def join(builder, probe, build, jt, output, null_aware=False):
    return (
        builder()
        .table_scan(probe)
        .hash_join(builder().table_scan(build).build(), ["k"], ["bk"], output=output,
                   join_type=jt, null_aware=null_aware)
        .build()
    )


def _run_both(make, ref_args, port_args, tile_rows, config, points):
    """The JAX package's rows without a budget, the port's under ``config``,
    and the hits of each injection point of ``points``."""
    want = RefExecutor(make(RefBuilder, *ref_args), tile_rows=tile_rows).run()
    hits = {p: [] for p in points}
    for p in points:
        testvalue.register(p, hits[p].append)
    try:
        ex = LocalExecutor(make(PlanBuilder, *port_args), tile_rows=tile_rows, config=config,
                           device="cpu")
        got = ex.run()
    finally:
        for p in points:
            testvalue.unregister(p)
    return got, want, ex, {p: len(h) for p, h in hits.items()}


@pytest.mark.parametrize(
    "jt,output",
    [
        ("inner", ["k", "x", "y", "s"]),
        ("left", ["k", "x", "y"]),
        ("left_semi", ["k", "x"]),
        ("anti", ["k", "x"]),
    ],
)
def test_grace_join_matches_in_memory(jt, output):
    (rp, pp), (rb, pb) = probe_table(), build_table()
    got, want, ex, hits = _run_both(
        lambda b, p, q: join(b, p, q, jt, output), (rp, rb), (pp, pb), 4096, GRACE_CFG,
        ["LocalExecutor::graceJoin"],
    )
    assert hits["LocalExecutor::graceJoin"] == 1, "memory limit did not trigger the grace join"
    [report] = ex.grace_joins
    assert report["P"] >= 2
    assert sum(p["build_rows"] for p in report["partitions"]) == pb.num_rows
    assert sum(p["out_rows"] for p in report["partitions"]) == got.num_rows
    assert_same_rows(got, want)


def test_grace_join_duplicate_build_keys():
    """N:M expansion joins partition too (per-partition run spans)."""
    (rp, pp), (rb, pb) = probe_table(20_000, seed=7), build_table(8000, seed=8, dup=True)
    got, want, _, hits = _run_both(
        lambda b, p, q: join(b, p, q, "inner", ["k", "x", "y"]), (rp, rb), (pp, pb), 2048,
        DEFAULT_CONFIG.copy(query_memory_limit_bytes=60_000), ["LocalExecutor::graceJoin"],
    )
    assert hits["LocalExecutor::graceJoin"] >= 1
    assert_same_rows(got, want)


def test_grace_join_then_aggregation():
    """Steps above the join plan again over the Grace result."""
    (rp, pp), (rb, pb) = probe_table(), build_table()

    def make(builder, p, q):
        return (
            builder().table_scan(p)
            .hash_join(builder().table_scan(q).build(), ["k"], ["bk"], output=["x", "y"])
            .aggregation(["x"], ["sum(y) as sy", "count(*) as c"])
            .orderby(["x"])
            .build()
        )

    got, want, ex, hits = _run_both(make, (rp, rb), (pp, pb), 4096, GRACE_CFG,
                                    ["LocalExecutor::graceJoin"])
    assert hits["LocalExecutor::graceJoin"] == 1 and ex.kind != "collect"
    assert_same_rows(got, want, ordered=True)


def test_window_spill():
    rng = np.random.default_rng(11)
    n = 30_000
    rt, pt = _pair(
        {"g": rng.integers(0, 300, n), "o": rng.permutation(n).astype(np.int64),
         "v": rng.random(n)},
        ["BIGINT", "BIGINT", "DOUBLE"],
    )

    def make(builder, t):
        return (
            builder().table_scan(t)
            .window(["g"], ["o"], ["row_number() as rn", "sum(v) as sv"])
            .orderby(["g", "o"])
            .build()
        )

    got, want, ex, hits = _run_both(
        make, (rt,), (pt,), 4096, DEFAULT_CONFIG.copy(spill_bytes_threshold=1 << 16),
        ["LocalExecutor::windowSpill", "Spiller::spill"],
    )
    assert hits["LocalExecutor::windowSpill"] >= 1, "window spill threshold did not trigger"
    assert len(ex.window_chunks) > 1
    assert ex.spill_stats["spill_files"] >= 2 and ex.spill_stats["spilled_rows"] >= n
    assert_same_rows(got, want, ordered=True)


def test_grace_join_single_hot_key_terminates():
    """An all-duplicate-key build cannot be split by hashing: the Grace path
    must detect no progress and run that partition without a budget instead
    of recursing forever (reference: Spiller max spill level)."""
    rng = np.random.default_rng(31)
    n_p, n_b = 800, 3000
    rp, pp = _pair({"k": rng.integers(6, 9, n_p), "x": rng.integers(0, 100, n_p)},
                   ["BIGINT", "BIGINT"])
    rb, pb = _pair({"bk": np.full(n_b, 7, dtype=np.int64), "y": rng.integers(0, 1000, n_b)},
                   ["BIGINT", "BIGINT"])
    got, want, ex, hits = _run_both(
        lambda b, p, q: join(b, p, q, "inner", ["k", "x", "y"]), (rp, rb), (pp, pb), 4096,
        DEFAULT_CONFIG.copy(query_memory_limit_bytes=40_000),
        ["LocalExecutor::graceJoin", "LocalExecutor::graceNoProgress"],
    )
    assert hits["LocalExecutor::graceJoin"] and hits["LocalExecutor::graceNoProgress"]
    n_hot = int((np.asarray(pp.columns["k"]) == 7).sum())
    assert got.num_rows == n_hot * n_b
    assert_same_rows(got, want)


def test_grace_null_aware_anti():
    """NOT IN through the Grace path: the null-aware rules resolve globally
    (build NULL -> empty; empty build -> keep all; probe NULLs drop), then
    the partitions run a plain ANTI join."""
    (rp, pp), (rb, pb) = probe_table(), build_table()
    got, want, _, hits = _run_both(
        lambda b, p, q: join(b, p, q, "anti", ["k", "x"], null_aware=True), (rp, rb), (pp, pb),
        4096, GRACE_CFG, ["LocalExecutor::graceJoin"],
    )
    assert hits["LocalExecutor::graceJoin"] == 1, "memory limit did not trigger the grace join"
    assert_same_rows(got, want)


def test_grace_null_aware_anti_null_in_build():
    """A NULL build key empties the result — under Grace too."""
    (rp, pp), (rb, pb) = probe_table(), build_table(null_at=7)
    got, want, _, _ = _run_both(
        lambda b, p, q: join(b, p, q, "anti", ["k", "x"], null_aware=True), (rp, rb), (pp, pb),
        4096, GRACE_CFG, [],
    )
    assert got.num_rows == 0 and want.num_rows == 0


@pytest.mark.parametrize("pressure", ["threshold", "budget"])
def test_sort_spill_external_merge(pressure):
    """An ORDER BY whose resident sorted runs pass the spill threshold, or
    whose run reservation the budget refuses, spills them and merges on the
    host; the rows and their order equal the JAX package's device sort."""
    rng = np.random.default_rng(12)
    n = 20_000
    valid = rng.random(n) > 0.1
    rt, pt = _pair(
        {"a": rng.integers(0, 50, n), "b": rng.permutation(n).astype(np.int64),
         "c": rng.random(n), "s": rng.integers(1, 4, n).astype(np.int32)},
        ["BIGINT", "BIGINT", "DOUBLE", "VARCHAR"], {"s": ["", "x", "yy", "zzz"]},
        {"a": valid},
    )
    config = (DEFAULT_CONFIG.copy(spill_bytes_threshold=1 << 16) if pressure == "threshold"
              else DEFAULT_CONFIG.copy(query_memory_limit_bytes=200_000))

    def make(builder, t):
        return builder().table_scan(t).orderby(["a desc nulls first", "s", "b"]).build()

    got, want, ex, hits = _run_both(make, (rt,), (pt,), 4096, config,
                                    ["LocalExecutor::sortSpill"])
    assert hits["LocalExecutor::sortSpill"] >= 1
    assert ex.spill_stats["spilled_rows"] == n and ex.spill_stats["spill_files"] >= 2
    assert ex.pool.reserved == 0  # the resident runs' reservations are released
    assert_same_rows(got, want, ordered=True)


def test_grace_hash_matches_splitmix64_np():
    """``__grace_hash`` on torch int64 lanes equals the host partitioner bit
    for bit, and both equal the JAX package's, on 4 096 keys with negatives,
    INT64_MIN and INT64_MAX among them."""
    rng = np.random.default_rng(17)
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 4096, dtype=np.int64)
    keys[:6] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0, 1, -(1 << 62)]
    for salt in (1, 0x7FFFFFFF, 0xDEADBEEF, 0xFFFFFFFF):
        host = splitmix64_np(keys, salt)
        np.testing.assert_array_equal(host, ref_splitmix64_np(keys, salt))
        dev = grace_hash(torch.from_numpy(keys), salt).numpy()
        np.testing.assert_array_equal(dev, host)


def test_probe_filter_partitions_like_the_build():
    """Each probe row passes exactly one partition's device filter, the one
    ``partition_build`` puts its key in; NULL keys ride partition 0."""
    from velox_tpu_torch.plan.nodes import FilterNode

    (_, pp), (_, pb) = probe_table(6000, seed=21), build_table(3000, seed=22)
    node = join(PlanBuilder, pp, pb, "inner", ["k", "x", "y"])
    P, salt = 8, 12345
    keys = np.asarray(pp.columns["k"])
    valid = np.asarray(pp.validities["k"])
    # the probe's rows as a build table: partition_build's split of the keys
    as_build = table_from_numpy(["bk"], ["BIGINT"], {"bk": keys}, validities={"bk": valid})
    want = [np.sort(np.asarray(t.columns["bk"])) for t in partition_build(as_build, ["bk"], P, salt)]
    seen = 0
    for p in range(P):
        kept = LocalExecutor(FilterNode(node.left, probe_filter_expr(node, P, p, salt)),
                             tile_rows=1024, device="cpu").run()
        np.testing.assert_array_equal(np.sort(np.asarray(kept.columns["k"])), want[p])
        seen += kept.num_rows
    assert seen == pp.num_rows


@pytest.mark.parametrize("build_bytes,budget", [
    (1 << 20, None), (1 << 20, 80_000), (400_000, 80_000), (10, 1 << 30), (1 << 40, 1000),
])
def test_pick_partition_count(build_bytes, budget):
    assert pick_partition_count(build_bytes, budget) == ref_pick_partition_count(build_bytes, budget)
