"""Distributed cases and the rank tasks that run them.

A case builds its tables from a seed and its plan through whichever package
it is given (``api(package)``): the distributed tests build the JAX package's
plan with the same function and run it on its virtual-device mesh, and every
rank of a ``testing/world.py`` World builds the port's plan and runs it
through ``parallel.runner.DistributedExecutor``.  Nothing here imports the
JAX package: the tests pass it in.

The cases mirror the JAX package's ``tests/test_distributed.py``,
``tests/test_distributed_joins.py`` and the distributed cases of
``test_hugeint.py``, ``test_sketch.py`` and ``test_strcast.py``, with their
tables, plans, per-device rows and configs.
"""

from __future__ import annotations

import importlib
import time
import types
from typing import Callable, Dict

import numpy as np

SF = 0.01


def api(package) -> types.SimpleNamespace:
    """The names a case needs, from ``package`` (``velox_tpu_torch`` or the
    JAX package, passed in by the caller)."""
    base = package.__name__

    def mod(name):
        return importlib.import_module(f"{base}.{name}")

    dtypes = mod("dtypes")
    return types.SimpleNamespace(
        PlanBuilder=mod("plan").PlanBuilder,
        Table=mod("io.table").Table,
        RowType=dtypes.RowType,
        BIGINT=dtypes.BIGINT,
        DOUBLE=dtypes.DOUBLE,
        decimal=dtypes.decimal,
        QueryConfig=mod("config").QueryConfig,
        np_from_int=mod("ops.int128").np_from_int,
        tpch=mod("connectors.tpch.plans"),
        queries=mod("connectors.tpch.queries"),
    )


# ---------------------------------------------------------------------------
# tables of tests/test_distributed_joins.py


def make_probe(A, n=20000, key_range=3000, seed=1, skew=None):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, n).astype(np.int64)
    if skew is not None:
        hot = rng.random(n) < skew
        keys[hot] = 7  # 90% of rows share one key
    return A.Table(
        A.RowType(["k", "v"], [A.BIGINT, A.BIGINT]),
        {"k": keys, "v": rng.integers(0, 10**6, n).astype(np.int64)},
    )


def make_build(A, key_range=3000, seed=2, holes=True):
    rng = np.random.default_rng(seed)
    keys = np.arange(key_range, dtype=np.int64)
    if holes:
        keys = keys[rng.random(key_range) < 0.7]  # some probes miss
    return A.Table(
        A.RowType(["bk", "w"], [A.BIGINT, A.BIGINT]),
        {"bk": keys, "w": rng.integers(0, 10**6, len(keys)).astype(np.int64)},
    )


def make_nm_build(A, key_range=3000, seed=5, avg_dup=3):
    rng = np.random.default_rng(seed)
    reps = rng.integers(1, 2 * avg_dup, key_range)
    keys = np.repeat(np.arange(key_range, dtype=np.int64), reps)
    keep = rng.random(len(keys)) < 0.8  # holes: some probes miss
    keys = keys[keep]
    return A.Table(
        A.RowType(["bk", "w"], [A.BIGINT, A.BIGINT]),
        {"bk": keys, "w": rng.integers(0, 10**6, len(keys)).astype(np.int64)},
    )


def join_plan(A, probe, build, join_type="inner", output=("k", "v", "w")):
    return (
        A.PlanBuilder()
        .table_scan(probe)
        .hash_join(A.PlanBuilder().table_scan(build), ["k"], ["bk"], output=list(output),
                   join_type=join_type)
        .build()
    )


def _shuffle(A):
    """Force shuffle joins regardless of build size."""
    return A.QueryConfig(broadcast_join_max_rows=0)


# ---------------------------------------------------------------------------
# the cases: name -> function(A) -> (plan, per_device_rows, config or None)


def _build_query(A, num, tables, device="cpu"):
    if A.tpch.__name__.startswith("velox_tpu_torch."):
        return A.tpch.build_query(num, tables, device=device)
    return A.tpch.build_query(num, tables)


def case_q6(A):
    from_cols = A.queries.Q6_COLUMNS
    tables = {"lineitem": A.tpch.load_query_tables(6, SF)["lineitem"].select(from_cols)}
    return _build_query(A, 6, tables), 1 << 12, None


def case_q1(A):
    tables = A.tpch.load_query_tables(1, SF)
    return _build_query(A, 1, tables), 1 << 12, None


def case_q3(A):
    tables = A.tpch.load_query_tables(3, SF)
    return _build_query(A, 3, tables), 1 << 13, None


def case_sort_mode_groupby(A):
    rng = np.random.default_rng(0)
    n = 5000
    t = A.Table(A.RowType(["k", "v"], [A.BIGINT, A.BIGINT]),
                {"k": rng.integers(0, 700, n), "v": rng.integers(-100, 100, n)})
    plan = (A.PlanBuilder().table_scan(t)
            .aggregation(["k"], ["sum(v) as s", "count(*) as c", "max(v) as hi"])
            .orderby(["k"]).build())
    return plan, 256, None


def case_multi_tile(A):
    rng = np.random.default_rng(3)
    n = 6000
    t = A.Table(A.RowType(["k", "v"], [A.BIGINT, A.BIGINT]),
                {"k": rng.integers(0, 500, n), "v": rng.integers(-9, 9, n)})
    plan = (A.PlanBuilder().table_scan(t)
            .aggregation(["k"], ["sum(v) as s", "min(v) as lo"])
            .orderby(["k"]).build())
    return plan, 128, None


def case_exchange_overflow_reprobe(A):
    rng = np.random.default_rng(11)
    n = 4096
    # 90% of probe rows share one key -> one destination bucket is hot
    keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 4000, n)).astype(np.int64)
    probe = A.Table(A.RowType(["k", "x"], [A.BIGINT, A.BIGINT]),
                    {"k": keys, "x": rng.integers(0, 100, n)})
    bn = 4000
    build = A.Table(A.RowType(["bk", "y"], [A.BIGINT, A.BIGINT]),
                    {"bk": np.arange(bn, dtype=np.int64),
                     "y": np.arange(bn, dtype=np.int64) * 3})
    plan = (A.PlanBuilder().table_scan(probe)
            .hash_join(A.PlanBuilder().table_scan(build).build(), ["k"], ["bk"],
                       output=["k", "x", "y"])
            .aggregation(["k"], ["sum(x) as sx", "sum(y) as sy", "count(*) as c"])
            .orderby(["k"]).build())
    # force the shuffle-join path; a bucket far below the hot key's rows
    cfg = A.QueryConfig(broadcast_join_max_rows=64, exchange_bucket_rows=32)
    return plan, 512, cfg


def _shuffle_collect(join_type, output):
    def case(A):
        return join_plan(A, make_probe(A), make_build(A), join_type, output), 1 << 11, _shuffle(A)
    return case


def case_broadcast_small_build(A):
    return join_plan(A, make_probe(A), make_build(A, key_range=100)), 1 << 11, None


def case_duplicate_build_semi(A):
    probe = make_probe(A, n=4000, key_range=50)
    rng = np.random.default_rng(3)
    build = A.Table(A.RowType(["bk"], [A.BIGINT]),
                    {"bk": rng.integers(0, 50, 200).astype(np.int64)})
    plan = (A.PlanBuilder().table_scan(probe)
            .hash_join(A.PlanBuilder().table_scan(build), ["k"], ["bk"], output=["k", "v"],
                       join_type="left_semi")
            .build())
    return plan, 1 << 10, _shuffle(A)


def case_collect_filter_project(A):
    probe = make_probe(A, n=30000)
    plan = (A.PlanBuilder().table_scan(probe, filter="k % 7 = 1")
            .project(["k", "v + 1 as v1"]).build())
    return plan, 1 << 11, None


def case_shuffle_join_into_groupby(A):
    probe, build = make_probe(A, n=30000, key_range=5000), make_build(A, 5000)
    plan = (A.PlanBuilder().table_scan(probe)
            .hash_join(A.PlanBuilder().table_scan(build), ["k"], ["bk"], output=["k", "v", "w"])
            .aggregation(["k"], ["sum(v) as sv", "count() as c", "max(w) as mw"])
            .build())
    return plan, 1 << 11, _shuffle(A)


def case_skewed_groupby_grows_carry(A):
    rng = np.random.default_rng(9)
    n = 16000
    keys = rng.integers(0, 4000, n).astype(np.int64)
    hot = rng.random(n) < 0.9
    keys[hot] = (keys[hot] // 8) * 8
    t = A.Table(A.RowType(["k", "v"], [A.BIGINT, A.BIGINT]),
                {"k": keys, "v": rng.integers(0, 100, n).astype(np.int64)})
    plan = (A.PlanBuilder().table_scan(t)
            .aggregation(["k"], ["sum(v) as sv", "count() as c"]).build())
    return plan, 1 << 11, A.QueryConfig(distributed_carry_rows=32)  # deliberately tiny


def case_shuffle_join_multi_key(A):
    rng = np.random.default_rng(4)
    n = 12000
    k1 = rng.integers(0, 40, n).astype(np.int64)
    k2 = rng.integers(0, 50, n).astype(np.int64)
    probe = A.Table(A.RowType(["a", "b", "v"], [A.BIGINT, A.BIGINT, A.BIGINT]),
                    {"a": k1, "b": k2, "v": rng.integers(0, 10**6, n).astype(np.int64)})
    pairs = {(int(a), int(b)) for a, b in zip(k1[::3], k2[::3])}
    ba = np.asarray([p[0] for p in sorted(pairs)], dtype=np.int64)
    bb = np.asarray([p[1] for p in sorted(pairs)], dtype=np.int64)
    build = A.Table(A.RowType(["ba", "bb", "w"], [A.BIGINT, A.BIGINT, A.BIGINT]),
                    {"ba": ba, "bb": bb, "w": np.arange(len(ba), dtype=np.int64)})
    plan = (A.PlanBuilder().table_scan(probe)
            .hash_join(A.PlanBuilder().table_scan(build), ["a", "b"], ["ba", "bb"],
                       output=["a", "b", "v", "w"])
            .build())
    return plan, 1 << 10, _shuffle(A)


def _nm(join_type, output):
    def case(A):
        plan = join_plan(A, make_probe(A), make_nm_build(A), join_type, output)
        return plan, 1 << 11, _shuffle(A)
    return case


def case_nm_expansion_overflow(A):
    probe = make_probe(A, n=16000, key_range=400)
    build = make_nm_build(A, key_range=400, avg_dup=24)
    return join_plan(A, probe, build, "inner", ("k", "v", "w")), 1 << 10, _shuffle(A)


def case_nm_skewed(A):
    probe = make_probe(A, n=12000, key_range=500, skew=0.9)
    rng = np.random.default_rng(11)
    keys = np.repeat(np.arange(500, dtype=np.int64), rng.integers(1, 7, 500))
    build = A.Table(A.RowType(["bk", "w"], [A.BIGINT, A.BIGINT]),
                    {"bk": keys, "w": rng.integers(0, 10**6, len(keys)).astype(np.int64)})
    return join_plan(A, probe, build, "inner", ("k", "v", "w")), 1 << 10, _shuffle(A)


def case_nm_into_groupby(A):
    probe, build = make_probe(A, n=24000, key_range=2000), make_nm_build(A, 2000)
    plan = (A.PlanBuilder().table_scan(probe)
            .hash_join(A.PlanBuilder().table_scan(build), ["k"], ["bk"], output=["k", "v", "w"])
            .aggregation(["k"], ["sum(v) as sv", "count() as c", "max(w) as mw"])
            .build())
    return plan, 1 << 11, _shuffle(A)


def case_nm_left_filter(A):
    probe, build = make_probe(A, n=8000, key_range=300), make_nm_build(A, 300)
    plan = (A.PlanBuilder().table_scan(probe)
            .hash_join(A.PlanBuilder().table_scan(build), ["k"], ["bk"], output=["k", "v", "w"],
                       join_type="left", filter="w < v")
            .build())
    return plan, 1 << 11, _shuffle(A)


def rand_ints(n, seed=1, digits=30):
    """Random ints spanning ``digits`` decimal digits (beyond int64), as
    ``tests/test_hugeint.py`` draws them."""
    rng = np.random.default_rng(seed)
    half = 10 ** (digits // 2)
    return [int(rng.integers(-half, half)) * int(rng.integers(1, half)) + int(rng.integers(0, 1000))
            for _ in range(n)]


def case_hugeint(A):
    n, seed = 4000, 27
    hi, lo = A.np_from_int(rand_ints(n, seed))
    g = np.random.default_rng(seed + 1).integers(0, 8, n)
    t = A.Table(A.RowType(["v", "g"], [A.decimal(38, 2), A.BIGINT]),
                {"v": np.stack([lo, hi], axis=1), "g": g})
    plan = (A.PlanBuilder().table_scan(t)
            .aggregation(["g"], ["sum(v) as s", "count(v) as c"]).build())
    return plan, 1 << 10, None


def case_sketch(A):
    rng = np.random.default_rng(1)
    n, ndv = 80_000, 10_000
    t = A.Table(A.RowType(["v", "g"], [A.BIGINT, A.BIGINT]),
                {"v": rng.integers(0, ndv, n).astype(np.int64) * 7919 + 13,
                 "g": rng.integers(0, 16, n).astype(np.int64)})
    plan = (A.PlanBuilder().table_scan(t)
            .aggregation(["g"], ["approx_distinct(v) as ad"]).build())
    return plan, 1 << 11, None


def case_strcast(A):
    t = A.Table(A.RowType(["x", "v"], [A.BIGINT, A.DOUBLE]),
                {"x": np.arange(1000) % 7, "v": np.arange(1000.0)})
    plan = (A.PlanBuilder().table_scan(t)
            .project(["cast(x as varchar) as sx", "v"])
            .aggregation(["sx"], ["sum(v) as s"]).build())
    return plan, 64, None


def null_key_columns(n=6000, seed=21):
    """Probe-side columns with a nullable key (about 15 % NULL)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 400, n).astype(np.int64), rng.integers(-50, 50, n).astype(np.int64),
            rng.random(n) > 0.15)


def case_null_keys_groupby(A):
    """Grouping over a nullable key through the group exchange: the NULL
    group is one group, on one rank."""
    k, v, valid = null_key_columns()
    t = A.Table(A.RowType(["k", "v"], [A.BIGINT, A.BIGINT]), {"k": k, "v": v}, {}, {"k": valid})
    plan = (A.PlanBuilder().table_scan(t)
            .aggregation(["k"], ["sum(v) as s", "count(*) as c"]).orderby(["k"]).build())
    return plan, 512, None


def case_null_keys_shuffle_left(A):
    """A LEFT shuffle join whose probe keys are nullable: a NULL key rides
    the exchange and matches nothing."""
    k, v, valid = null_key_columns()
    probe = A.Table(A.RowType(["k", "v"], [A.BIGINT, A.BIGINT]), {"k": k, "v": v}, {}, {"k": valid})
    build = make_build(A, key_range=400)
    return join_plan(A, probe, build, "left", ("k", "v", "w")), 1 << 10, _shuffle(A)


CASES: Dict[str, Callable] = {
    "q6": case_q6,
    "q1": case_q1,
    "q3": case_q3,
    "sort_mode_groupby": case_sort_mode_groupby,
    "multi_tile": case_multi_tile,
    "exchange_overflow_reprobe": case_exchange_overflow_reprobe,
    "shuffle_inner": _shuffle_collect("inner", ("k", "v", "w")),
    "shuffle_left": _shuffle_collect("left", ("k", "v", "w")),
    "shuffle_left_semi": _shuffle_collect("left_semi", ("k", "v")),
    "shuffle_anti": _shuffle_collect("anti", ("k", "v")),
    "broadcast_small_build": case_broadcast_small_build,
    "duplicate_build_semi": case_duplicate_build_semi,
    "collect_filter_project": case_collect_filter_project,
    "shuffle_join_into_groupby": case_shuffle_join_into_groupby,
    "skewed_groupby_grows_carry": case_skewed_groupby_grows_carry,
    "shuffle_join_multi_key": case_shuffle_join_multi_key,
    "nm_inner": _nm("inner", ("k", "v", "w")),
    "nm_left": _nm("left", ("k", "v", "w")),
    "nm_expansion_overflow": case_nm_expansion_overflow,
    "nm_skewed": case_nm_skewed,
    "nm_into_groupby": case_nm_into_groupby,
    "nm_left_filter": case_nm_left_filter,
    "hugeint": case_hugeint,
    "sketch": case_sketch,
    "strcast": case_strcast,
    "null_keys_groupby": case_null_keys_groupby,
    "null_keys_shuffle_left": case_null_keys_shuffle_left,
}


def report(ex) -> dict:
    """What a DistributedExecutor (of either package) did, in the fields
    both have."""
    return dict(
        kind=ex.kind,
        segments=len(ex._segments),
        expansion=[bool(s[1].expansion) for s in ex._segments],
        sjoin_buckets=list(ex._sjoin_buckets),
        sjoin_outcaps=list(ex._sjoin_outcaps),
        carry_rows=getattr(ex, "_carry_rows", None),
    )


# ---------------------------------------------------------------------------
# rank tasks (World.run targets): fn(mesh, *args)


def run_case(mesh, name: str) -> dict:
    """Case ``name`` through the port's DistributedExecutor on this rank."""
    import velox_tpu_torch
    from ..parallel.runner import DistributedExecutor

    plan, per_dev, config = CASES[name](api(velox_tpu_torch))
    kwargs = {} if per_dev is None else {"per_device_rows": per_dev}
    ex = DistributedExecutor(plan, mesh, config=config, **kwargs)
    before = report(ex)
    result = ex.run()
    return dict(result=result, before=before, after=report(ex),
                carry_retries=ex.carry_retries, reprobes=ex.reprobes)


def run_tpch(mesh, num: int, tables_root: str, per_device_rows: int, config=None) -> dict:
    """TPC-H plan ``num`` over the tables a World shared (each table with
    at least the query's columns), distributed.  ``seconds`` is the whole
    query on rank 0 (plan, executor with its build sides, run; synchronised
    on a card); ``device_peak_bytes`` every rank's peak device memory."""
    import torch

    from ..connectors.tpch.plans import build_query
    from ..connectors.tpch.queries import QUERY_COLUMNS
    from ..parallel.runner import DistributedExecutor
    from .world import load_shared_tables

    cuda = mesh.device.type == "cuda"
    columns = QUERY_COLUMNS[num]
    shared = load_shared_tables(tables_root, columns)
    tables = {name: shared[name].select(cols) for name, cols in columns.items()}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    mesh.reset_stats()
    t0 = time.perf_counter()
    plan = build_query(num, tables, device=mesh.device)
    ex = DistributedExecutor(plan, mesh, per_device_rows=per_device_rows, config=config)
    result = ex.run()
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = dict(mesh.stats)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    peaks = mesh.all_gather(torch.tensor([peak], dtype=torch.int64, device=mesh.device))
    return dict(result=result, after=report(ex), carry_retries=ex.carry_retries,
                reprobes=ex.reprobes, seconds=seconds, stats=stats,
                world=mesh.size, backend=mesh.backend, staged=mesh.staged,
                device_peak_bytes=[int(p) for p in peaks.flatten().tolist()] if cuda else None)


def exchange_rows_task(mesh, keys: np.ndarray, vals: np.ndarray, mask: np.ndarray,
                       bucket: int = None) -> dict:
    """``exchange_rows`` (and the skew-aware capacity when ``bucket`` is
    None) over this rank's shard of global arrays; every rank's received
    arrays, gathered in rank order."""
    import torch

    from ..parallel.distributed import all_gather_arrays
    from ..parallel.exchange import exchange_rows, skew_aware_bucket_capacity

    per = len(keys) // mesh.size
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    k = torch.as_tensor(keys[sl], device=mesh.device)
    v = torch.as_tensor(vals[sl], device=mesh.device)
    m = torch.as_tensor(mask[sl], device=mesh.device)
    cap = skew_aware_bucket_capacity(mesh, k, m, mesh.size) if bucket is None else bucket
    (vals_r,), keys_r, live, dropped = exchange_rows([v], k, m, mesh, mesh.size, cap)
    ranks = all_gather_arrays(mesh, [vals_r, keys_r, live, dropped.reshape(1)])
    return dict(cap=cap, ranks=[[a.cpu().numpy() for a in r] for r in ranks])


def grouped_sum_task(mesh, x: np.ndarray, keys: np.ndarray, num_groups: int) -> list:
    """``distributed_grouped_sum`` of ``x * 2`` over rows with ``x > 10``,
    grouped by ``keys``: every rank's partial sums in rank order."""
    import torch

    from ..dtypes import BIGINT, RowType
    from ..expr.parser import parse_expr
    from ..parallel.distributed import all_gather_arrays, distributed_grouped_sum

    schema = RowType(["x"], [BIGINT])
    step = distributed_grouped_sum(
        mesh, parse_expr("x > 10", schema), parse_expr("x * 2", schema), schema, num_groups
    )
    per = len(x) // mesh.size
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    out = step([torch.as_tensor(x[sl], device=mesh.device)],
               torch.as_tensor(keys[sl], dtype=torch.int32, device=mesh.device))
    return [r[0].cpu().numpy() for r in all_gather_arrays(mesh, [out])]


def loaded_modules_task(mesh) -> list:
    """The JAX modules this rank has imported (none, or the rank raised)."""
    import sys

    return sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m == "velox_tpu" or m.startswith("velox_tpu."))


def hang_task(mesh) -> None:
    """Rank 0 enters an all-reduce the other ranks never join: a hung
    collective, which the World must turn into an error."""
    import torch

    if mesh.rank == 0:
        mesh.all_reduce(torch.ones(1, device=mesh.device))


def fail_task(mesh) -> None:
    """Rank 1 raises."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
