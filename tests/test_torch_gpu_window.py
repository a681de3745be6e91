"""The window, FULL-join, UNION ALL, MergeExchange and nested-loop paths on the
card against the same plans on the CPU: every window function and frame kind
(one pass, and chunks of whole partitions), the window primitives at sizes
the CPU tests do not reach, FULL joins plain and filtered over several
tiles, the filtered null-aware anti join, nested-loop joins of every type,
and the slice's TPC-H texts and plans (``chip_smoke.py`` ``WINDOW_SQL`` /
``window_plan``) at SF 0.01 through ``run_sql`` / ``LocalExecutor``.  The
CPU tests hold the same code against the JAX package; what only a CUDA
device shows is that every call exists there and gives the same rows.
Skipped where there is no CUDA device; run with
``python -m pytest tests/test_torch_gpu_window.py -m gpu``.

Integers, dates, dictionary codes and masks exact (values compared where
valid); DOUBLE rtol 1e-9."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.ops import segmented
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.sql import run_sql
from velox_tpu_torch.testing import table_from_numpy

pytestmark = pytest.mark.gpu

SF = 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _same(got, want, ordered=True):
    assert list(got.schema.names) == list(want.schema.names)
    assert got.num_rows == want.num_rows
    n = want.num_rows
    g_df, w_df = got.to_pandas(), want.to_pandas()
    if not ordered:
        g_df = g_df.sort_values(list(g_df.columns), kind="mergesort").reset_index(drop=True)
        w_df = w_df.sort_values(list(w_df.columns), kind="mergesort").reset_index(drop=True)
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = g_df[name].to_numpy(), w_df[name].to_numpy()
        g_null = np.array([v is None or v != v for v in g], bool) if n else np.zeros(0, bool)
        w_null = np.array([v is None or v != v for v in w], bool) if n else np.zeros(0, bool)
        np.testing.assert_array_equal(g_null, w_null, err_msg=name)
        g, w = g[~w_null], w[~w_null]
        if dtype.is_floating:
            np.testing.assert_allclose(g.astype(float), w.astype(float), rtol=1e-9, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _both(make, tile_rows, cuda, ordered=True):
    want = LocalExecutor(make().build(), tile_rows=tile_rows, device="cpu").run()
    ex = LocalExecutor(make().build(), tile_rows=tile_rows, device=cuda)
    _same(ex.run(), want, ordered)
    return ex


def _data(n=5000, seed=7):
    rng = np.random.default_rng(seed)
    return table_from_numpy(
        ["g", "s", "o", "v", "d", "m", "t"],
        ["BIGINT", "VARCHAR", "BIGINT", "BIGINT", "DOUBLE", "DECIMAL(12,2)", "DATE"],
        {"g": rng.integers(0, 60, n), "s": rng.integers(1, 4, n).astype(np.int32),
         "o": rng.integers(0, 300, n), "v": rng.integers(-50, 50, n),
         "d": rng.normal(size=n) * 100, "m": rng.integers(-10**6, 10**6, n),
         "t": rng.integers(9000, 9400, n).astype(np.int32)},
        {"s": ["", "ash", "birch", "cedar"]},
        {"v": rng.random(n) < 0.9, "d": rng.random(n) < 0.85},
    )


CALLS = [
    "row_number() as rn", "rank() as rk", "dense_rank() as dr", "ntile(4) as nt",
    "percent_rank() as pr", "cume_dist() as cd", "sum(v) as sv", "count(v) as cv",
    "avg(m) as am", "min(d) as mnd", "max(t) as mxt", "lag(v, 2) as lg", "lead(d) as ld",
    "lag(v) ignore nulls as lgi", "lead(d, 2) ignore nulls as ldi",
    "first_value(d) as fv", "last_value(v) ignore nulls as lv", "nth_value(s, 3) as nv",
    "sum(m) rows between 2 preceding and 1 following as ws",
    "min(v) rows between 3 preceding and current row as wmn",
    "max(d) rows between current row and 5 following as wmx",
    "avg(d) range between 20 preceding and 10 following as ra",
    "count(v) range between 15 preceding and current row as rc",
    "max(m) range between unbounded preceding and 5 following as rmx",
    "variance(d) as var", "stddev_pop(d) rows between 4 preceding and current row as sp",
]


@pytest.mark.parametrize("tile_rows", [1 << 10, 1 << 16])
@pytest.mark.parametrize("order", [["o"], ["o desc"]])
def test_window_functions(cuda, order, tile_rows):
    table = _data()
    ex = _both(lambda: PlanBuilder().table_scan(table).window(["g"], order, CALLS), tile_rows, cuda)
    assert (len(ex.window_chunks) > 1) == (tile_rows < table.num_rows)


def test_global_window_and_lowerings(cuda):
    table = _data(3000, seed=3)
    _both(lambda: PlanBuilder().table_scan(table).window([], ["o", "v"], CALLS[:12]), 1 << 10, cuda)
    _both(lambda: PlanBuilder().table_scan(table).topn_row_number(["g"], ["d desc"], 2), 1 << 10, cuda)
    _both(lambda: PlanBuilder().table_scan(table).row_number(["s"], limit=5), 1 << 10, cuda)
    _both(lambda: PlanBuilder().table_scan(table).mark_distinct("first", ["g", "s"]), 1 << 10, cuda)


@pytest.mark.parametrize("n", [1000, (1 << 20) + 3])
def test_window_primitives(cuda, n):
    gen = np.random.default_rng(n)
    values = gen.integers(-(1 << 40), 1 << 40, n)
    boundary = gen.random(n) < 0.01
    for op in ("first", "min", "max", "sum"):
        want = segmented.segmented_scan(torch.from_numpy(values), torch.from_numpy(boundary), op)
        got = segmented.segmented_scan(torch.from_numpy(values).to(cuda),
                                       torch.from_numpy(boundary).to(cuda), op)
        assert torch.equal(got.cpu(), want), op
    doubles = gen.normal(size=n)
    want = segmented.segmented_scan(torch.from_numpy(doubles), torch.from_numpy(boundary), "sum")
    got = segmented.segmented_scan(torch.from_numpy(doubles).to(cuda),
                                   torch.from_numpy(boundary).to(cuda), "sum")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-9, atol=1e-12)
    lo = gen.integers(-2, n, n)
    hi = lo + gen.integers(-2, 100, n)
    for op in ("min", "max"):
        ident = segmented.identity_for(op, torch.int64)
        table = segmented.sparse_table(torch.from_numpy(values), op)
        want = segmented.sparse_table_query(table, torch.from_numpy(lo), torch.from_numpy(hi), op, ident)
        table_d = segmented.sparse_table(torch.from_numpy(values).to(cuda), op)
        assert torch.equal(table_d.cpu(), table)
        got = segmented.sparse_table_query(table_d, torch.from_numpy(lo).to(cuda),
                                           torch.from_numpy(hi).to(cuda), op, ident)
        assert torch.equal(got.cpu(), want), op
    seg = np.sort(gen.integers(0, n // 50 + 1, n))
    keys = np.sort(gen.integers(0, 1000, n))
    order = np.lexsort((keys, seg))
    seg, keys = seg[order], keys[order]
    for inclusive in (False, True):
        args = [torch.from_numpy(a) for a in (seg, keys, seg, keys - 7)]
        want = segmented.rank_in_segments(*args, inclusive=inclusive)
        got = segmented.rank_in_segments(*[a.to(cuda) for a in args], inclusive=inclusive)
        assert torch.equal(got.cpu(), want)


def _sides(seed, n=4000, m=1500):
    rng = np.random.default_rng(seed)
    left = table_from_numpy(["k", "lx"], ["BIGINT", "BIGINT"],
                            {"k": rng.integers(0, 300, n), "lx": rng.integers(0, 1000, n)},
                            validities={"k": rng.random(n) < 0.95})
    right = table_from_numpy(["rk", "ry"], ["BIGINT", "BIGINT"],
                             {"rk": rng.integers(100, 500, m), "ry": rng.integers(0, 1000, m)},
                             validities={"rk": rng.random(m) < 0.95})
    return left, right


@pytest.mark.parametrize("tile_rows", [1 << 10, 1 << 14])
def test_full_joins(cuda, tile_rows):
    left, right = _sides(1)

    def full(filter_=None):
        return lambda: PlanBuilder().table_scan(left).hash_join(
            PlanBuilder().table_scan(right), ["k"], ["rk"], output=["k", "lx", "rk", "ry"],
            join_type="full", filter=filter_,
        )

    _both(full(), tile_rows, cuda, ordered=False)
    _both(full("lx < ry"), tile_rows, cuda, ordered=False)
    _both(lambda: full()().aggregation(["k"], ["count(ry) as c", "sum(lx) as s"]), tile_rows, cuda,
          ordered=False)
    _both(lambda: full()().orderby(["k nulls first", "rk", "lx", "ry"]), tile_rows, cuda)
    _both(lambda: PlanBuilder().table_scan(left).hash_join(
        PlanBuilder().table_scan(right), ["k"], ["rk"], output=["k", "lx"], join_type="anti",
        null_aware=True, filter="lx < ry"), tile_rows, cuda, ordered=False)


@pytest.mark.parametrize("jt", ["inner", "left", "right", "full"])
def test_nested_loop_joins(cuda, jt):
    left, right = _sides(2, n=300, m=40)
    _both(lambda: PlanBuilder().table_scan(left).nested_loop_join(
        PlanBuilder().table_scan(right).build(), ["lx", "ry"], jt, "lx > ry + 500"), 1 << 7, cuda,
        ordered=False)


def test_union_all_and_merge_exchange(cuda):
    left, right = _sides(3)
    _both(lambda: PlanBuilder().union_all([
        PlanBuilder().table_scan(left), PlanBuilder().table_scan(right)]).aggregation(
        ["k"], ["count(*) as c", "sum(lx) as s"]), 1 << 10, cuda, ordered=False)
    _both(lambda: PlanBuilder().merge_exchange([
        PlanBuilder().table_scan(left).orderby(["lx desc"]),
        PlanBuilder().table_scan(right).project(["rk as k", "ry as lx"]).orderby(["lx desc"]),
    ], ["lx desc"]), 1 << 10, cuda)


def _tpch(columns):
    from velox_tpu_torch.connectors.tpch import load_table

    return {t: load_table(t, SF, list(c)) for t, c in columns.items()}


@pytest.mark.parametrize("name", sorted(cs.WINDOW_SQL))
def test_tpch_texts(cuda, name):
    from velox_tpu_torch.connectors.tpch.queries import QUERY_COLUMNS

    columns = (QUERY_COLUMNS[cs.WINDOW_QUERY[name]] if name in cs.WINDOW_QUERY
               else cs.WINDOW_COLUMNS[name])
    tables = _tpch(columns)
    want = run_sql(cs.WINDOW_SQL[name], tables, tile_rows=1 << 12, device="cpu")
    got = run_sql(cs.WINDOW_SQL[name], tables, tile_rows=1 << 12, device=cuda)
    _same(got, want, ordered=False)
    if name not in cs.WINDOW_QUERY:
        cs.check_window_rows(got, *cs.window_oracle(name, tables))


@pytest.mark.parametrize("name", sorted(cs.WINDOW_PLAN_COLUMNS))
def test_tpch_plans(cuda, name):
    tables = _tpch(cs.WINDOW_PLAN_COLUMNS[name])
    got = LocalExecutor(cs.window_plan(name, PlanBuilder, tables), tile_rows=1 << 12,
                        device=cuda).run()
    want = LocalExecutor(cs.window_plan(name, PlanBuilder, tables), tile_rows=1 << 12,
                         device="cpu").run()
    _same(got, want)
    cs.check_window_rows(got, *cs.window_plan_oracle(name, tables))
