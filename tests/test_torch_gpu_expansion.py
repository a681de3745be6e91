"""The paths of the 22-query slice on the card against the same plans on the
CPU: the last-flagged-row helper that replaced the running scans, the
expansion (N:M) join and its spans, the constant-key cross join, a filter on
an N:M LEFT join, scalar subqueries (``EnforceSingleRow``), ``count(distinct
...)``, filtered semi / anti joins, and TPC-H texts that take them through
``run_sql``.  The CPU tests hold the same code against the JAX package; what
only a CUDA device shows is that every call exists there and gives the same
rows (the helper's scatter, for one, writes many rows to one spare slot).
Skipped where there is no CUDA device; run with
``python -m pytest tests/test_torch_gpu_expansion.py -m gpu``.

Integers, dates, dictionary codes and masks exact; DOUBLE rtol 1e-9."""

import numpy as np
import pandas as pd
import pytest
import torch

from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.ops import segmented, segpool
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _same(got, want):
    assert list(got.schema.names) == list(want.schema.names)
    assert got.num_rows == want.num_rows
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        if dtype.is_floating:
            np.testing.assert_allclose(g, w, rtol=1e-9, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
        gv, wv = got.validities.get(name), want.validities.get(name)
        ones = np.ones(want.num_rows, bool)
        np.testing.assert_array_equal(ones if gv is None else gv, ones if wv is None else wv)


@pytest.mark.parametrize("n", [1, 1000, 1 << 20])
def test_last_and_next_flagged(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    flags = torch.rand(n, generator=gen, device=cuda) < 0.1
    values = torch.cumsum(torch.randint(0, 3, (n,), generator=gen, device=cuda), 0)
    masked = torch.where(flags, values, torch.full_like(values, -1))
    assert torch.equal(segmented.last_flagged(flags, values, -1), torch.cummax(masked, 0).values)
    big = int(values.max()) + 1
    masked = torch.where(flags, values, torch.full_like(values, big))
    want = torch.cummin(masked.flip(0), 0).values.flip(0)
    assert torch.equal(segmented.next_flagged(flags, values, big), want)


def test_owner_rows(cuda):
    sizes = torch.randint(0, 5, (5000,), generator=torch.Generator().manual_seed(1))
    starts = segpool.dense_starts(sizes)
    cap = 1 << int(int(sizes.sum())).bit_length()
    got = segpool.owner_rows(starts.to(cuda), cap)
    assert torch.equal(got.cpu(), segpool.owner_rows(starts, cap))


def _pair_tables():
    rng = np.random.default_rng(7)
    n, m = 6000, 900
    left = table_from_numpy(
        ["k", "lx", "tag"], ["BIGINT", "BIGINT", "VARCHAR"],
        {"k": rng.integers(0, 300, n), "lx": rng.integers(0, 1000, n),
         "tag": rng.integers(1, 4, n).astype(np.int32)},
        {"tag": ["", "red", "blue", "green"]},
        {"k": rng.random(n) < 0.95},
    )
    right = table_from_numpy(
        ["rk", "ry", "rd"], ["BIGINT", "BIGINT", "DOUBLE"],
        {"rk": rng.integers(0, 300, m), "ry": rng.integers(0, 1000, m), "rd": rng.normal(size=m)},
        validities={"ry": rng.random(m) < 0.9},
    )
    return left, right


def _plans(left, right):
    scan_l = lambda: PlanBuilder().table_scan(left)  # noqa: E731
    scan_r = lambda: PlanBuilder().table_scan(right)  # noqa: E731
    total = scan_r().aggregation([], ["sum(ry) as t"]).enforce_single_row()
    return {
        "inner": scan_l().hash_join(scan_r(), ["k"], ["rk"], output=["k", "lx", "tag", "ry", "rd"]),
        "left": scan_l().hash_join(scan_r(), ["k"], ["rk"], output=["k", "tag", "ry"], join_type="left"),
        "into_aggregation": scan_l().hash_join(scan_r(), ["k"], ["rk"], output=["k", "ry", "rd"])
        .aggregation(["k"], ["count(ry) as c", "sum(ry) as s", "sum(rd) as d"]),
        "left_filter_nm": scan_l().hash_join(
            scan_r(), ["k"], ["rk"], output=["k", "lx", "ry"], join_type="left", filter="lx > ry"
        ),
        "semi_filter": scan_l().hash_join(
            scan_r(), ["k"], ["rk"], output=["k", "lx"], join_type="left_semi", filter="lx > ry"
        ),
        "anti_filter": scan_l().hash_join(
            scan_r(), ["k"], ["rk"], output=["k", "lx"], join_type="anti", filter="lx > ry"
        ),
        "cross_single_row": scan_l().cross_join(total, output=["k", "lx", "t"], filter="lx > 500"),
        "count_distinct": scan_l().aggregation(["tag"], ["count(distinct k) as nk", "count(*) as n"]),
    }


CASES = ["inner", "left", "into_aggregation", "left_filter_nm", "semi_filter", "anti_filter",
         "cross_single_row", "count_distinct"]


@pytest.mark.parametrize("tile_rows", [1 << 10, 1 << 14])
@pytest.mark.parametrize("case", CASES)
def test_plans_on_the_card(cuda, case, tile_rows):
    plan = _plans(*_pair_tables())[case]
    keys = [f"{n} nulls first" for n in plan.schema.names]
    plan = plan.orderby(keys).build()
    got = LocalExecutor(plan, tile_rows=tile_rows, device=cuda).run()
    want = LocalExecutor(plan, tile_rows=tile_rows, device="cpu").run()
    _same(got, want)
    assert want.num_rows > 0


@pytest.mark.parametrize("num", [3, 11, 13, 15, 16, 21, 22])
def test_tpch_texts_on_the_card(cuda, num):
    from velox_tpu_torch.connectors.tpch import plans
    from velox_tpu_torch.connectors.tpch.queries import SQL
    from velox_tpu_torch.sql import run_sql

    tables = plans.load_query_tables(num, 0.01)
    got = run_sql(SQL[num], tables, tile_rows=1 << 12, device=cuda)
    _same(got, run_sql(SQL[num], tables, tile_rows=1 << 12, device="cpu"))
    oracle = plans.oracle_result(num, tables).reset_index(drop=True)
    frame = got.to_pandas()[list(oracle.columns)].reset_index(drop=True)
    pd.testing.assert_frame_equal(frame, oracle, check_dtype=False, rtol=1e-9)
    # the plan-time fragment of the hand-built plan runs on the card too
    plan = plans.build_query(num, tables, device=cuda)
    _same(LocalExecutor(plan, tile_rows=1 << 12, device=cuda).run(),
          LocalExecutor(plan, tile_rows=1 << 12, device="cpu").run())
