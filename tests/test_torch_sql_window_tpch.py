"""The TPC-H texts of the window and set-operation slice (``chip_smoke.py``
``WINDOW_SQL``: W1 and W2, TPC-H Q2 and Q15 with their subqueries written as
windows; W3 and W4, windows over every ``orders`` and ``lineitem`` row; F1
and F2, FULL joins plain and filtered; U1, UNION ALL; N1, a non-equi join)
and its two plans (``window_plan``: a MergeExchange and a
``topn_row_number``) at SF 0.01: through both packages' ``run_sql`` /
``LocalExecutor`` with small tiles, so that W4's window is cut into chunks
of whole partitions, and against the numpy oracles that ``chip_smoke.py``
holds the card's rows to.  Integers exactly, DOUBLE to rtol 1e-9."""

import numpy as np
import pandas as pd
import pytest

import chip_smoke as cs
from velox_tpu.connectors.tpch import load_table as ref_load_table
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.sql import run_sql as ref_run_sql
from velox_tpu_torch.connectors.tpch.plans import oracle_result
from velox_tpu_torch.connectors.tpch.queries import QUERY_COLUMNS
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.sql import run_sql
from velox_tpu_torch.testing import table_from_numpy

SF = 0.01
TILE = 1 << 12


def _carry_across(table):
    names = list(table.schema.names)
    return table_from_numpy(
        names,
        [str(t) for t in table.schema.types],
        {n: np.asarray(table.columns[n]) for n in names},
        {n: t.values() for n, t in table.string_tables.items()},
        {n: np.asarray(v) for n, v in table.validities.items()},
    )


def _tables(columns):
    ref = {t: ref_load_table(t, SF, list(c), cache_dir=None) for t, c in columns.items()}
    return ref, {t: _carry_across(v) for t, v in ref.items()}


def _sorted(df):
    return df.sort_values(list(df.columns), kind="mergesort").reset_index(drop=True)


@pytest.mark.parametrize("name", sorted(cs.WINDOW_SQL))
def test_text_matches_reference_and_oracle(name):
    text = cs.WINDOW_SQL[name]
    columns = (QUERY_COLUMNS[cs.WINDOW_QUERY[name]] if name in cs.WINDOW_QUERY
               else cs.WINDOW_COLUMNS[name])
    ref_tables, tables = _tables(columns)
    tile = TILE if name != "W4" else 1 << 14  # W4: 60 000 rows in chunks
    got = run_sql(text, tables, tile_rows=tile, device="cpu")
    want = ref_run_sql(text, ref_tables, tile_rows=tile).to_pandas()
    got_df = got.to_pandas()
    assert list(got_df.columns) == list(want.columns)
    assert len(got_df) == len(want) > 0
    pd.testing.assert_frame_equal(_sorted(got_df), _sorted(want), check_dtype=False, rtol=1e-9)
    if name in cs.WINDOW_QUERY:
        oracle = oracle_result(cs.WINDOW_QUERY[name], tables).reset_index(drop=True)
        pd.testing.assert_frame_equal(got_df[list(oracle.columns)].reset_index(drop=True), oracle,
                                      check_dtype=False, rtol=1e-9)
    else:
        cs.check_window_rows(got, *cs.window_oracle(name, tables))


def test_w4_runs_in_chunks_of_whole_partitions():
    """W4 over 4096-row tiles: several window passes, none splitting an
    order's line items, the rows those of one pass over everything."""
    from velox_tpu_torch.sql import plan_sql

    _, tables = _tables(cs.WINDOW_COLUMNS["W4"])
    plan = plan_sql(cs.WINDOW_SQL["W4"], tables)
    chunked = LocalExecutor(plan, tile_rows=1 << 12, device="cpu")
    rows = chunked.run()
    assert len(chunked.window_chunks) > 1
    assert sum(r for _, r in chunked.window_chunks) == tables["lineitem"].num_rows
    whole = LocalExecutor(plan, tile_rows=1 << 17, device="cpu")
    cs.check_window_rows(rows, *cs.window_oracle("W4", tables))
    cs.check_window_rows(whole.run(), *cs.window_oracle("W4", tables))
    assert len(whole.window_chunks) == 1


@pytest.mark.parametrize("name", sorted(cs.WINDOW_PLAN_COLUMNS))
def test_plan_matches_reference_and_oracle(name):
    ref_tables, tables = _tables(cs.WINDOW_PLAN_COLUMNS[name])
    want = RefExecutor(cs.window_plan(name, RefBuilder, ref_tables), tile_rows=TILE).run()
    got = LocalExecutor(cs.window_plan(name, PlanBuilder, tables), tile_rows=TILE, device="cpu").run()
    # the merge keeps an order, so both frames are compared as they come
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas(), check_dtype=False)
    cs.check_window_rows(got, *cs.window_plan_oracle(name, tables))
