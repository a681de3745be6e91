"""The 22 TPC-H texts through the port's SQL front end (``run_sql``) at SF
0.01: the same rows as the port's hand-built plan and as the oracle
(mirrors ``tests/test_tpch_sql.py``), and the port's ``plan_sql`` builds the
same tree as the JAX package's for every text — node kinds, join types and
keys, grouping keys, aggregates and output columns."""

import numpy as np
import pandas as pd
import pytest

from velox_tpu.connectors.tpch import plans as ref_plans
from velox_tpu.sql import plan_sql as ref_plan_sql
from velox_tpu_torch.connectors.tpch import plans as port_plans
from velox_tpu_torch.connectors.tpch import queries as port_queries
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.sql import plan_sql, run_sql
from velox_tpu_torch.testing import table_from_numpy

SF = 0.01
TILE = 1 << 12
_CACHE = {}


def _carry_across(table):
    names = list(table.schema.names)
    return table_from_numpy(
        names,
        [str(t) for t in table.schema.types],
        {n: np.asarray(table.columns[n]) for n in names},
        {n: t.values() for n, t in table.string_tables.items()},
        {n: np.asarray(v) for n, v in table.validities.items()},
    )


def _tables(num):
    if num not in _CACHE:
        ref = ref_plans.load_query_tables(num, SF, cache_dir=None)
        _CACHE[num] = (ref, {k: _carry_across(t) for k, t in ref.items()})
    return _CACHE[num]


def _sorted(df):
    # row order can legitimately differ on sort ties: compare as sorted sets
    return df.sort_values(list(df.columns), kind="mergesort").reset_index(drop=True)


@pytest.mark.parametrize("num", sorted(port_queries.SQL))
def test_sql_matches_plan_and_oracle(num):
    _, tables = _tables(num)
    got = run_sql(port_queries.SQL[num], tables, tile_rows=TILE, device="cpu").to_pandas()
    plan = port_plans.build_query(num, tables, device="cpu")
    want = LocalExecutor(plan, tile_rows=TILE, device="cpu").run().to_pandas()
    if num in port_plans.ENGINE_OUTPUT_ORDER:
        want = want[port_plans.ENGINE_OUTPUT_ORDER[num]]
    assert set(got.columns) >= set(want.columns), (got.columns, want.columns)
    got = got[list(want.columns)]
    assert len(got) == len(want) > 0, f"Q{num}: {len(got)} vs {len(want)} rows"
    pd.testing.assert_frame_equal(_sorted(got), _sorted(want), check_dtype=False, rtol=1e-9)
    oracle = port_plans.oracle_result(num, tables).reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got.reset_index(drop=True)[list(oracle.columns)], oracle, check_dtype=False, rtol=1e-9
    )


def _shape(node):
    """The planning decisions of a tree, without node ids."""
    kind = type(node).__name__
    out = [kind, tuple(node.output_schema.names), tuple(str(t) for t in node.output_schema.types)]
    if kind == "HashJoinNode":
        out += [node.join_type.value, node.left_keys, node.right_keys,
                node.filter is not None, node.null_aware]
    elif kind == "AggregationNode":
        out += [node.grouping_keys, node.agg_names, tuple(c.name for c in node.aggregates)]
    elif kind in ("OrderByNode", "TopNNode"):
        out += [tuple((k.name, k.ascending, k.nulls_first) for k in node.keys),
                getattr(node, "count", None)]
    elif kind == "LimitNode":
        out += [node.offset, node.count]
    return (tuple(out), tuple(_shape(s) for s in node.sources))


@pytest.mark.parametrize("num", sorted(port_queries.SQL))
def test_plan_sql_builds_the_reference_tree(num):
    ref_tables, port_tables = _tables(num)
    text = port_queries.SQL[num]
    assert _shape(plan_sql(text, port_tables)) == _shape(ref_plan_sql(text, ref_tables))
