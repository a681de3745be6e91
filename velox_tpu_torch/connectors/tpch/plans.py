"""TPC-H physical plan construction.

Counterpart of the JAX package's ``connectors/tpch/plans.py`` for the queries
this package runs so far (Q1, Q3, Q6, Q13).  Reference:
velox/exec/tests/utils/TpchQueryBuilder.h:61 — fully-specified physical plans
(the engine ships no optimizer, like the reference).  The other eighteen plans
come with the operators they need (expansion joins, FULL joins, filtered
joins, scalar subqueries); ``build_query`` raises ``NotImplementedError`` for
them.
"""

from __future__ import annotations

from typing import Dict

import pandas as pd

from ...exec import run_plan
from ...io.table import Table
from ...plan import PlanBuilder, PlanNode
from . import load_table
from . import queries as _q
from .queries import Q1_COLUMNS, Q6_COLUMNS, QUERY_COLUMNS


def build_q1(lineitem: Table) -> PlanNode:
    return (
        PlanBuilder()
        .table_scan(
            lineitem,
            columns=Q1_COLUMNS,
            filter="l_shipdate <= date '1998-12-01' - interval '90' day",
        )
        .aggregation(
            ["l_returnflag", "l_linestatus"],
            [
                "sum(l_quantity) as sum_qty",
                "sum(l_extendedprice) as sum_base_price",
                "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price",
                "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge",
                "avg(l_quantity) as avg_qty",
                "avg(l_extendedprice) as avg_price",
                "avg(l_discount) as avg_disc",
                "count(*) as count_order",
            ],
        )
        .orderby(["l_returnflag", "l_linestatus"])
        .build()
    )


def build_q3(customer: Table, orders: Table, lineitem: Table) -> PlanNode:
    building = (
        PlanBuilder()
        .table_scan(customer, filter="c_mktsegment = 'BUILDING'")
        .project(["c_custkey"])
    )
    orders_build = (
        PlanBuilder()
        .table_scan(orders, filter="o_orderdate < date '1995-03-15'")
        .hash_join(
            building,
            ["o_custkey"],
            ["c_custkey"],
            output=["o_orderkey", "o_orderdate", "o_shippriority"],
            join_type="left_semi",
        )
    )
    return (
        PlanBuilder()
        .table_scan(lineitem, filter="l_shipdate > date '1995-03-15'")
        .hash_join(
            orders_build,
            ["l_orderkey"],
            ["o_orderkey"],
            output=[
                "l_orderkey",
                "l_extendedprice",
                "l_discount",
                "o_orderdate",
                "o_shippriority",
            ],
        )
        .aggregation(
            ["l_orderkey", "o_orderdate", "o_shippriority"],
            ["sum(l_extendedprice * (1 - l_discount)) as revenue"],
        )
        .topn(["revenue desc", "o_orderdate", "l_orderkey"], 10)
        .build()
    )


def build_q6(lineitem: Table) -> PlanNode:
    return (
        PlanBuilder()
        .table_scan(
            lineitem,
            columns=Q6_COLUMNS,
            filter=(
                "l_shipdate >= date '1994-01-01' "
                "and l_shipdate < date '1994-01-01' + interval '365' day "
                "and l_discount between 0.05 and 0.07 and l_quantity < 24"
            ),
        )
        .aggregation([], ["sum(l_extendedprice * l_discount) as revenue"])
        .build()
    )


def build_q13(customer: Table, orders: Table) -> PlanNode:
    counts = (
        PlanBuilder()
        .table_scan(orders, filter="o_comment not like '%special%requests%'")
        .aggregation(["o_custkey"], ["count(*) as cnt"])
    )
    return (
        PlanBuilder()
        .table_scan(customer)
        .hash_join(
            counts,
            ["c_custkey"],
            ["o_custkey"],
            output=["c_custkey", "cnt"],
            join_type="left",
        )
        .project(["coalesce(cnt, 0) as c_count"])
        .aggregation(["c_count"], ["count(*) as custdist"])
        .orderby(["custdist desc", "c_count desc"])
        .build()
    )


_BUILDERS = {
    1: (build_q1, ["lineitem"]),
    3: (build_q3, ["customer", "orders", "lineitem"]),
    6: (build_q6, ["lineitem"]),
    13: (build_q13, ["customer", "orders"]),
}

# engine column order may differ from the oracle's; map for comparison
ENGINE_OUTPUT_ORDER = {
    3: ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"],
}


def implemented_queries():
    return sorted(_BUILDERS)


def _builder(num: int):
    if num not in _BUILDERS:
        raise NotImplementedError(
            f"TPC-H Q{num} is not ported yet (implemented: {implemented_queries()})"
        )
    return _BUILDERS[num]


def load_query_tables(num: int, sf: float) -> Dict[str, Table]:
    _builder(num)
    return {t: load_table(t, sf, c) for t, c in QUERY_COLUMNS[num].items()}


def build_query(num: int, tables: Dict[str, Table]) -> PlanNode:
    fn, names = _builder(num)
    return fn(*[tables[n] for n in names])


def oracle_result(num: int, tables: Dict[str, Table]) -> pd.DataFrame:
    _, names = _builder(num)
    fn = getattr(_q, f"q{num}_oracle")
    return fn(*[tables[n] for n in names])


def run_query(num: int, sf: float, tile_rows: int = 1 << 20, stats=None, device=None):
    """Run a TPC-H query end-to-end; returns (engine_df, oracle_df)."""
    tables = load_query_tables(num, sf)
    plan = build_query(num, tables)
    result = run_plan(plan, tile_rows=tile_rows, stats=stats, device=device).to_pandas()
    if num in ENGINE_OUTPUT_ORDER:
        result = result[ENGINE_OUTPUT_ORDER[num]]
    return result.reset_index(drop=True), oracle_result(num, tables)
