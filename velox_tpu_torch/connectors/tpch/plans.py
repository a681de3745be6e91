"""TPC-H physical plan construction.

Counterpart of the JAX package's ``connectors/tpch/plans.py`` (a copy of its
22 builders).  Reference: velox/exec/tests/utils/TpchQueryBuilder.h:61 —
fully-specified physical plans for all 22 TPC-H queries (the engine ships no
optimizer, like the reference; correlated subqueries are hand-decorrelated
into joins + aggregations, the way the reference's TpchQueryBuilder writes
them).

Recurring shapes:
* semi/anti joins carry IN / EXISTS / NOT EXISTS subqueries (Q4 Q8 Q16 Q20-22);
* scalar subqueries run as a separate plan fragment first and embed as typed
  constants (Q11 Q15 Q22), mirroring a coordinator's multi-fragment execution.
  The fragment runs while the plan is built, on the device ``build_query`` is
  given (None: the CUDA device, which raises without one);
* avg-comparisons rewrite to exact integer cross-multiplication, so decimal
  parity with the oracle is bit-exact (Q17 Q20 Q22);
* count(distinct x) is a dedupe aggregation feeding a count aggregation
  (Q16, and Q21's per-order distinct-supplier counts).
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


def build_q2(region: Table, nation: Table, supplier: Table, partsupp: Table, part: Table) -> PlanNode:
    nation_eu = (
        PlanBuilder()
        .table_scan(nation)
        .hash_join(
            PlanBuilder().table_scan(region, filter="r_name = 'EUROPE'"),
            ["n_regionkey"],
            ["r_regionkey"],
            output=["n_nationkey", "n_name"],
            join_type="left_semi",
        )
    )
    supplier_eu = (
        PlanBuilder()
        .table_scan(supplier)
        .hash_join(
            nation_eu,
            ["s_nationkey"],
            ["n_nationkey"],
            output=[
                "s_suppkey", "s_acctbal", "s_name", "n_name", "s_address",
                "s_phone", "s_comment",
            ],
        )
    )
    part_f = (
        PlanBuilder()
        .table_scan(part, filter="p_size = 15 and p_type like '%BRASS'")
        .project(["p_partkey", "p_mfgr"])
    )

    def ps_parts() -> PlanBuilder:
        return (
            PlanBuilder()
            .table_scan(partsupp)
            .hash_join(
                supplier_eu,
                ["ps_suppkey"],
                ["s_suppkey"],
                output=[
                    "ps_partkey", "ps_supplycost", "s_acctbal", "s_name",
                    "n_name", "s_address", "s_phone", "s_comment",
                ],
            )
            .hash_join(
                part_f,
                ["ps_partkey"],
                ["p_partkey"],
                output=[
                    "ps_partkey", "ps_supplycost", "s_acctbal", "s_name",
                    "n_name", "s_address", "s_phone", "s_comment", "p_mfgr",
                ],
            )
        )

    min_cost = ps_parts().aggregation(
        ["ps_partkey"], ["min(ps_supplycost) as min_cost"]
    )
    return (
        ps_parts()
        .hash_join(
            min_cost,
            ["ps_partkey"],
            ["ps_partkey"],
            output=[
                "ps_partkey", "ps_supplycost", "min_cost", "s_acctbal",
                "s_name", "n_name", "s_address", "s_phone", "s_comment",
                "p_mfgr",
            ],
        )
        .filter("ps_supplycost = min_cost")
        .project(
            [
                "s_acctbal", "s_name", "n_name", "ps_partkey as p_partkey",
                "p_mfgr", "s_address", "s_phone", "s_comment",
            ]
        )
        .topn(["s_acctbal desc", "n_name", "s_name", "p_partkey"], 100)
        .build()
    )


def build_q4(orders: Table, lineitem: Table) -> PlanNode:
    late = (
        PlanBuilder()
        .table_scan(lineitem, filter="l_commitdate < l_receiptdate")
        .project(["l_orderkey"])
    )
    return (
        PlanBuilder()
        .table_scan(
            orders,
            filter=(
                "o_orderdate >= date '1993-07-01' "
                "and o_orderdate < date '1993-10-01'"
            ),
        )
        .hash_join(
            late, ["o_orderkey"], ["l_orderkey"],
            output=["o_orderpriority"], join_type="left_semi",
        )
        .aggregation(["o_orderpriority"], ["count(*) as order_count"])
        .orderby(["o_orderpriority"])
        .build()
    )


def build_q5(region, nation, supplier, customer, orders, lineitem) -> PlanNode:
    nation_asia = (
        PlanBuilder()
        .table_scan(nation)
        .hash_join(
            PlanBuilder().table_scan(region, filter="r_name = 'ASIA'"),
            ["n_regionkey"],
            ["r_regionkey"],
            output=["n_nationkey", "n_name"],
            join_type="left_semi",
        )
    )
    supplier_asia = (
        PlanBuilder()
        .table_scan(supplier)
        .hash_join(
            nation_asia,
            ["s_nationkey"],
            ["n_nationkey"],
            output=["s_suppkey", "s_nationkey", "n_name"],
        )
    )
    orders_cust = (
        PlanBuilder()
        .table_scan(
            orders,
            filter=(
                "o_orderdate >= date '1994-01-01' "
                "and o_orderdate < date '1995-01-01'"
            ),
        )
        .hash_join(
            PlanBuilder().table_scan(customer),
            ["o_custkey"],
            ["c_custkey"],
            output=["o_orderkey", "c_nationkey"],
        )
    )
    return (
        PlanBuilder()
        .table_scan(lineitem)
        .hash_join(
            orders_cust,
            ["l_orderkey"],
            ["o_orderkey"],
            output=["l_suppkey", "l_extendedprice", "l_discount", "c_nationkey"],
        )
        .hash_join(
            supplier_asia,
            ["l_suppkey"],
            ["s_suppkey"],
            output=[
                "l_extendedprice", "l_discount", "c_nationkey", "s_nationkey",
                "n_name",
            ],
        )
        .filter("c_nationkey = s_nationkey")
        .aggregation(
            ["n_name"], ["sum(l_extendedprice * (1 - l_discount)) as revenue"]
        )
        .orderby(["revenue desc"])
        .build()
    )


def build_q7(nation, supplier, customer, orders, lineitem) -> PlanNode:
    nation2 = PlanBuilder().table_scan(
        nation, filter="n_name in ('FRANCE', 'GERMANY')"
    )
    supplier_n = (
        PlanBuilder()
        .table_scan(supplier)
        .hash_join(
            nation2, ["s_nationkey"], ["n_nationkey"],
            output=["s_suppkey", "n_name"],
        )
        .project(["s_suppkey", "n_name as supp_nation"])
    )
    customer_n = (
        PlanBuilder()
        .table_scan(customer)
        .hash_join(
            nation2, ["c_nationkey"], ["n_nationkey"],
            output=["c_custkey", "n_name"],
        )
        .project(["c_custkey", "n_name as cust_nation"])
    )
    orders_c = (
        PlanBuilder()
        .table_scan(orders)
        .hash_join(
            customer_n, ["o_custkey"], ["c_custkey"],
            output=["o_orderkey", "cust_nation"],
        )
    )
    return (
        PlanBuilder()
        .table_scan(
            lineitem,
            filter=(
                "l_shipdate >= date '1995-01-01' "
                "and l_shipdate <= date '1996-12-31'"
            ),
        )
        .hash_join(
            orders_c, ["l_orderkey"], ["o_orderkey"],
            output=[
                "l_suppkey", "l_shipdate", "l_extendedprice", "l_discount",
                "cust_nation",
            ],
        )
        .hash_join(
            supplier_n, ["l_suppkey"], ["s_suppkey"],
            output=[
                "l_shipdate", "l_extendedprice", "l_discount", "cust_nation",
                "supp_nation",
            ],
        )
        .filter("supp_nation <> cust_nation")
        .project(
            [
                "supp_nation", "cust_nation", "year(l_shipdate) as l_year",
                "l_extendedprice * (1 - l_discount) as volume",
            ]
        )
        .aggregation(
            ["supp_nation", "cust_nation", "l_year"],
            ["sum(volume) as revenue"],
        )
        .orderby(["supp_nation", "cust_nation", "l_year"])
        .build()
    )


def build_q8(region, nation, customer, orders, supplier, part, lineitem) -> PlanNode:
    nation_am = (
        PlanBuilder()
        .table_scan(nation, columns=["n_nationkey", "n_regionkey"])
        .hash_join(
            PlanBuilder().table_scan(region, filter="r_name = 'AMERICA'"),
            ["n_regionkey"], ["r_regionkey"],
            output=["n_nationkey"], join_type="left_semi",
        )
    )
    customer_am = (
        PlanBuilder()
        .table_scan(customer)
        .hash_join(
            nation_am, ["c_nationkey"], ["n_nationkey"],
            output=["c_custkey"], join_type="left_semi",
        )
    )
    orders_f = (
        PlanBuilder()
        .table_scan(
            orders,
            filter=(
                "o_orderdate >= date '1995-01-01' "
                "and o_orderdate <= date '1996-12-31'"
            ),
        )
        .hash_join(
            customer_am, ["o_custkey"], ["c_custkey"],
            output=["o_orderkey", "o_orderdate"], join_type="left_semi",
        )
    )
    part_f = (
        PlanBuilder()
        .table_scan(part, filter="p_type = 'ECONOMY ANODIZED STEEL'")
        .project(["p_partkey"])
    )
    supplier_n = (
        PlanBuilder()
        .table_scan(supplier)
        .hash_join(
            PlanBuilder().table_scan(nation, columns=["n_nationkey", "n_name"]),
            ["s_nationkey"], ["n_nationkey"],
            output=["s_suppkey", "n_name"],
        )
        .project(["s_suppkey", "n_name as nation"])
    )
    return (
        PlanBuilder()
        .table_scan(lineitem)
        .hash_join(
            part_f, ["l_partkey"], ["p_partkey"],
            output=["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"],
            join_type="left_semi",
        )
        .hash_join(
            orders_f, ["l_orderkey"], ["o_orderkey"],
            output=["l_suppkey", "l_extendedprice", "l_discount", "o_orderdate"],
        )
        .hash_join(
            supplier_n, ["l_suppkey"], ["s_suppkey"],
            output=["l_extendedprice", "l_discount", "o_orderdate", "nation"],
        )
        .project(
            [
                "year(o_orderdate) as o_year",
                "l_extendedprice * (1 - l_discount) as volume",
                "nation",
            ]
        )
        .project(
            [
                "o_year", "volume",
                "volume * (case when nation = 'BRAZIL' then 1 else 0 end)"
                " as brazil_volume",
            ]
        )
        .aggregation(
            ["o_year"],
            ["sum(brazil_volume) as sb", "sum(volume) as sv"],
        )
        .project(
            ["o_year", "cast(sb as double) / cast(sv as double) as mkt_share"]
        )
        .orderby(["o_year"])
        .build()
    )


def build_q11(nation, supplier, partsupp, device=None) -> PlanNode:
    from ...dtypes import BOOLEAN
    from ...expr.ir import Call, Constant, FieldAccess
    from ...plan.nodes import FilterNode

    supplier_de = (
        PlanBuilder()
        .table_scan(supplier)
        .hash_join(
            PlanBuilder().table_scan(nation, filter="n_name = 'GERMANY'"),
            ["s_nationkey"], ["n_nationkey"],
            output=["s_suppkey"], join_type="left_semi",
        )
    )

    def base() -> PlanBuilder:
        return (
            PlanBuilder()
            .table_scan(partsupp)
            .hash_join(
                supplier_de, ["ps_suppkey"], ["s_suppkey"],
                output=["ps_partkey", "ps_supplycost", "ps_availqty"],
                join_type="left_semi",
            )
            .project(["ps_partkey", "ps_supplycost * ps_availqty as v"])
        )

    total_table = run_plan(
        base().aggregation([], ["sum(v) as total"]).build(), device=device
    )
    total = int(total_table.columns["total"][0])
    nsupp = supplier.num_rows  # 10000 * SF, so total/nsupp = total * 0.0001/SF
    thr = total // nsupp

    pb = base().aggregation(["ps_partkey"], ["sum(v) as value"])
    value_t = pb.schema.type_of("value")
    pb.node = FilterNode(
        pb.node,
        Call(
            BOOLEAN, "gt",
            (FieldAccess(value_t, "value"), Constant(value_t, thr)),
        ),
    )
    return pb.orderby(["value desc", "ps_partkey"]).build()


def build_q12(orders, lineitem) -> PlanNode:
    return (
        PlanBuilder()
        .table_scan(
            lineitem,
            filter=(
                "l_shipmode in ('MAIL', 'SHIP') "
                "and l_commitdate < l_receiptdate "
                "and l_shipdate < l_commitdate "
                "and l_receiptdate >= date '1994-01-01' "
                "and l_receiptdate < date '1995-01-01'"
            ),
        )
        .hash_join(
            PlanBuilder().table_scan(orders),
            ["l_orderkey"], ["o_orderkey"],
            output=["l_shipmode", "o_orderpriority"],
        )
        .project(
            [
                "l_shipmode",
                "case when o_orderpriority in ('1-URGENT', '2-HIGH') "
                "then 1 else 0 end as high",
                "case when o_orderpriority in ('1-URGENT', '2-HIGH') "
                "then 0 else 1 end as low",
            ]
        )
        .aggregation(
            ["l_shipmode"],
            ["sum(high) as high_line_count", "sum(low) as low_line_count"],
        )
        .orderby(["l_shipmode"])
        .build()
    )


def build_q14(part, lineitem) -> PlanNode:
    return (
        PlanBuilder()
        .table_scan(
            lineitem,
            filter=(
                "l_shipdate >= date '1995-09-01' "
                "and l_shipdate < date '1995-10-01'"
            ),
        )
        .hash_join(
            PlanBuilder().table_scan(part),
            ["l_partkey"], ["p_partkey"],
            output=["l_extendedprice", "l_discount", "p_type"],
        )
        .project(
            [
                "l_extendedprice * (1 - l_discount) as volume",
                "p_type",
            ]
        )
        .project(
            [
                "volume",
                "volume * (case when p_type like 'PROMO%' then 1 else 0 end)"
                " as promo_volume",
            ]
        )
        .aggregation([], ["sum(promo_volume) as sp", "sum(volume) as sv"])
        .project(
            [
                "cast(100 as double) * (cast(sp as double) / cast(sv as double))"
                " as promo_revenue"
            ]
        )
        .build()
    )


def build_q9(part, supplier, nation, partsupp, orders, lineitem) -> PlanNode:
    part_green = (
        PlanBuilder()
        .table_scan(part, filter="p_name like '%green%'")
        .project(["p_partkey"])
    )
    supplier_n = (
        PlanBuilder()
        .table_scan(supplier)
        .hash_join(
            PlanBuilder().table_scan(nation),
            ["s_nationkey"],
            ["n_nationkey"],
            output=["s_suppkey", "n_name"],
        )
    )
    return (
        PlanBuilder()
        .table_scan(lineitem)
        .hash_join(
            part_green, ["l_partkey"], ["p_partkey"],
            output=[
                "l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                "l_extendedprice", "l_discount",
            ],
            join_type="left_semi",
        )
        .hash_join(
            supplier_n, ["l_suppkey"], ["s_suppkey"],
            output=[
                "l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                "l_extendedprice", "l_discount", "n_name",
            ],
        )
        .hash_join(
            PlanBuilder().table_scan(partsupp),
            ["l_partkey", "l_suppkey"],
            ["ps_partkey", "ps_suppkey"],
            output=[
                "l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
                "n_name", "ps_supplycost",
            ],
        )
        .hash_join(
            PlanBuilder().table_scan(orders),
            ["l_orderkey"],
            ["o_orderkey"],
            output=[
                "l_quantity", "l_extendedprice", "l_discount", "n_name",
                "ps_supplycost", "o_orderdate",
            ],
        )
        .project(
            [
                "n_name as nation",
                "year(o_orderdate) as o_year",
                "l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity"
                " as amount",
            ]
        )
        .aggregation(["nation", "o_year"], ["sum(amount) as sum_profit"])
        .orderby(["nation", "o_year desc"])
        .build()
    )


def build_q10(customer, orders, lineitem, nation) -> PlanNode:
    orders_f = (
        PlanBuilder()
        .table_scan(
            orders,
            filter=(
                "o_orderdate >= date '1993-10-01' "
                "and o_orderdate < date '1994-01-01'"
            ),
        )
        .project(["o_orderkey", "o_custkey"])
    )
    customer_n = (
        PlanBuilder()
        .table_scan(customer)
        .hash_join(
            PlanBuilder().table_scan(nation),
            ["c_nationkey"],
            ["n_nationkey"],
            output=[
                "c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                "c_address", "c_comment",
            ],
        )
    )
    return (
        PlanBuilder()
        .table_scan(lineitem, filter="l_returnflag = 'R'")
        .hash_join(
            orders_f, ["l_orderkey"], ["o_orderkey"],
            output=["l_extendedprice", "l_discount", "o_custkey"],
        )
        .aggregation(
            ["o_custkey"],
            ["sum(l_extendedprice * (1 - l_discount)) as revenue"],
        )
        .hash_join(
            customer_n, ["o_custkey"], ["c_custkey"],
            output=[
                "c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
                "c_address", "c_phone", "c_comment",
            ],
        )
        .topn(["revenue desc", "c_custkey"], 20)
        .build()
    )


def build_q15(supplier: Table, lineitem: Table, device=None) -> PlanNode:
    from ...dtypes import BOOLEAN
    from ...expr.ir import Call, Constant, FieldAccess
    from ...plan.nodes import FilterNode

    rev = run_plan(
        PlanBuilder()
        .table_scan(
            lineitem,
            filter=(
                "l_shipdate >= date '1996-01-01' "
                "and l_shipdate < date '1996-04-01'"
            ),
        )
        .aggregation(
            ["l_suppkey"],
            ["sum(l_extendedprice * (1 - l_discount)) as total_revenue"],
        )
        .build(),
        device=device,
    )
    maxv = int(rev.columns["total_revenue"].max())
    pb = PlanBuilder().values(rev)
    t = pb.schema.type_of("total_revenue")
    pb.node = FilterNode(
        pb.node,
        Call(
            BOOLEAN, "eq",
            (FieldAccess(t, "total_revenue"), Constant(t, maxv)),
        ),
    )
    return (
        pb.hash_join(
            PlanBuilder().table_scan(supplier),
            ["l_suppkey"], ["s_suppkey"],
            output=["s_suppkey", "s_name", "s_address", "s_phone", "total_revenue"],
        )
        .orderby(["s_suppkey"])
        .build()
    )


def build_q16(part: Table, partsupp: Table, supplier: Table) -> PlanNode:
    part_f = PlanBuilder().table_scan(
        part,
        filter=(
            "p_brand <> 'Brand#45' "
            "and p_type not like 'MEDIUM POLISHED%' "
            "and p_size in (49, 14, 23, 45, 19, 3, 36, 9)"
        ),
    )
    complaints = (
        PlanBuilder()
        .table_scan(supplier, filter="s_comment like '%Customer%Complaints%'")
        .project(["s_suppkey"])
    )
    return (
        PlanBuilder()
        .table_scan(partsupp)
        .hash_join(
            part_f, ["ps_partkey"], ["p_partkey"],
            output=["p_brand", "p_type", "p_size", "ps_suppkey"],
        )
        .hash_join(
            complaints, ["ps_suppkey"], ["s_suppkey"],
            output=["p_brand", "p_type", "p_size", "ps_suppkey"],
            join_type="anti",
        )
        # count(distinct ps_suppkey): dedupe pass, then count per group
        .aggregation(
            ["p_brand", "p_type", "p_size", "ps_suppkey"], ["count(*) as _c"]
        )
        .aggregation(
            ["p_brand", "p_type", "p_size"], ["count(*) as supplier_cnt"]
        )
        .orderby(["supplier_cnt desc", "p_brand", "p_type", "p_size"])
        .build()
    )


def build_q17(part: Table, lineitem: Table) -> PlanNode:
    part_f = (
        PlanBuilder()
        .table_scan(
            part, filter="p_brand = 'Brand#23' and p_container = 'MED BOX'"
        )
        .project(["p_partkey"])
    )

    def li_p() -> PlanBuilder:
        return (
            PlanBuilder()
            .table_scan(lineitem)
            .hash_join(
                part_f, ["l_partkey"], ["p_partkey"],
                output=["l_partkey", "l_quantity", "l_extendedprice"],
                join_type="left_semi",
            )
        )

    stats = li_p().aggregation(
        ["l_partkey"], ["sum(l_quantity) as sq", "count(*) as cq"]
    )
    return (
        li_p()
        .hash_join(
            stats, ["l_partkey"], ["l_partkey"],
            output=["l_quantity", "l_extendedprice", "sq", "cq"],
        )
        # l_quantity < 0.2 * avg(qty)  <=>  qty * 5 * count < sum  (exact ints)
        .filter("l_quantity * 5 * cq < sq")
        .aggregation([], ["sum(l_extendedprice) as s"])
        .project(["cast(s as double) / cast(7 as double) as avg_yearly"])
        .build()
    )


def build_q18(customer: Table, orders: Table, lineitem: Table) -> PlanNode:
    return (
        PlanBuilder()
        .table_scan(lineitem)
        .aggregation(["l_orderkey"], ["sum(l_quantity) as sum_qty"])
        .filter("sum_qty > 300")
        .hash_join(
            PlanBuilder().table_scan(orders),
            ["l_orderkey"], ["o_orderkey"],
            output=["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice", "sum_qty"],
        )
        .hash_join(
            PlanBuilder().table_scan(customer),
            ["o_custkey"], ["c_custkey"],
            output=[
                "c_name", "c_custkey", "o_orderkey", "o_orderdate",
                "o_totalprice", "sum_qty",
            ],
        )
        .topn(["o_totalprice desc", "o_orderdate", "o_orderkey"], 100)
        .build()
    )


def build_q19(part: Table, lineitem: Table) -> PlanNode:
    return (
        PlanBuilder()
        .table_scan(
            lineitem,
            filter=(
                "l_shipinstruct = 'DELIVER IN PERSON' "
                "and l_shipmode in ('AIR', 'AIR REG') "
                "and l_quantity >= 1 and l_quantity <= 30"
            ),
        )
        .hash_join(
            PlanBuilder().table_scan(part),
            ["l_partkey"], ["p_partkey"],
            output=[
                "l_quantity", "l_extendedprice", "l_discount", "p_brand",
                "p_container", "p_size",
            ],
        )
        .filter(
            "(p_brand = 'Brand#12'"
            " and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')"
            " and l_quantity >= 1 and l_quantity <= 11"
            " and p_size >= 1 and p_size <= 5)"
            " or (p_brand = 'Brand#23'"
            " and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')"
            " and l_quantity >= 10 and l_quantity <= 20"
            " and p_size >= 1 and p_size <= 10)"
            " or (p_brand = 'Brand#34'"
            " and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')"
            " and l_quantity >= 20 and l_quantity <= 30"
            " and p_size >= 1 and p_size <= 15)"
        )
        .aggregation(
            [], ["sum(l_extendedprice * (1 - l_discount)) as revenue"]
        )
        .build()
    )


def build_q20(part, partsupp, lineitem, supplier, nation) -> PlanNode:
    part_forest = (
        PlanBuilder()
        .table_scan(part, filter="p_name like 'forest%'")
        .project(["p_partkey"])
    )
    lsum = (
        PlanBuilder()
        .table_scan(
            lineitem,
            filter=(
                "l_shipdate >= date '1994-01-01' "
                "and l_shipdate < date '1995-01-01'"
            ),
        )
        .aggregation(["l_partkey", "l_suppkey"], ["sum(l_quantity) as sq"])
    )
    ps_f = (
        PlanBuilder()
        .table_scan(partsupp)
        .hash_join(
            part_forest, ["ps_partkey"], ["p_partkey"],
            output=["ps_partkey", "ps_suppkey", "ps_availqty"],
            join_type="left_semi",
        )
        .hash_join(
            lsum,
            ["ps_partkey", "ps_suppkey"],
            ["l_partkey", "l_suppkey"],
            output=["ps_suppkey", "ps_availqty", "sq"],
        )
        # ps_availqty > 0.5 * sum(qty)  <=>  2 * availqty > sum  (exact)
        .filter("ps_availqty * 2 > sq")
        .project(["ps_suppkey"])
    )
    nation_ca = PlanBuilder().table_scan(nation, filter="n_name = 'CANADA'")
    return (
        PlanBuilder()
        .table_scan(supplier)
        .hash_join(
            nation_ca, ["s_nationkey"], ["n_nationkey"],
            output=["s_suppkey", "s_name", "s_address"],
            join_type="left_semi",
        )
        .hash_join(
            ps_f, ["s_suppkey"], ["ps_suppkey"],
            output=["s_name", "s_address"],
            join_type="left_semi",
        )
        .orderby(["s_name"])
        .build()
    )


def build_q21(supplier, lineitem, orders, nation) -> PlanNode:
    stats = (
        PlanBuilder()
        .table_scan(lineitem)
        .project(
            [
                "l_orderkey", "l_suppkey",
                "case when l_receiptdate > l_commitdate then 1 else 0 end"
                " as late",
            ]
        )
        .aggregation(["l_orderkey", "l_suppkey"], ["max(late) as late_any"])
        .aggregation(
            ["l_orderkey"], ["count(*) as n_supp", "sum(late_any) as n_late"]
        )
    )
    supplier_sa = (
        PlanBuilder()
        .table_scan(supplier)
        .hash_join(
            PlanBuilder().table_scan(nation, filter="n_name = 'SAUDI ARABIA'"),
            ["s_nationkey"], ["n_nationkey"],
            output=["s_suppkey", "s_name"],
            join_type="left_semi",
        )
    )
    orders_f = (
        PlanBuilder()
        .table_scan(orders, filter="o_orderstatus = 'F'")
        .project(["o_orderkey"])
    )
    return (
        PlanBuilder()
        .table_scan(lineitem, filter="l_receiptdate > l_commitdate")
        .hash_join(
            orders_f, ["l_orderkey"], ["o_orderkey"],
            output=["l_orderkey", "l_suppkey"], join_type="left_semi",
        )
        .hash_join(
            stats, ["l_orderkey"], ["l_orderkey"],
            output=["l_suppkey", "n_supp", "n_late"],
        )
        .filter("n_supp >= 2 and n_late = 1")
        .hash_join(
            supplier_sa, ["l_suppkey"], ["s_suppkey"], output=["s_name"],
        )
        .aggregation(["s_name"], ["count(*) as numwait"])
        .topn(["numwait desc", "s_name"], 100)
        .build()
    )


def build_q22(customer: Table, orders: Table, device=None) -> PlanNode:
    codes = "('13', '31', '23', '29', '30', '18', '17')"

    def cust() -> PlanBuilder:
        return (
            PlanBuilder()
            .table_scan(customer)
            .project(
                ["c_custkey", "c_acctbal", "substr(c_phone, 1, 2) as cntrycode"]
            )
            .filter(f"cntrycode in {codes}")
        )

    pos = run_plan(
        cust()
        .filter("c_acctbal > 0.00")
        .aggregation([], ["sum(c_acctbal) as s", "count(*) as c"])
        .build(),
        device=device,
    )
    total, cnt = int(pos.columns["s"][0]), int(pos.columns["c"][0])
    thr_text = f"{total // 100}.{total % 100:02d}"
    return (
        cust()
        # c_acctbal > avg  <=>  c_acctbal * count > sum  (exact)
        .filter(f"c_acctbal * {cnt} > {thr_text}")
        .hash_join(
            PlanBuilder().table_scan(orders).project(["o_custkey"]),
            ["c_custkey"], ["o_custkey"],
            output=["cntrycode", "c_acctbal"],
            join_type="anti",
        )
        .aggregation(
            ["cntrycode"],
            ["count(*) as numcust", "sum(c_acctbal) as totacctbal"],
        )
        .orderby(["cntrycode"])
        .build()
    )


_BUILDERS = {
    1: (build_q1, ["lineitem"]),
    2: (build_q2, ["region", "nation", "supplier", "partsupp", "part"]),
    3: (build_q3, ["customer", "orders", "lineitem"]),
    4: (build_q4, ["orders", "lineitem"]),
    5: (build_q5, ["region", "nation", "supplier", "customer", "orders", "lineitem"]),
    6: (build_q6, ["lineitem"]),
    7: (build_q7, ["nation", "supplier", "customer", "orders", "lineitem"]),
    8: (build_q8, ["region", "nation", "customer", "orders", "supplier", "part", "lineitem"]),
    9: (build_q9, ["part", "supplier", "nation", "partsupp", "orders", "lineitem"]),
    10: (build_q10, ["customer", "orders", "lineitem", "nation"]),
    11: (build_q11, ["nation", "supplier", "partsupp"]),
    12: (build_q12, ["orders", "lineitem"]),
    13: (build_q13, ["customer", "orders"]),
    14: (build_q14, ["part", "lineitem"]),
    15: (build_q15, ["supplier", "lineitem"]),
    16: (build_q16, ["part", "partsupp", "supplier"]),
    17: (build_q17, ["part", "lineitem"]),
    18: (build_q18, ["customer", "orders", "lineitem"]),
    19: (build_q19, ["part", "lineitem"]),
    20: (build_q20, ["part", "partsupp", "lineitem", "supplier", "nation"]),
    21: (build_q21, ["supplier", "lineitem", "orders", "nation"]),
    22: (build_q22, ["customer", "orders"]),
}

# the builders that run a scalar-subquery fragment while building the plan
_FRAGMENT_QUERIES = frozenset({11, 15, 22})

# engine column order may differ from the oracle's; map for comparison
ENGINE_OUTPUT_ORDER = {
    3: ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"],
}


def implemented_queries():
    return sorted(_BUILDERS)


def load_query_tables(num: int, sf: float) -> Dict[str, Table]:
    return {t: load_table(t, sf, c) for t, c in QUERY_COLUMNS[num].items()}


def build_query(num: int, tables: Dict[str, Table], device=None) -> PlanNode:
    """The plan of TPC-H query ``num`` over ``tables``.  Q11, Q15 and Q22 run
    their scalar subquery on ``device`` while the plan is built."""
    fn, names = _BUILDERS[num]
    args = [tables[n] for n in names]
    if num in _FRAGMENT_QUERIES:
        return fn(*args, device=device)
    return fn(*args)


def oracle_result(num: int, tables: Dict[str, Table]) -> pd.DataFrame:
    _, names = _BUILDERS[num]
    fn = getattr(_q, f"q{num}_oracle")
    return fn(*[tables[n] for n in names])


def run_query(num: int, sf: float, tile_rows: int = 1 << 20, stats=None, device=None):
    """Run a TPC-H query end-to-end; returns (engine_df, oracle_df)."""
    tables = load_query_tables(num, sf)
    plan = build_query(num, tables, device=device)
    result = run_plan(plan, tile_rows=tile_rows, stats=stats, device=device).to_pandas()
    if num in ENGINE_OUTPUT_ORDER:
        result = result[ENGINE_OUTPUT_ORDER[num]]
    return result.reset_index(drop=True), oracle_result(num, tables)
