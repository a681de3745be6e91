"""TPC-H Q3, the shipping priority query (TPC-H v3 §2.4.3), with SEGMENT and
DATE (``day`` of March 1995) as parameters; the plan shape of the port's
``build_q3``: customer and orders are build sides scanned from host tables
while the executor is constructed, lineitem is probed from resident tiles."""

TABLES = {
    "customer": ["c_custkey", "c_mktsegment"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
    "lineitem": ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"],
}


def build(tables, p):
    from velox_tpu_torch.plan import PlanBuilder

    date = f"date '1995-03-{p['day']:02d}'"
    segment = (
        PlanBuilder()
        .table_scan(tables["customer"], filter=f"c_mktsegment = '{p['segment']}'")
        .project(["c_custkey"])
    )
    orders_build = (
        PlanBuilder()
        .table_scan(tables["orders"], filter=f"o_orderdate < {date}")
        .hash_join(
            segment,
            ["o_custkey"],
            ["c_custkey"],
            output=["o_orderkey", "o_orderdate", "o_shippriority"],
            join_type="left_semi",
        )
    )
    return (
        PlanBuilder()
        .table_scan(tables["lineitem"], filter=f"l_shipdate > {date}")
        .hash_join(
            orders_build,
            ["l_orderkey"],
            ["o_orderkey"],
            output=[
                "l_orderkey", "l_extendedprice", "l_discount",
                "o_orderdate", "o_shippriority",
            ],
        )
        .aggregation(
            ["l_orderkey", "o_orderdate", "o_shippriority"],
            ["sum(l_extendedprice * (1 - l_discount)) as revenue"],
        )
        .topn(["revenue desc", "o_orderdate", "l_orderkey"], 10)
        .build()
    )
