"""TPC-H Q12, the shipping modes and order priority query (TPC-H v3 §2.4.12),
with SHIPMODE1, SHIPMODE2 (``shipmodes``) and DATE (1 January of ``year``) as
parameters; the plan shape of the port's ``build_q12``: orders is a build side
scanned from a host table, lineitem is probed from resident tiles and grouped
in direct mode by ship mode."""

TABLES = {
    "orders": ["o_orderkey", "o_orderpriority"],
    "lineitem": ["l_orderkey", "l_shipmode", "l_commitdate", "l_receiptdate", "l_shipdate"],
}


def build(tables, p):
    from velox_tpu_torch.plan import PlanBuilder

    m1, m2 = p["shipmodes"]
    year = p["year"]
    return (
        PlanBuilder()
        .table_scan(
            tables["lineitem"],
            filter=(
                f"l_shipmode in ('{m1}', '{m2}') "
                "and l_commitdate < l_receiptdate "
                "and l_shipdate < l_commitdate "
                f"and l_receiptdate >= date '{year}-01-01' "
                f"and l_receiptdate < date '{year + 1}-01-01'"
            ),
        )
        .hash_join(
            PlanBuilder().table_scan(tables["orders"]),
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
