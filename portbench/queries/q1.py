"""TPC-H Q1, the pricing summary report (TPC-H v3 §2.4.1), with DELTA as a
parameter; the plan shape of the port's ``connectors/tpch/plans.py build_q1``."""

TABLES = {
    "lineitem": [
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_shipdate",
    ],
}


def build(tables, p):
    from velox_tpu_torch.plan import PlanBuilder

    return (
        PlanBuilder()
        .table_scan(
            tables["lineitem"],
            columns=TABLES["lineitem"],
            filter=f"l_shipdate <= date '1998-12-01' - interval '{p['delta']}' day",
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
