"""TPC-H Q6, the forecasting revenue change report (TPC-H v3 §2.4.6), with
DATE (1 January of ``year``), DISCOUNT (``discount`` hundredths) and QUANTITY
as parameters; the plan shape of the port's ``build_q6``.  DATE + 1 year is
written as that year's number of days."""

import calendar

TABLES = {"lineitem": ["l_extendedprice", "l_discount", "l_quantity", "l_shipdate"]}


def build(tables, p):
    from velox_tpu_torch.plan import PlanBuilder

    year, d = p["year"], p["discount"]
    span = 366 if calendar.isleap(year) else 365
    return (
        PlanBuilder()
        .table_scan(
            tables["lineitem"],
            columns=TABLES["lineitem"],
            filter=(
                f"l_shipdate >= date '{year}-01-01' "
                f"and l_shipdate < date '{year}-01-01' + interval '{span}' day "
                f"and l_discount between {(d - 1) / 100:.2f} and {(d + 1) / 100:.2f} "
                f"and l_quantity < {p['quantity']}"
            ),
        )
        .aggregation([], ["sum(l_extendedprice * l_discount) as revenue"])
        .build()
    )
