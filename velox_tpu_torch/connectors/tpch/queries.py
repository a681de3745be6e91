"""TPC-H benchmark queries: SQL text + exact host-side oracles.

Counterpart of the JAX package's ``connectors/tpch/queries.py`` for the
queries this package runs so far (Q1, Q3, Q6, Q13).  Reference:
velox/exec/tests/utils/TpchQueryBuilder.h:61 (plan construction per query) +
velox/exec/tests/utils/QueryAssertions.h:37 (DuckDB oracle).  The oracle is a
numpy implementation that computes on the generator's *unscaled int64* decimal
representation — bit-exact sums, no float-associativity issues — and only
converts to display scale at the edges.  Engine parity checks compare against
these oracles on identical data.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import pandas as pd

from .gen import _days


def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"

# ---- Q1: pricing summary report -----------------------------------------

Q1_SQL = """
select l_returnflag, l_linestatus,
       sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty,
       avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc,
       count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

Q1_COLUMNS = [
    "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
    "l_discount", "l_tax", "l_shipdate",
]


def q1_oracle(lineitem) -> pd.DataFrame:
    cutoff = _days("1998-12-01") - 90
    keep = lineitem.columns["l_shipdate"] <= cutoff
    rf = lineitem.columns["l_returnflag"][keep]
    ls = lineitem.columns["l_linestatus"][keep]
    qty = lineitem.columns["l_quantity"][keep].astype(np.int64)
    ep = lineitem.columns["l_extendedprice"][keep].astype(np.int64)
    disc = lineitem.columns["l_discount"][keep].astype(np.int64)
    tax = lineitem.columns["l_tax"][keep].astype(np.int64)

    # group on integer codes (decoding 60M+ rows to python strings first is
    # minutes of pure overhead at SF10); decode the handful of group keys after
    df = pd.DataFrame(
        {
            "rf": rf,
            "ls": ls,
            "qty": qty,
            "ep": ep,
            # scale 4 and 6 fixed-point products, exact in int64 per row
            "disc_price": ep * (100 - disc),
            "charge": ep * (100 - disc) * (100 + tax),
            "disc": disc,
            "ones": np.ones(len(qty), dtype=np.int64),
        }
    )
    g = df.groupby(["rf", "ls"], sort=False).sum()
    rf_table = lineitem.string_tables["l_returnflag"]
    ls_table = lineitem.string_tables["l_linestatus"]
    g.index = pd.MultiIndex.from_arrays(
        [
            rf_table.decode(g.index.get_level_values(0).to_numpy()),
            ls_table.decode(g.index.get_level_values(1).to_numpy()),
        ],
        names=["l_returnflag", "l_linestatus"],
    )
    g = g.sort_index()
    out = pd.DataFrame(
        {
            "sum_qty": g["qty"] / 100.0,
            "sum_base_price": g["ep"] / 100.0,
            "sum_disc_price": g["disc_price"] / 1e4,
            "sum_charge": g["charge"] / 1e6,
            "avg_qty": g["qty"] / 100.0 / g["ones"],
            "avg_price": g["ep"] / 100.0 / g["ones"],
            "avg_disc": g["disc"] / 100.0 / g["ones"],
            "count_order": g["ones"],
        }
    ).reset_index()
    return out


# ---- Q3: shipping priority ----------------------------------------------

Q3_SQL = """
select l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING'
  and c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""

Q3_COLUMNS = {
    "customer": ["c_custkey", "c_mktsegment"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
    "lineitem": ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"],
}


def q3_oracle(customer, orders, lineitem, limit: int = 10) -> pd.DataFrame:
    cutoff = _days("1995-03-15")
    seg_code = customer.string_tables["c_mktsegment"].lookup("BUILDING")
    ckeep = customer.columns["c_mktsegment"] == seg_code
    ckeys = customer.columns["c_custkey"][ckeep]

    okeep = orders.columns["o_orderdate"] < cutoff
    okeep &= np.isin(orders.columns["o_custkey"], ckeys)
    odf = pd.DataFrame(
        {
            "o_orderkey": orders.columns["o_orderkey"][okeep],
            "o_orderdate": orders.columns["o_orderdate"][okeep],
            "o_shippriority": orders.columns["o_shippriority"][okeep],
        }
    )

    lkeep = lineitem.columns["l_shipdate"] > cutoff
    ldf = pd.DataFrame(
        {
            "l_orderkey": lineitem.columns["l_orderkey"][lkeep],
            "rev": (
                lineitem.columns["l_extendedprice"][lkeep].astype(np.int64)
                * (100 - lineitem.columns["l_discount"][lkeep].astype(np.int64))
            ),
        }
    )
    j = ldf.merge(odf, left_on="l_orderkey", right_on="o_orderkey")
    g = (
        j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"], as_index=False)["rev"]
        .sum()
        .rename(columns={"rev": "revenue"})
    )
    g["revenue"] = g["revenue"] / 1e4
    g = g.sort_values(
        ["revenue", "o_orderdate", "l_orderkey"], ascending=[False, True, True]
    ).head(limit)
    return g[["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]].reset_index(drop=True)


# ---- Q6: forecasting revenue change -------------------------------------

Q6_SQL = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '365' day
  and l_discount between 0.05 and 0.07
  and l_quantity < 24
"""

Q6_COLUMNS = ["l_extendedprice", "l_discount", "l_quantity", "l_shipdate"]


def q6_oracle(lineitem) -> pd.DataFrame:
    lo, hi = _days("1994-01-01"), _days("1994-01-01") + 365
    c = lineitem.columns
    keep = (
        (c["l_shipdate"] >= lo)
        & (c["l_shipdate"] < hi)
        & (c["l_discount"] >= 5)
        & (c["l_discount"] <= 7)
        & (c["l_quantity"] < 2400)
    )
    revenue = int(
        np.sum(
            c["l_extendedprice"][keep].astype(np.int64)
            * c["l_discount"][keep].astype(np.int64)
        )
    )
    return pd.DataFrame({"revenue": [revenue / 1e4]})


# ---- Q13: customer distribution -----------------------------------------

Q13_SQL = """
select c_count, count(*) as custdist
from (select c_custkey, count(o_custkey) as c_count
      from customer left outer join orders
        on c_custkey = o_custkey
       and o_comment not like '%special%requests%'
      group by c_custkey) as c_orders
group by c_count
order by custdist desc, c_count desc
"""

Q13_COLUMNS = {
    "customer": ["c_custkey"],
    "orders": ["o_custkey", "o_comment"],
}


def q13_oracle(customer, orders) -> pd.DataFrame:
    pattern = re.compile(_like_to_regex("%special%requests%"))
    table = orders.string_tables["o_comment"]
    match_by_code = np.asarray(
        [bool(pattern.match(s)) for s in table.values()], dtype=bool
    )
    keep = ~match_by_code[orders.columns["o_comment"]]
    counts = pd.Series(orders.columns["o_custkey"][keep]).value_counts()
    per_customer = (
        pd.Series(0, index=customer.columns["c_custkey"])
        .add(counts, fill_value=0)
        .astype(np.int64)
    )
    dist = per_customer.value_counts().rename_axis("c_count").rename("custdist").reset_index()
    dist = dist.sort_values(["custdist", "c_count"], ascending=[False, False])
    return dist.reset_index(drop=True)


QUERY_COLUMNS: Dict[int, object] = {
    1: {"lineitem": Q1_COLUMNS},
    3: Q3_COLUMNS,
    6: {"lineitem": Q6_COLUMNS},
    13: Q13_COLUMNS,
}
