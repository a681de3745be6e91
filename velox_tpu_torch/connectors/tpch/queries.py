"""TPC-H benchmark queries: SQL text + exact host-side oracles.

Counterpart of the JAX package's ``connectors/tpch/queries.py`` for the
queries this package runs so far (Q1, Q6).  Reference:
velox/exec/tests/utils/TpchQueryBuilder.h:61 (plan construction per query) +
velox/exec/tests/utils/QueryAssertions.h:37 (DuckDB oracle).  The oracle is a
numpy implementation that computes on the generator's *unscaled int64* decimal
representation — bit-exact sums, no float-associativity issues — and only
converts to display scale at the edges.  Engine parity checks compare against
these oracles on identical data.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd

from .gen import _days

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


QUERY_COLUMNS: Dict[int, object] = {
    1: {"lineitem": Q1_COLUMNS},
    6: {"lineitem": Q6_COLUMNS},
}
