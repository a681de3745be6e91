"""TPC-H benchmark queries: SQL text + exact host-side oracles.

Counterpart of the JAX package's ``connectors/tpch/queries.py`` (a copy: the
22 SQL texts, the per-query column lists and the numpy oracles).  Reference:
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


def _has_value(table, name: str, values) -> np.ndarray:
    """Rows whose string column ``name`` is one of ``values``, compared by
    dictionary code (no decode of the whole column)."""
    strings = table.string_tables[name]
    codes = [strings.lookup(v) for v in values]
    return np.isin(table.columns[name], [c for c in codes if c is not None])


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


# ---- Q15: top supplier -------------------------------------------------------

Q15_COLUMNS = {
    "supplier": ["s_suppkey", "s_name", "s_address", "s_phone"],
    "lineitem": ["l_suppkey", "l_shipdate", "l_extendedprice", "l_discount"],
}


def q15_oracle(supplier, lineitem) -> pd.DataFrame:
    lo, hi = _days("1996-01-01"), _days("1996-04-01")
    c = lineitem.columns
    keep = (c["l_shipdate"] >= lo) & (c["l_shipdate"] < hi)
    df = pd.DataFrame(
        {
            "l_suppkey": c["l_suppkey"][keep],
            "rev": c["l_extendedprice"][keep].astype(np.int64)
            * (100 - c["l_discount"][keep].astype(np.int64)),
        }
    )
    g = df.groupby("l_suppkey", as_index=False)["rev"].sum()
    g = g[g["rev"] == g["rev"].max()]
    sup = pd.DataFrame(
        {
            "s_suppkey": supplier.columns["s_suppkey"],
            "s_name": supplier.string_tables["s_name"].decode(
                supplier.columns["s_name"]
            ),
            "s_address": supplier.string_tables["s_address"].decode(
                supplier.columns["s_address"]
            ),
            "s_phone": supplier.string_tables["s_phone"].decode(
                supplier.columns["s_phone"]
            ),
        }
    )
    j = g.merge(sup, left_on="l_suppkey", right_on="s_suppkey")
    j["total_revenue"] = j["rev"] / 1e4
    j = j.sort_values("s_suppkey")
    return j[
        ["s_suppkey", "s_name", "s_address", "s_phone", "total_revenue"]
    ].reset_index(drop=True)


# ---- Q16: parts/supplier relationship ----------------------------------------

Q16_COLUMNS = {
    "part": ["p_partkey", "p_brand", "p_type", "p_size"],
    "partsupp": ["ps_partkey", "ps_suppkey"],
    "supplier": ["s_suppkey", "s_comment"],
}

_Q16_SIZES = [49, 14, 23, 45, 19, 3, 36, 9]


def q16_oracle(part, partsupp, supplier) -> pd.DataFrame:
    brand = part.string_tables["p_brand"].decode(part.columns["p_brand"]).astype(str)
    ptype = part.string_tables["p_type"].decode(part.columns["p_type"]).astype(str)
    keep = (
        (brand != "Brand#45")
        & ~np.char.startswith(ptype, "MEDIUM POLISHED")
        & np.isin(part.columns["p_size"], _Q16_SIZES)
    )
    pt = pd.DataFrame(
        {
            "p_partkey": part.columns["p_partkey"][keep],
            "p_brand": brand[keep],
            "p_type": ptype[keep],
            "p_size": part.columns["p_size"][keep],
        }
    )
    comment = (
        supplier.string_tables["s_comment"]
        .decode(supplier.columns["s_comment"])
        .astype(str)
    )
    pat = re.compile(_like_to_regex("%Customer%Complaints%"))
    bad = set(
        supplier.columns["s_suppkey"][
            np.asarray([bool(pat.match(s)) for s in comment])
        ].tolist()
    )
    ps = pd.DataFrame(
        {
            "ps_partkey": partsupp.columns["ps_partkey"],
            "ps_suppkey": partsupp.columns["ps_suppkey"],
        }
    )
    j = ps.merge(pt, left_on="ps_partkey", right_on="p_partkey")
    j = j[~j["ps_suppkey"].isin(bad)]
    g = (
        j.drop_duplicates(["p_brand", "p_type", "p_size", "ps_suppkey"])
        .groupby(["p_brand", "p_type", "p_size"], as_index=False)
        .size()
        .rename(columns={"size": "supplier_cnt"})
    )
    g = g.sort_values(
        ["supplier_cnt", "p_brand", "p_type", "p_size"],
        ascending=[False, True, True, True],
    )
    return g[["p_brand", "p_type", "p_size", "supplier_cnt"]].reset_index(drop=True)


# ---- Q17: small-quantity-order revenue ----------------------------------------

Q17_COLUMNS = {
    "part": ["p_partkey", "p_brand", "p_container"],
    "lineitem": ["l_partkey", "l_quantity", "l_extendedprice"],
}


def q17_oracle(part, lineitem) -> pd.DataFrame:
    brand = part.string_tables["p_brand"].decode(part.columns["p_brand"]).astype(str)
    cont = (
        part.string_tables["p_container"]
        .decode(part.columns["p_container"])
        .astype(str)
    )
    pk = part.columns["p_partkey"][(brand == "Brand#23") & (cont == "MED BOX")]
    keep = np.isin(lineitem.columns["l_partkey"], pk)
    li = pd.DataFrame(
        {
            "l_partkey": lineitem.columns["l_partkey"][keep],
            "qty": lineitem.columns["l_quantity"][keep].astype(np.int64),
            "ep": lineitem.columns["l_extendedprice"][keep].astype(np.int64),
        }
    )
    g = li.groupby("l_partkey").agg(sq=("qty", "sum"), cq=("qty", "size"))
    j = li.merge(g, left_on="l_partkey", right_index=True)
    j = j[j["qty"] * 5 * j["cq"] < j["sq"]]
    if len(j) == 0:
        return pd.DataFrame({"avg_yearly": [None]})  # SQL: sum() of no rows is NULL
    total = int(j["ep"].sum())
    return pd.DataFrame(
        {"avg_yearly": [(np.float64(total) / 1e2) / np.float64(7.0)]}
    )


# ---- Q18: large volume customers ----------------------------------------------

Q18_COLUMNS = {
    "customer": ["c_custkey", "c_name"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"],
    "lineitem": ["l_orderkey", "l_quantity"],
}


def q18_oracle(customer, orders, lineitem, limit=100) -> pd.DataFrame:
    li = pd.DataFrame(
        {
            "l_orderkey": lineitem.columns["l_orderkey"],
            "qty": lineitem.columns["l_quantity"].astype(np.int64),
        }
    )
    g = li.groupby("l_orderkey", as_index=False)["qty"].sum()
    g = g[g["qty"] > 300 * 100]
    odf = pd.DataFrame(
        {
            "o_orderkey": orders.columns["o_orderkey"],
            "o_custkey": orders.columns["o_custkey"],
            "o_orderdate": orders.columns["o_orderdate"],
            "o_totalprice": orders.columns["o_totalprice"].astype(np.int64) / 100.0,
        }
    )
    cust = pd.DataFrame(
        {
            "c_custkey": customer.columns["c_custkey"],
            "c_name": customer.string_tables["c_name"].decode(
                customer.columns["c_name"]
            ),
        }
    )
    j = g.merge(odf, left_on="l_orderkey", right_on="o_orderkey").merge(
        cust, left_on="o_custkey", right_on="c_custkey"
    )
    j["sum_qty"] = j["qty"] / 100.0
    j = j.sort_values(
        ["o_totalprice", "o_orderdate", "o_orderkey"],
        ascending=[False, True, True],
    ).head(limit)
    return j[
        ["c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice", "sum_qty"]
    ].reset_index(drop=True)


# ---- Q19: discounted revenue --------------------------------------------------

Q19_COLUMNS = {
    "part": ["p_partkey", "p_brand", "p_container", "p_size"],
    "lineitem": [
        "l_partkey", "l_quantity", "l_extendedprice", "l_discount",
        "l_shipmode", "l_shipinstruct",
    ],
}


def q19_oracle(part, lineitem) -> pd.DataFrame:
    c = lineitem.columns
    keep = _has_value(lineitem, "l_shipmode", ["AIR", "AIR REG"]) & _has_value(
        lineitem, "l_shipinstruct", ["DELIVER IN PERSON"]
    )
    li = pd.DataFrame(
        {
            "l_partkey": c["l_partkey"][keep],
            "qty": c["l_quantity"][keep].astype(np.int64),
            "rev": c["l_extendedprice"][keep].astype(np.int64)
            * (100 - c["l_discount"][keep].astype(np.int64)),
        }
    )
    brand = part.string_tables["p_brand"].decode(part.columns["p_brand"]).astype(str)
    cont = (
        part.string_tables["p_container"]
        .decode(part.columns["p_container"])
        .astype(str)
    )
    pt = pd.DataFrame(
        {
            "p_partkey": part.columns["p_partkey"],
            "brand": brand,
            "cont": cont,
            "size": part.columns["p_size"],
        }
    )
    j = li.merge(pt, left_on="l_partkey", right_on="p_partkey")
    c1 = (
        (j["brand"] == "Brand#12")
        & j["cont"].isin(["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
        & (j["qty"] >= 100) & (j["qty"] <= 1100)
        & (j["size"] >= 1) & (j["size"] <= 5)
    )
    c2 = (
        (j["brand"] == "Brand#23")
        & j["cont"].isin(["MED BAG", "MED BOX", "MED PKG", "MED PACK"])
        & (j["qty"] >= 1000) & (j["qty"] <= 2000)
        & (j["size"] >= 1) & (j["size"] <= 10)
    )
    c3 = (
        (j["brand"] == "Brand#34")
        & j["cont"].isin(["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
        & (j["qty"] >= 2000) & (j["qty"] <= 3000)
        & (j["size"] >= 1) & (j["size"] <= 15)
    )
    sel = c1 | c2 | c3
    if not sel.any():
        return pd.DataFrame({"revenue": [None]})  # SQL: sum() of no rows is NULL
    total = int(j.loc[sel, "rev"].sum())
    return pd.DataFrame({"revenue": [total / 1e4]})


# ---- Q20: potential part promotion ---------------------------------------------

Q20_COLUMNS = {
    "part": ["p_partkey", "p_name"],
    "partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty"],
    "lineitem": ["l_partkey", "l_suppkey", "l_quantity", "l_shipdate"],
    "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey"],
    "nation": ["n_nationkey", "n_name"],
}


def q20_oracle(part, partsupp, lineitem, supplier, nation) -> pd.DataFrame:
    pname = part.string_tables["p_name"].decode(part.columns["p_name"]).astype(str)
    forest = part.columns["p_partkey"][np.char.startswith(pname, "forest")]
    lo, hi = _days("1994-01-01"), _days("1995-01-01")
    c = lineitem.columns
    lkeep = (c["l_shipdate"] >= lo) & (c["l_shipdate"] < hi)
    li = pd.DataFrame(
        {
            "l_partkey": c["l_partkey"][lkeep],
            "l_suppkey": c["l_suppkey"][lkeep],
            "qty": c["l_quantity"][lkeep].astype(np.int64),
        }
    )
    lsum = li.groupby(["l_partkey", "l_suppkey"], as_index=False)["qty"].sum()
    ps = pd.DataFrame(
        {
            "ps_partkey": partsupp.columns["ps_partkey"],
            "ps_suppkey": partsupp.columns["ps_suppkey"],
            "aq": partsupp.columns["ps_availqty"].astype(np.int64),
        }
    )
    ps = ps[ps["ps_partkey"].isin(forest)]
    j = ps.merge(
        lsum,
        left_on=["ps_partkey", "ps_suppkey"],
        right_on=["l_partkey", "l_suppkey"],
    )
    good = set(j.loc[j["aq"] * 200 > j["qty"], "ps_suppkey"].tolist())
    ca = nation.columns["n_nationkey"][
        nation.string_tables["n_name"].decode(nation.columns["n_name"]) == "CANADA"
    ]
    skeep = np.isin(supplier.columns["s_nationkey"], ca) & np.isin(
        supplier.columns["s_suppkey"], list(good)
    )
    out = pd.DataFrame(
        {
            "s_name": supplier.string_tables["s_name"].decode(
                supplier.columns["s_name"][skeep]
            ),
            "s_address": supplier.string_tables["s_address"].decode(
                supplier.columns["s_address"][skeep]
            ),
        }
    ).sort_values("s_name")
    return out.reset_index(drop=True)


# ---- Q21: suppliers who kept orders waiting --------------------------------------

Q21_COLUMNS = {
    "supplier": ["s_suppkey", "s_name", "s_nationkey"],
    "lineitem": ["l_orderkey", "l_suppkey", "l_receiptdate", "l_commitdate"],
    "orders": ["o_orderkey", "o_orderstatus"],
    "nation": ["n_nationkey", "n_name"],
}


def q21_oracle(supplier, lineitem, orders, nation, limit=100) -> pd.DataFrame:
    c = lineitem.columns
    late = c["l_receiptdate"] > c["l_commitdate"]
    li = pd.DataFrame(
        {
            "l_orderkey": c["l_orderkey"],
            "l_suppkey": c["l_suppkey"],
            "late": late.astype(np.int64),
        }
    )
    per_pair = li.groupby(["l_orderkey", "l_suppkey"], as_index=False)["late"].max()
    stats = per_pair.groupby("l_orderkey").agg(
        n_supp=("late", "size"), n_late=("late", "sum")
    )
    f_orders = set(
        orders.columns["o_orderkey"][
            orders.string_tables["o_orderstatus"].decode(
                orders.columns["o_orderstatus"]
            )
            == "F"
        ].tolist()
    )
    sa = nation.columns["n_nationkey"][
        nation.string_tables["n_name"].decode(nation.columns["n_name"])
        == "SAUDI ARABIA"
    ]
    sup = pd.DataFrame(
        {
            "s_suppkey": supplier.columns["s_suppkey"][
                np.isin(supplier.columns["s_nationkey"], sa)
            ],
            "s_name": supplier.string_tables["s_name"].decode(
                supplier.columns["s_name"][
                    np.isin(supplier.columns["s_nationkey"], sa)
                ]
            ),
        }
    )
    l1 = li[li["late"] == 1]
    l1 = l1[l1["l_orderkey"].isin(f_orders)]
    j = l1.merge(sup, left_on="l_suppkey", right_on="s_suppkey")
    j = j.merge(stats, left_on="l_orderkey", right_index=True)
    j = j[(j["n_supp"] >= 2) & (j["n_late"] == 1)]
    g = (
        j.groupby("s_name", as_index=False)
        .size()
        .rename(columns={"size": "numwait"})
    )
    g = g.sort_values(["numwait", "s_name"], ascending=[False, True]).head(limit)
    return g[["s_name", "numwait"]].reset_index(drop=True)


# ---- Q22: global sales opportunity -----------------------------------------------

Q22_COLUMNS = {
    "customer": ["c_custkey", "c_phone", "c_acctbal"],
    "orders": ["o_custkey"],
}

_Q22_CODES = ["13", "31", "23", "29", "30", "18", "17"]


def q22_oracle(customer, orders) -> pd.DataFrame:
    phones = (
        customer.string_tables["c_phone"].decode(customer.columns["c_phone"]).astype(str)
    )
    codes = np.asarray([p[:2] for p in phones])
    in_list = np.isin(codes, _Q22_CODES)
    bal = customer.columns["c_acctbal"].astype(np.int64)
    pos = in_list & (bal > 0)
    total, cnt = int(bal[pos].sum()), int(pos.sum())
    has_order = np.isin(
        customer.columns["c_custkey"], np.unique(orders.columns["o_custkey"])
    )
    keep = in_list & (bal * cnt > total) & ~has_order
    df = pd.DataFrame({"cntrycode": codes[keep], "bal": bal[keep]})
    g = df.groupby("cntrycode", as_index=False).agg(
        numcust=("bal", "size"), totacctbal=("bal", "sum")
    )
    g["totacctbal"] = g["totacctbal"] / 100.0
    g = g.sort_values("cntrycode")
    return g[["cntrycode", "numcust", "totacctbal"]].reset_index(drop=True)


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


# ---- Q2: minimum cost supplier -------------------------------------------

Q2_COLUMNS = {
    "region": ["r_regionkey", "r_name"],
    "nation": ["n_nationkey", "n_regionkey", "n_name"],
    "supplier": [
        "s_suppkey", "s_nationkey", "s_acctbal", "s_name", "s_address",
        "s_phone", "s_comment",
    ],
    "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"],
    "part": ["p_partkey", "p_size", "p_type", "p_mfgr"],
}


def q2_oracle(region, nation, supplier, partsupp, part, limit=100) -> pd.DataFrame:
    rkey = region.columns["r_regionkey"][
        region.string_tables["r_name"].decode(region.columns["r_name"]) == "EUROPE"
    ]
    nkeep = np.isin(nation.columns["n_regionkey"], rkey)
    nat = pd.DataFrame(
        {
            "n_nationkey": nation.columns["n_nationkey"][nkeep],
            "n_name": nation.string_tables["n_name"].decode(
                nation.columns["n_name"][nkeep]
            ),
        }
    )
    sup = pd.DataFrame(
        {
            "s_suppkey": supplier.columns["s_suppkey"],
            "s_nationkey": supplier.columns["s_nationkey"],
            "s_acctbal": supplier.columns["s_acctbal"].astype(np.int64),
            "s_name": supplier.string_tables["s_name"].decode(
                supplier.columns["s_name"]
            ),
            "s_address": supplier.string_tables["s_address"].decode(
                supplier.columns["s_address"]
            ),
            "s_phone": supplier.string_tables["s_phone"].decode(
                supplier.columns["s_phone"]
            ),
            "s_comment": supplier.string_tables["s_comment"].decode(
                supplier.columns["s_comment"]
            ),
        }
    ).merge(nat, left_on="s_nationkey", right_on="n_nationkey")
    ps = pd.DataFrame(
        {
            "ps_partkey": partsupp.columns["ps_partkey"],
            "ps_suppkey": partsupp.columns["ps_suppkey"],
            "ps_supplycost": partsupp.columns["ps_supplycost"].astype(np.int64),
        }
    ).merge(sup, left_on="ps_suppkey", right_on="s_suppkey")
    ptype = part.string_tables["p_type"].decode(part.columns["p_type"])
    pkeep = (part.columns["p_size"] == 15) & np.char.endswith(
        ptype.astype(str), "BRASS"
    )
    pt = pd.DataFrame(
        {
            "p_partkey": part.columns["p_partkey"][pkeep],
            "p_mfgr": part.string_tables["p_mfgr"].decode(
                part.columns["p_mfgr"][pkeep]
            ),
        }
    )
    j = ps.merge(pt, left_on="ps_partkey", right_on="p_partkey")
    mins = j.groupby("ps_partkey")["ps_supplycost"].transform("min")
    j = j[j["ps_supplycost"] == mins].copy()
    j["s_acctbal"] = j["s_acctbal"] / 100.0
    j = j.sort_values(
        ["s_acctbal", "n_name", "s_name", "p_partkey"],
        ascending=[False, True, True, True],
    ).head(limit)
    return j[
        [
            "s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
            "s_address", "s_phone", "s_comment",
        ]
    ].reset_index(drop=True)


# ---- Q4: order priority checking -----------------------------------------

Q4_COLUMNS = {
    "orders": ["o_orderkey", "o_orderdate", "o_orderpriority"],
    "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate"],
}


def q4_oracle(orders, lineitem) -> pd.DataFrame:
    lo, hi = _days("1993-07-01"), _days("1993-10-01")
    okeep = (orders.columns["o_orderdate"] >= lo) & (
        orders.columns["o_orderdate"] < hi
    )
    late = lineitem.columns["l_commitdate"] < lineitem.columns["l_receiptdate"]
    late_orders = np.unique(lineitem.columns["l_orderkey"][late])
    keep = okeep & np.isin(orders.columns["o_orderkey"], late_orders)
    pri = orders.string_tables["o_orderpriority"].decode(
        orders.columns["o_orderpriority"][keep]
    )
    out = (
        pd.Series(pri)
        .value_counts()
        .rename_axis("o_orderpriority")
        .rename("order_count")
        .reset_index()
        .sort_values("o_orderpriority")
    )
    return out.reset_index(drop=True)


# ---- Q5: local supplier volume -------------------------------------------

Q5_COLUMNS = {
    "region": ["r_regionkey", "r_name"],
    "nation": ["n_nationkey", "n_regionkey", "n_name"],
    "supplier": ["s_suppkey", "s_nationkey"],
    "customer": ["c_custkey", "c_nationkey"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
    "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"],
}


def q5_oracle(region, nation, supplier, customer, orders, lineitem) -> pd.DataFrame:
    rkey = region.columns["r_regionkey"][
        region.string_tables["r_name"].decode(region.columns["r_name"]) == "ASIA"
    ]
    nkeep = np.isin(nation.columns["n_regionkey"], rkey)
    nat = pd.DataFrame(
        {
            "n_nationkey": nation.columns["n_nationkey"][nkeep],
            "n_name": nation.string_tables["n_name"].decode(
                nation.columns["n_name"][nkeep]
            ),
        }
    )
    sup = pd.DataFrame(
        {
            "s_suppkey": supplier.columns["s_suppkey"],
            "s_nationkey": supplier.columns["s_nationkey"],
        }
    ).merge(nat, left_on="s_nationkey", right_on="n_nationkey")
    lo, hi = _days("1994-01-01"), _days("1995-01-01")
    okeep = (orders.columns["o_orderdate"] >= lo) & (
        orders.columns["o_orderdate"] < hi
    )
    odf = pd.DataFrame(
        {
            "o_orderkey": orders.columns["o_orderkey"][okeep],
            "o_custkey": orders.columns["o_custkey"][okeep],
        }
    ).merge(
        pd.DataFrame(
            {
                "c_custkey": customer.columns["c_custkey"],
                "c_nationkey": customer.columns["c_nationkey"],
            }
        ),
        left_on="o_custkey",
        right_on="c_custkey",
    )
    li = pd.DataFrame(
        {
            "l_orderkey": lineitem.columns["l_orderkey"],
            "l_suppkey": lineitem.columns["l_suppkey"],
            "rev": lineitem.columns["l_extendedprice"].astype(np.int64)
            * (100 - lineitem.columns["l_discount"].astype(np.int64)),
        }
    )
    j = li.merge(odf, left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(sup, left_on="l_suppkey", right_on="s_suppkey")
    j = j[j["c_nationkey"] == j["s_nationkey"]]
    g = j.groupby("n_name", as_index=False)["rev"].sum()
    g["revenue"] = g["rev"] / 1e4
    g = g.sort_values("revenue", ascending=False)
    return g[["n_name", "revenue"]].reset_index(drop=True)


# ---- Q7: volume shipping ---------------------------------------------------

Q7_COLUMNS = {
    "nation": ["n_nationkey", "n_name"],
    "supplier": ["s_suppkey", "s_nationkey"],
    "customer": ["c_custkey", "c_nationkey"],
    "orders": ["o_orderkey", "o_custkey"],
    "lineitem": [
        "l_orderkey", "l_suppkey", "l_shipdate", "l_extendedprice", "l_discount",
    ],
}


def q7_oracle(nation, supplier, customer, orders, lineitem) -> pd.DataFrame:
    names = nation.string_tables["n_name"].decode(nation.columns["n_name"])
    nkeep = np.isin(names.astype(str), ["FRANCE", "GERMANY"])
    nat = pd.DataFrame(
        {
            "n_nationkey": nation.columns["n_nationkey"][nkeep],
            "n_name": names[nkeep],
        }
    )
    sup = pd.DataFrame(
        {
            "s_suppkey": supplier.columns["s_suppkey"],
            "s_nationkey": supplier.columns["s_nationkey"],
        }
    ).merge(nat, left_on="s_nationkey", right_on="n_nationkey")
    sup = sup.rename(columns={"n_name": "supp_nation"})[["s_suppkey", "supp_nation"]]
    cust = pd.DataFrame(
        {
            "c_custkey": customer.columns["c_custkey"],
            "c_nationkey": customer.columns["c_nationkey"],
        }
    ).merge(nat, left_on="c_nationkey", right_on="n_nationkey")
    cust = cust.rename(columns={"n_name": "cust_nation"})[["c_custkey", "cust_nation"]]
    odf = pd.DataFrame(
        {
            "o_orderkey": orders.columns["o_orderkey"],
            "o_custkey": orders.columns["o_custkey"],
        }
    ).merge(cust, left_on="o_custkey", right_on="c_custkey")
    lo, hi = _days("1995-01-01"), _days("1996-12-31")
    lkeep = (lineitem.columns["l_shipdate"] >= lo) & (
        lineitem.columns["l_shipdate"] <= hi
    )
    li = pd.DataFrame(
        {
            "l_orderkey": lineitem.columns["l_orderkey"][lkeep],
            "l_suppkey": lineitem.columns["l_suppkey"][lkeep],
            "l_year": pd.to_datetime(
                lineitem.columns["l_shipdate"][lkeep], unit="D"
            ).year,
            "vol": lineitem.columns["l_extendedprice"][lkeep].astype(np.int64)
            * (100 - lineitem.columns["l_discount"][lkeep].astype(np.int64)),
        }
    )
    j = li.merge(odf, left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(sup, left_on="l_suppkey", right_on="s_suppkey")
    j = j[j["supp_nation"] != j["cust_nation"]]
    g = j.groupby(["supp_nation", "cust_nation", "l_year"], as_index=False)[
        "vol"
    ].sum()
    g["revenue"] = g["vol"] / 1e4
    g = g.sort_values(["supp_nation", "cust_nation", "l_year"])
    return g[["supp_nation", "cust_nation", "l_year", "revenue"]].reset_index(
        drop=True
    )


# ---- Q8: national market share ---------------------------------------------

Q8_COLUMNS = {
    "region": ["r_regionkey", "r_name"],
    "nation": ["n_nationkey", "n_regionkey", "n_name"],
    "customer": ["c_custkey", "c_nationkey"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
    "supplier": ["s_suppkey", "s_nationkey"],
    "part": ["p_partkey", "p_type"],
    "lineitem": [
        "l_orderkey", "l_partkey", "l_suppkey", "l_extendedprice", "l_discount",
    ],
}


def q8_oracle(region, nation, customer, orders, supplier, part, lineitem) -> pd.DataFrame:
    rkey = region.columns["r_regionkey"][
        region.string_tables["r_name"].decode(region.columns["r_name"]) == "AMERICA"
    ]
    am_nations = nation.columns["n_nationkey"][
        np.isin(nation.columns["n_regionkey"], rkey)
    ]
    cust_am = customer.columns["c_custkey"][
        np.isin(customer.columns["c_nationkey"], am_nations)
    ]
    lo, hi = _days("1995-01-01"), _days("1996-12-31")
    okeep = (
        (orders.columns["o_orderdate"] >= lo)
        & (orders.columns["o_orderdate"] <= hi)
        & np.isin(orders.columns["o_custkey"], cust_am)
    )
    odf = pd.DataFrame(
        {
            "o_orderkey": orders.columns["o_orderkey"][okeep],
            "o_year": pd.to_datetime(
                orders.columns["o_orderdate"][okeep], unit="D"
            ).year,
        }
    )
    steel = part.columns["p_partkey"][
        part.string_tables["p_type"].decode(part.columns["p_type"])
        == "ECONOMY ANODIZED STEEL"
    ]
    nat = pd.DataFrame(
        {
            "n_nationkey": nation.columns["n_nationkey"],
            "nation": nation.string_tables["n_name"].decode(
                nation.columns["n_name"]
            ),
        }
    )
    sup = pd.DataFrame(
        {
            "s_suppkey": supplier.columns["s_suppkey"],
            "s_nationkey": supplier.columns["s_nationkey"],
        }
    ).merge(nat, left_on="s_nationkey", right_on="n_nationkey")
    lkeep = np.isin(lineitem.columns["l_partkey"], steel)
    li = pd.DataFrame(
        {
            "l_orderkey": lineitem.columns["l_orderkey"][lkeep],
            "l_suppkey": lineitem.columns["l_suppkey"][lkeep],
            "vol": lineitem.columns["l_extendedprice"][lkeep].astype(np.int64)
            * (100 - lineitem.columns["l_discount"][lkeep].astype(np.int64)),
        }
    )
    j = li.merge(odf, left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(sup, left_on="l_suppkey", right_on="s_suppkey")
    j["bvol"] = np.where(j["nation"] == "BRAZIL", j["vol"], 0)
    g = j.groupby("o_year", as_index=False)[["bvol", "vol"]].sum()
    g["mkt_share"] = (g["bvol"].astype(np.float64) / 1e4) / (
        g["vol"].astype(np.float64) / 1e4
    )
    g = g.sort_values("o_year")
    return g[["o_year", "mkt_share"]].reset_index(drop=True)


# ---- Q11: important stock identification -----------------------------------

Q11_COLUMNS = {
    "nation": ["n_nationkey", "n_name"],
    "supplier": ["s_suppkey", "s_nationkey"],
    "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost", "ps_availqty"],
}


def q11_oracle(nation, supplier, partsupp) -> pd.DataFrame:
    de = nation.columns["n_nationkey"][
        nation.string_tables["n_name"].decode(nation.columns["n_name"]) == "GERMANY"
    ]
    sup_de = supplier.columns["s_suppkey"][
        np.isin(supplier.columns["s_nationkey"], de)
    ]
    keep = np.isin(partsupp.columns["ps_suppkey"], sup_de)
    value = partsupp.columns["ps_supplycost"][keep].astype(np.int64) * partsupp.columns[
        "ps_availqty"
    ][keep].astype(np.int64)
    df = pd.DataFrame(
        {"ps_partkey": partsupp.columns["ps_partkey"][keep], "v": value}
    )
    g = df.groupby("ps_partkey", as_index=False)["v"].sum()
    nsupp = len(supplier.columns["s_suppkey"])  # = 10000 * SF
    thr = int(g["v"].sum()) // nsupp
    g = g[g["v"] > thr].copy()
    g["value"] = g["v"] / 100.0
    g = g.sort_values(["value", "ps_partkey"], ascending=[False, True])
    return g[["ps_partkey", "value"]].reset_index(drop=True)


# ---- Q12: shipping modes and order priority ---------------------------------

Q12_COLUMNS = {
    "orders": ["o_orderkey", "o_orderpriority"],
    "lineitem": [
        "l_orderkey", "l_shipmode", "l_shipdate", "l_commitdate", "l_receiptdate",
    ],
}


def q12_oracle(orders, lineitem) -> pd.DataFrame:
    lo, hi = _days("1994-01-01"), _days("1995-01-01")
    c = lineitem.columns
    keep = (
        _has_value(lineitem, "l_shipmode", ["MAIL", "SHIP"])
        & (c["l_commitdate"] < c["l_receiptdate"])
        & (c["l_shipdate"] < c["l_commitdate"])
        & (c["l_receiptdate"] >= lo)
        & (c["l_receiptdate"] < hi)
    )
    modes = lineitem.string_tables["l_shipmode"].decode(c["l_shipmode"][keep])
    li = pd.DataFrame({"l_orderkey": c["l_orderkey"][keep], "l_shipmode": modes})
    odf = pd.DataFrame(
        {
            "o_orderkey": orders.columns["o_orderkey"],
            "pri": orders.string_tables["o_orderpriority"].decode(
                orders.columns["o_orderpriority"]
            ),
        }
    )
    j = li.merge(odf, left_on="l_orderkey", right_on="o_orderkey")
    j["high"] = np.isin(j["pri"].astype(str), ["1-URGENT", "2-HIGH"]).astype(np.int64)
    j["low"] = 1 - j["high"]
    g = j.groupby("l_shipmode", as_index=False)[["high", "low"]].sum()
    g = g.rename(columns={"high": "high_line_count", "low": "low_line_count"})
    return g.sort_values("l_shipmode").reset_index(drop=True)


# ---- Q14: promotion effect ---------------------------------------------------

Q14_COLUMNS = {
    "part": ["p_partkey", "p_type"],
    "lineitem": ["l_partkey", "l_shipdate", "l_extendedprice", "l_discount"],
}


def q14_oracle(part, lineitem) -> pd.DataFrame:
    lo, hi = _days("1995-09-01"), _days("1995-10-01")
    c = lineitem.columns
    keep = (c["l_shipdate"] >= lo) & (c["l_shipdate"] < hi)
    li = pd.DataFrame(
        {
            "l_partkey": c["l_partkey"][keep],
            "vol": c["l_extendedprice"][keep].astype(np.int64)
            * (100 - c["l_discount"][keep].astype(np.int64)),
        }
    )
    ptype = part.string_tables["p_type"].decode(part.columns["p_type"])
    pt = pd.DataFrame(
        {
            "p_partkey": part.columns["p_partkey"],
            "promo": np.char.startswith(ptype.astype(str), "PROMO"),
        }
    )
    j = li.merge(pt, left_on="l_partkey", right_on="p_partkey")
    sp = int(j.loc[j["promo"], "vol"].sum())
    sv = int(j["vol"].sum())
    val = 100.0 * ((np.float64(sp) / 1e4) / (np.float64(sv) / 1e4))
    return pd.DataFrame({"promo_revenue": [val]})


# ---- Q9: product type profit measure --------------------------------------

Q9_COLUMNS = {
    "part": ["p_partkey", "p_name"],
    "supplier": ["s_suppkey", "s_nationkey"],
    "nation": ["n_nationkey", "n_name"],
    "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"],
    "orders": ["o_orderkey", "o_orderdate"],
    "lineitem": [
        "l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
        "l_extendedprice", "l_discount",
    ],
}


def q9_oracle(part, supplier, nation, partsupp, orders, lineitem) -> pd.DataFrame:
    pname = part.string_tables["p_name"].decode(part.columns["p_name"])
    green = part.columns["p_partkey"][
        np.asarray([("green" in s) for s in pname], dtype=bool)
    ]
    li_keep = np.isin(lineitem.columns["l_partkey"], green)
    li = pd.DataFrame(
        {
            "l_orderkey": lineitem.columns["l_orderkey"][li_keep],
            "l_partkey": lineitem.columns["l_partkey"][li_keep],
            "l_suppkey": lineitem.columns["l_suppkey"][li_keep],
            "qty": lineitem.columns["l_quantity"][li_keep].astype(np.int64),
            "gross": lineitem.columns["l_extendedprice"][li_keep].astype(np.int64)
            * (100 - lineitem.columns["l_discount"][li_keep].astype(np.int64)),
        }
    )
    nat = pd.DataFrame(
        {
            "n_nationkey": nation.columns["n_nationkey"],
            "nation": nation.string_tables["n_name"].decode(
                nation.columns["n_name"]
            ),
        }
    )
    sup = pd.DataFrame(
        {
            "s_suppkey": supplier.columns["s_suppkey"],
            "s_nationkey": supplier.columns["s_nationkey"],
        }
    ).merge(nat, left_on="s_nationkey", right_on="n_nationkey")
    ps = pd.DataFrame(
        {
            "ps_partkey": partsupp.columns["ps_partkey"],
            "ps_suppkey": partsupp.columns["ps_suppkey"],
            "cost": partsupp.columns["ps_supplycost"].astype(np.int64),
        }
    )
    odf = pd.DataFrame(
        {
            "o_orderkey": orders.columns["o_orderkey"],
            "o_year": (
                pd.to_datetime(
                    orders.columns["o_orderdate"], unit="D", origin="1970-01-01"
                ).year
            ),
        }
    )
    j = li.merge(sup, left_on="l_suppkey", right_on="s_suppkey")
    j = j.merge(
        ps,
        left_on=["l_partkey", "l_suppkey"],
        right_on=["ps_partkey", "ps_suppkey"],
    )
    j = j.merge(odf, left_on="l_orderkey", right_on="o_orderkey")
    j["amount"] = j["gross"] - j["cost"] * j["qty"]
    g = j.groupby(["nation", "o_year"], as_index=False)["amount"].sum()
    g["sum_profit"] = g["amount"] / 1e4
    g = g.sort_values(["nation", "o_year"], ascending=[True, False])
    return g[["nation", "o_year", "sum_profit"]].reset_index(drop=True)


# ---- Q10: returned item reporting -----------------------------------------

Q10_COLUMNS = {
    "customer": [
        "c_custkey", "c_name", "c_acctbal", "c_phone", "c_nationkey",
        "c_address", "c_comment",
    ],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
    "lineitem": ["l_orderkey", "l_returnflag", "l_extendedprice", "l_discount"],
    "nation": ["n_nationkey", "n_name"],
}


def q10_oracle(customer, orders, lineitem, nation, limit=20) -> pd.DataFrame:
    lo, hi = _days("1993-10-01"), _days("1994-01-01")
    okeep = (orders.columns["o_orderdate"] >= lo) & (
        orders.columns["o_orderdate"] < hi
    )
    odf = pd.DataFrame(
        {
            "o_orderkey": orders.columns["o_orderkey"][okeep],
            "o_custkey": orders.columns["o_custkey"][okeep],
        }
    )
    r_code = lineitem.string_tables["l_returnflag"].lookup("R")
    lkeep = lineitem.columns["l_returnflag"] == r_code
    li = pd.DataFrame(
        {
            "l_orderkey": lineitem.columns["l_orderkey"][lkeep],
            "rev": lineitem.columns["l_extendedprice"][lkeep].astype(np.int64)
            * (100 - lineitem.columns["l_discount"][lkeep].astype(np.int64)),
        }
    )
    j = li.merge(odf, left_on="l_orderkey", right_on="o_orderkey")
    g = j.groupby("o_custkey", as_index=False)["rev"].sum()
    cust = pd.DataFrame(
        {
            "c_custkey": customer.columns["c_custkey"],
            "c_name": customer.string_tables["c_name"].decode(
                customer.columns["c_name"]
            ),
            "c_acctbal": customer.columns["c_acctbal"].astype(np.int64) / 100.0,
            "c_phone": customer.string_tables["c_phone"].decode(
                customer.columns["c_phone"]
            ),
            "c_nationkey": customer.columns["c_nationkey"],
            "c_address": customer.string_tables["c_address"].decode(
                customer.columns["c_address"]
            ),
            "c_comment": customer.string_tables["c_comment"].decode(
                customer.columns["c_comment"]
            ),
        }
    )
    nat = pd.DataFrame(
        {
            "n_nationkey": nation.columns["n_nationkey"],
            "n_name": nation.string_tables["n_name"].decode(
                nation.columns["n_name"]
            ),
        }
    )
    j2 = g.merge(cust, left_on="o_custkey", right_on="c_custkey").merge(
        nat, left_on="c_nationkey", right_on="n_nationkey"
    )
    j2["revenue"] = j2["rev"] / 1e4
    j2 = j2.sort_values(["revenue", "c_custkey"], ascending=[False, True]).head(
        limit
    )
    return j2[
        [
            "c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
            "c_address", "c_phone", "c_comment",
        ]
    ].reset_index(drop=True)


QUERY_COLUMNS: Dict[int, object] = {
    1: {"lineitem": Q1_COLUMNS},
    2: Q2_COLUMNS,
    3: Q3_COLUMNS,
    4: Q4_COLUMNS,
    5: Q5_COLUMNS,
    6: {"lineitem": Q6_COLUMNS},
    7: Q7_COLUMNS,
    8: Q8_COLUMNS,
    9: Q9_COLUMNS,
    10: Q10_COLUMNS,
    11: Q11_COLUMNS,
    12: Q12_COLUMNS,
    13: Q13_COLUMNS,
    14: Q14_COLUMNS,
    15: Q15_COLUMNS,
    16: Q16_COLUMNS,
    17: Q17_COLUMNS,
    18: Q18_COLUMNS,
    19: Q19_COLUMNS,
    20: Q20_COLUMNS,
    21: Q21_COLUMNS,
    22: Q22_COLUMNS,
}

# ---------------------------------------------------------------------------
# SQL texts for the remaining queries (the native SQL frontend surface;
# reference analog: velox/exec/tests/utils/TpchQueryBuilder + the spec's
# query templates).  Dialect notes: year(d) for extract(year from d),
# substr() for substring(), explicit casts to double where the spec relies
# on implicit decimal division, and FROM orders that join left-to-right
# (the planner joins in author order, like the reference's hand-built plans).

Q2_SQL = """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
       s_comment
from partsupp, part, supplier, nation, region
where p_partkey = ps_partkey and s_suppkey = ps_suppkey
  and p_size = 15 and p_type like '%BRASS'
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'EUROPE'
  and ps_supplycost = (
    select min(ps_supplycost)
    from partsupp, supplier, nation, region
    where p_partkey = ps_partkey and s_suppkey = ps_suppkey
      and s_nationkey = n_nationkey and n_regionkey = r_regionkey
      and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
"""

Q4_SQL = """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01' and o_orderdate < date '1993-10-01'
  and exists (
    select l_orderkey from lineitem
    where l_orderkey = o_orderkey and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority
"""

Q5_SQL = """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA'
  and o_orderdate >= date '1994-01-01' and o_orderdate < date '1995-01-01'
group by n_name
order by revenue desc
"""

Q7_SQL = """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (
  select n1.n_name as supp_nation, n2.n_name as cust_nation,
         year(l_shipdate) as l_year,
         l_extendedprice * (1 - l_discount) as volume
  from supplier, lineitem, orders, customer, nation n1, nation n2
  where s_suppkey = l_suppkey and o_orderkey = l_orderkey
    and c_custkey = o_custkey
    and s_nationkey = n1.n_nationkey and c_nationkey = n2.n_nationkey
    and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
         or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
    and l_shipdate >= date '1995-01-01' and l_shipdate <= date '1996-12-31'
) shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
"""

Q8_SQL = """
select o_year,
       cast(sum(case when nation = 'BRAZIL' then volume else 0 end) as double)
         / cast(sum(volume) as double) as mkt_share
from (
  select year(o_orderdate) as o_year,
         l_extendedprice * (1 - l_discount) as volume,
         n2.n_name as nation
  from part, lineitem, orders, customer, nation n1, region, supplier,
       nation n2
  where p_partkey = l_partkey and l_orderkey = o_orderkey
    and o_custkey = c_custkey and c_nationkey = n1.n_nationkey
    and n1.n_regionkey = r_regionkey and r_name = 'AMERICA'
    and s_suppkey = l_suppkey and s_nationkey = n2.n_nationkey
    and o_orderdate >= date '1995-01-01' and o_orderdate <= date '1996-12-31'
    and p_type = 'ECONOMY ANODIZED STEEL'
) all_nations
group by o_year
order by o_year
"""

Q9_SQL = """
select nation, o_year, sum(amount) as sum_profit
from (
  select n_name as nation, year(o_orderdate) as o_year,
         l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity
           as amount
  from lineitem, part, supplier, partsupp, orders, nation
  where l_partkey = p_partkey and l_suppkey = s_suppkey
    and ps_partkey = l_partkey and ps_suppkey = l_suppkey
    and o_orderkey = l_orderkey and s_nationkey = n_nationkey
    and p_name like '%green%'
) profit
group by nation, o_year
order by nation, o_year desc
"""

Q10_SQL = """
select c_custkey, c_name,
       sum(l_extendedprice * (1 - l_discount)) as revenue,
       c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01' and o_orderdate < date '1994-01-01'
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
order by revenue desc, c_custkey
limit 20
"""

Q12_SQL = """
select l_shipmode,
       sum(case when o_orderpriority in ('1-URGENT', '2-HIGH')
           then 1 else 0 end) as high_line_count,
       sum(case when o_orderpriority in ('1-URGENT', '2-HIGH')
           then 0 else 1 end) as low_line_count
from lineitem, orders
where l_orderkey = o_orderkey
  and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1995-01-01'
group by l_shipmode
order by l_shipmode
"""

Q14_SQL = """
select cast(100 as double)
       * (cast(sum(case when p_type like 'PROMO%'
                   then l_extendedprice * (1 - l_discount)
                   else 0 end) as double)
          / cast(sum(l_extendedprice * (1 - l_discount)) as double))
       as promo_revenue
from lineitem, part
where l_partkey = p_partkey
  and l_shipdate >= date '1995-09-01' and l_shipdate < date '1995-10-01'
"""

Q15_SQL = """
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier,
     (select l_suppkey as supplier_no,
             sum(l_extendedprice * (1 - l_discount)) as total_revenue
      from lineitem
      where l_shipdate >= date '1996-01-01'
        and l_shipdate < date '1996-04-01'
      group by l_suppkey) revenue0
where s_suppkey = supplier_no
  and total_revenue = (
    select max(total_revenue)
    from (select l_suppkey as supplier_no,
                 sum(l_extendedprice * (1 - l_discount)) as total_revenue
          from lineitem
          where l_shipdate >= date '1996-01-01'
            and l_shipdate < date '1996-04-01'
          group by l_suppkey) revenue1)
order by s_suppkey
"""

Q16_SQL = """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey
  and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%'
  and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (
    select s_suppkey from supplier
    where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
"""

Q17_SQL = """
select cast(sum(l_extendedprice) as double) / cast(7 as double)
       as avg_yearly
from lineitem, part
where p_partkey = l_partkey
  and p_brand = 'Brand#23' and p_container = 'MED BOX'
  and l_quantity < (
    select 0.2 * avg(l_quantity) from lineitem
    where l_partkey = p_partkey)
"""

Q18_SQL = """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity) as sum_qty
from customer, orders, lineitem
where o_orderkey in (
    select l_orderkey from lineitem
    group by l_orderkey having sum(l_quantity) > 300)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate, o_orderkey
limit 100
"""

Q19_SQL = """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem join part on p_partkey = l_partkey
where (p_brand = 'Brand#12'
       and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
       and l_quantity >= 1 and l_quantity <= 11
       and p_size >= 1 and p_size <= 5
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_brand = 'Brand#23'
       and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
       and l_quantity >= 10 and l_quantity <= 20
       and p_size >= 1 and p_size <= 10
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_brand = 'Brand#34'
       and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
       and l_quantity >= 20 and l_quantity <= 30
       and p_size >= 1 and p_size <= 15
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
"""

Q20_SQL = """
select s_name, s_address
from supplier, nation
where s_suppkey in (
    select ps_suppkey from partsupp
    where ps_partkey in (
        select p_partkey from part where p_name like 'forest%')
      and ps_availqty > (
        select 0.5 * sum(l_quantity) from lineitem
        where l_partkey = ps_partkey and l_suppkey = ps_suppkey
          and l_shipdate >= date '1994-01-01'
          and l_shipdate < date '1995-01-01'))
  and s_nationkey = n_nationkey and n_name = 'CANADA'
order by s_name
"""

Q21_SQL = """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey
  and o_orderstatus = 'F'
  and l1.l_receiptdate > l1.l_commitdate
  and exists (
    select l_orderkey from lineitem l2
    where l2.l_orderkey = l1.l_orderkey
      and l2.l_suppkey <> l1.l_suppkey)
  and not exists (
    select l_orderkey from lineitem l3
    where l3.l_orderkey = l1.l_orderkey
      and l3.l_suppkey <> l1.l_suppkey
      and l3.l_receiptdate > l3.l_commitdate)
  and s_nationkey = n_nationkey and n_name = 'SAUDI ARABIA'
group by s_name
order by numwait desc, s_name
limit 100
"""

Q22_SQL = """
select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (select substr(c_phone, 1, 2) as cntrycode, c_acctbal, c_custkey
      from customer
      where substr(c_phone, 1, 2)
            in ('13', '31', '23', '29', '30', '18', '17')) custsale
where c_acctbal > (
    select avg(c_acctbal) from customer
    where c_acctbal > 0.00
      and substr(c_phone, 1, 2)
          in ('13', '31', '23', '29', '30', '18', '17'))
  and not exists (
    select o_custkey from orders where o_custkey = c_custkey)
group by cntrycode
order by cntrycode
"""

Q11_SQL = """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
  and n_name = 'GERMANY'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) >
       (select sum(ps_supplycost * ps_availqty)
        from partsupp, supplier, nation
        where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
          and n_name = 'GERMANY')
       / (select count(*) from supplier)
order by value desc, ps_partkey
"""
# (the spec writes the threshold as sum(...) * fraction with fraction =
# 0.0001 / SF; dividing by count(supplier) = 10000 * SF is the same number
# and keeps the SQL scale-free, matching plans.build_q11)

SQL = {
    1: Q1_SQL, 2: Q2_SQL, 3: Q3_SQL, 4: Q4_SQL, 5: Q5_SQL, 6: Q6_SQL,
    7: Q7_SQL, 8: Q8_SQL, 9: Q9_SQL, 10: Q10_SQL, 11: Q11_SQL, 12: Q12_SQL,
    13: Q13_SQL, 14: Q14_SQL, 15: Q15_SQL, 16: Q16_SQL, 17: Q17_SQL,
    18: Q18_SQL, 19: Q19_SQL, 20: Q20_SQL, 21: Q21_SQL, 22: Q22_SQL,
}
