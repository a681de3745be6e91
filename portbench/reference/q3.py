"""Q3 worked out from the generated customer, orders and lineitem columns:
orders of the segment's customers placed before DATE, joined by key to the
lines shipped after it, revenue summed by order, the first 10 by revenue
descending, order date and order key."""

import torch

from ..datagen import SEGMENTS, days
from . import by_orderkey, dense, unscaled, wide


def answer(data, p, precision="exact", memo=None):
    memo = {} if memo is None else memo
    cu, od, li = data["customer"], data["orders"], data["lineitem"]
    date = days(f"1995-03-{p['day']:02d}")
    in_segment = torch.zeros(int(cu["c_custkey"].max()) + 1, dtype=torch.bool,
                             device=cu["c_custkey"].device)
    in_segment[cu["c_custkey"][cu["c_mktsegment"] == SEGMENTS.index(p["segment"]) + 1]] = True
    order_ok = (od["o_orderdate"] < date) & in_segment[od["o_custkey"]]
    ok_by_key = dense(od["o_orderkey"], order_ok)
    lkeys = li["l_orderkey"].long()
    line_ok = (li["l_shipdate"] > date) & ok_by_key[lkeys]
    t = wide(precision)
    revenue = li["l_extendedprice"][line_ok].to(t) * (100 - li["l_discount"][line_ok].to(t))
    keys, inverse = torch.unique(lkeys[line_ok], return_inverse=True)
    sums = torch.zeros(keys.shape[0], dtype=t, device=keys.device).index_add_(0, inverse, revenue)
    if keys.shape[0] == 0:
        return _columns([])
    odate = by_orderkey(data, memo, "o_orderdate")[keys]
    oship = by_orderkey(data, memo, "o_shippriority")[keys]
    # every order tied with the 10th revenue, then the exact order on the host
    tenth = torch.topk(sums, min(10, keys.shape[0])).values[-1]
    near = torch.nonzero(sums >= tenth).flatten()
    rows = sorted(
        zip(sums[near].tolist(), odate[near].tolist(), keys[near].tolist(), oship[near].tolist()),
        key=lambda r: (-r[0], r[1], r[2]),
    )[:10]
    return _columns([(k, unscaled(rev), d, s) for rev, d, k, s in rows])


def _columns(rows):
    cols = list(zip(*rows)) if rows else [()] * 4
    return [
        ("l_orderkey", "int", 0, cols[0]),
        ("revenue", "decimal", 4, cols[1]),
        ("o_orderdate", "int", 0, cols[2]),
        ("o_shippriority", "int", 0, cols[3]),
    ]
