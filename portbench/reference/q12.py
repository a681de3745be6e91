"""Q12 worked out from the generated orders and lineitem columns: the lines
of the two ship modes received in the year, committed before receipt and
shipped before commit, counted by ship mode and by whether their order's
priority is 1-URGENT or 2-HIGH."""

from ..datagen import PRIORITIES, SHIPMODES, days
from . import by_orderkey, unscaled, wide


def answer(data, p, precision="exact", memo=None):
    memo = {} if memo is None else memo
    li = data["lineitem"]
    year = p["year"]
    receipt = li["l_receiptdate"]
    keep = (
        (li["l_commitdate"] < receipt) & (li["l_shipdate"] < li["l_commitdate"])
        & (receipt >= days(f"{year}-01-01")) & (receipt < days(f"{year + 1}-01-01"))
    )
    priority = by_orderkey(data, memo, "o_orderpriority")[li["l_orderkey"].long()]
    high = (priority == PRIORITIES.index("1-URGENT") + 1) | (priority == PRIORITIES.index("2-HIGH") + 1)
    t = wide(precision)
    rows = []
    for mode in sorted(p["shipmodes"]):
        m = keep & (li["l_shipmode"] == SHIPMODES.index(mode) + 1)
        if not bool(m.any()):
            continue
        rows.append((mode, unscaled((m & high).to(t).sum()), unscaled((m & ~high).to(t).sum())))
    cols = list(zip(*rows)) if rows else [()] * 3
    return [
        ("l_shipmode", "string", 0, cols[0]),
        ("high_line_count", "int", 0, cols[1]),
        ("low_line_count", "int", 0, cols[2]),
    ]
