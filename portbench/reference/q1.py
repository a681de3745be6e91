"""Q1 worked out from the generated lineitem columns."""

import torch

from ..datagen import LINESTATUSES, RETURNFLAGS, days
from . import unscaled, wide


def answer(data, p, precision="exact", memo=None):
    li = data["lineitem"]
    keep = li["l_shipdate"] <= days("1998-12-01") - p["delta"]
    gid = (li["l_returnflag"].long() - 1) * len(LINESTATUSES) + (li["l_linestatus"].long() - 1)
    t = wide(precision)
    qty, ep, disc, tax = (li[c].to(t) for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = ep * (100 - disc)  # scale 4
    charge = disc_price * (100 + tax)  # scale 6
    groups = sorted(
        (RETURNFLAGS[g // len(LINESTATUSES)], LINESTATUSES[g % len(LINESTATUSES)], g)
        for g in range(len(RETURNFLAGS) * len(LINESTATUSES))
    )
    rows = []
    for rf, ls, g in groups:
        m = keep & (gid == g)
        count = int(m.sum().item())
        if count == 0:
            continue
        zero = torch.zeros((), dtype=t, device=m.device)
        s_qty, s_ep, s_dp, s_ch, s_disc = (
            torch.where(m, x, zero).sum() for x in (qty, ep, disc_price, charge, disc)
        )
        if precision == "exact":
            avgs = [s.item() / 100.0 / count for s in (s_qty, s_ep, s_disc)]
        else:
            avgs = [(s / 100.0 / count).item() for s in (s_qty, s_ep, s_disc)]
        rows.append((rf, ls, unscaled(s_qty), unscaled(s_ep), unscaled(s_dp), unscaled(s_ch),
                     *avgs, count))
    cols = list(zip(*rows)) if rows else [()] * 10
    return [
        ("l_returnflag", "string", 0, cols[0]),
        ("l_linestatus", "string", 0, cols[1]),
        ("sum_qty", "decimal", 2, cols[2]),
        ("sum_base_price", "decimal", 2, cols[3]),
        ("sum_disc_price", "decimal", 4, cols[4]),
        ("sum_charge", "decimal", 6, cols[5]),
        ("avg_qty", "double", 0, cols[6]),
        ("avg_price", "double", 0, cols[7]),
        ("avg_disc", "double", 0, cols[8]),
        ("count_order", "int", 0, cols[9]),
    ]
