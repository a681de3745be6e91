"""Q6 worked out from the generated lineitem columns."""

import torch

from ..datagen import days
from . import unscaled, wide


def answer(data, p, precision="exact", memo=None):
    li = data["lineitem"]
    year, d = p["year"], p["discount"]
    ship, disc = li["l_shipdate"], li["l_discount"]
    keep = (
        (ship >= days(f"{year}-01-01")) & (ship < days(f"{year + 1}-01-01"))
        & (disc >= d - 1) & (disc <= d + 1)
        & (li["l_quantity"] < p["quantity"] * 100)
    )
    t = wide(precision)
    revenue = torch.where(keep, li["l_extendedprice"].to(t) * disc.to(t),
                          torch.zeros((), dtype=t, device=keep.device)).sum()
    value = unscaled(revenue) if bool(keep.any()) else None  # scale 4
    return [("revenue", "decimal", 4, [value])]
