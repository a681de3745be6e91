"""The comparison that decides ``correct``: an answer of the program against
the reference's answer to the same query over the same data.

An answer is a list of columns ``(name, kind, scale, values)``, one value a
row, None for NULL.  ``kind`` is ``int`` (integers, dates as days),
``decimal`` (unscaled integers at ``scale``), ``string`` or ``double``.
Integers, decimals, dates and strings must be equal (a decimal by its value,
whatever the two scales); a DOUBLE is held to a relative gap, and a DOUBLE
that is not finite on either side differs unless both are the same value.  Rows are
compared in order: every query here fixes its order.

Imports nothing of the program.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Sequence, Tuple

Column = Tuple[str, str, int, Sequence]


def _value(kind: str, scale: int, v):
    if v is None:
        return None
    if kind == "decimal":
        return Fraction(int(v), 10 ** scale)
    if kind == "int":
        return int(v)
    if kind == "string":
        return str(v)
    return float(v)


def compare(got: List[Column], want: List[Column]) -> Tuple[int, float]:
    """(cells that differ where they must be equal, widest relative gap of a
    DOUBLE cell).  A column or row that one side lacks counts each of its
    cells as differing."""
    have = {c[0]: c for c in got}
    mismatched, gap = 0, 0.0
    for name, kind, scale, values in want:
        if name not in have:
            mismatched += len(values)
            continue
        _, gkind, gscale, gvalues = have[name]
        mismatched += abs(len(gvalues) - len(values))
        for g, w in zip(gvalues, values):
            g, w = _value(gkind, gscale, g), _value(kind, scale, w)
            if (kind == "double" and gkind == "double" and g is not None and w is not None
                    and math.isfinite(g) and math.isfinite(w)):
                gap = max(gap, abs(g - w) / abs(w) if w != 0 else abs(g - w))
            elif g != w:  # NaN differs from everything, itself included
                mismatched += 1
    return mismatched, gap
