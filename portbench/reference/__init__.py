"""The plain reference: each query kind worked out again in plain torch from
the benchmark's generated columns (``datagen``), with no code of the program.

``answer(data, params, precision, memo)`` returns the query's rows as the
columns ``compare.compare`` reads.  ``precision="exact"`` computes decimals in
int64 and DOUBLE in float64, as the configuration states; ``"float32"`` is the
control: the same arithmetic in float32, which the comparison must refuse.
``memo`` keeps what one data set's answers share (lookups by order key).
"""

import torch


def wide(precision: str):
    """The dtype the answer's arithmetic runs in."""
    if precision == "exact":
        return torch.int64
    if precision == "float32":
        return torch.float32
    raise ValueError(f"unknown precision {precision!r}")


def unscaled(total) -> int:
    """A decimal sum (a tensor or a number) as an unscaled integer: a float
    sum is rounded to the nearest one."""
    value = total.item() if isinstance(total, torch.Tensor) else total
    return value if isinstance(value, int) else int(round(value))


def dense(keys: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``values`` laid out densely by ``keys`` (0 where no key is)."""
    keys = keys.long()
    out = torch.zeros(int(keys.max()) + 1, dtype=values.dtype, device=values.device)
    out[keys] = values
    return out


def by_orderkey(data, memo, column: str) -> torch.Tensor:
    """An orders column laid out densely by order key, kept in ``memo``."""
    if column not in memo:
        memo[column] = dense(data["orders"]["o_orderkey"], data["orders"][column])
    return memo[column]
