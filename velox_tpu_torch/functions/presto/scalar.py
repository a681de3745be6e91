"""Presto-semantic scalar functions (the part the ported plans bind).

Counterpart of the JAX package's ``functions/presto/scalar.py``, under the same
registered names.  Reference: velox/functions/prestosql/Arithmetic.h,
Comparisons.h, DateTimeFunctions.h.

Every impl is a batch function over decoded torch tensors.  DECIMAL args arrive
as unscaled int64 at an aligned scale (the registry's common-numeric coercion
inserts rescale casts), so decimal plus/minus/compare are plain int64 ops.

Registered here: plus, minus, multiply, divide, mod, negate, abs,
date_add_days, year, the six comparisons, between, is_null, is_not_null, not, and the
type-resolution signatures of the dictionary-bound string functions
(expr/binding.py).  Math, bitwise, calendar, timestamp, probability and JSON
families come with later slices; an unregistered name raises ``KeyError``
naming the function when an expression using it is parsed.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ...dtypes import BIGINT, BOOLEAN, DOUBLE, VARCHAR, DataType, TypeKind, decimal
from ...expr.registry import (
    ANY,
    DEFAULT_REGISTRY,
    INTEGER as INT_M,
    NUMERIC,
    STRINGY,
)

_reg = DEFAULT_REGISTRY


def _same_type(arg_types: Sequence[DataType]) -> DataType:
    return arg_types[0]


def _decimal_add_type(arg_types):
    a = arg_types[0]
    if a.kind != TypeKind.DECIMAL:
        return a
    # After coercion both args share (p, s); one more integer digit for the
    # carry.  Long-decimal inputs stay long.
    cap = 38 if a.precision > 18 else 18
    return decimal(min(cap, a.precision + 1), a.scale)


def _decimal_mul_type(arg_types):
    # Presto rule: multiply does NOT align scales — result scale is s1+s2.
    # (Aligning first would inflate the scale and overflow int64 sums.)
    # Short x short stays int64-clamped (documented deviation: the reference
    # widens to HUGEINT past 18 digits).
    a, b = arg_types[0], arg_types[1]
    if a.kind != TypeKind.DECIMAL:
        return a
    cap = 38 if (a.precision > 18 or b.precision > 18) else 18
    return decimal(min(cap, a.precision + b.precision), a.scale + b.scale)


# ---- arithmetic ----------------------------------------------------------


def _plus(ctx, out_t, arg_ts, a, b):
    return a + b


def _minus(ctx, out_t, arg_ts, a, b):
    return a - b


def _multiply(ctx, out_t, arg_ts, a, b):
    return a * b


def _divide_float(ctx, out_t, arg_ts, a, b):
    # IEEE semantics: x/0 -> inf/nan, matching Presto DOUBLE division.
    return a / b


def _divide_int(ctx, out_t, arg_ts, a, b):
    errors = b == 0
    safe_b = torch.where(errors, torch.ones_like(b), b)
    # Presto integer division truncates toward zero.
    q = torch.sign(a) * torch.sign(safe_b) * (
        torch.abs(a) // torch.abs(safe_b)
    )
    return q.to(out_t.device_dtype), errors


def _divide_decimal(ctx, out_t, arg_ts, a, b):
    # short DECIMAL / DECIMAL -> DOUBLE (documented deviation: Presto keeps
    # decimals; the exact path requires the 128-bit rescaled dividend).
    sa, sb = arg_ts[0].scale, arg_ts[1].scale
    errors = b == 0
    safe_b = torch.where(errors, torch.ones_like(b), b)
    val = (a.to(torch.float64) / 10.0**sa) / (safe_b.to(torch.float64) / 10.0**sb)
    return val, errors


def _decimal_div_type(arg_types):
    a, b = arg_types[0], arg_types[1]
    if a.precision > 18 or b.precision > 18:
        raise NotImplementedError("long-decimal division is not ported yet")
    return DOUBLE


def _mod(ctx, out_t, arg_ts, a, b):
    if arg_ts[0].is_floating:
        return torch.fmod(a, b)
    errors = b == 0
    safe_b = torch.where(errors, torch.ones_like(b), b)
    # Presto mod takes the dividend's sign (fmod semantics), not Python's.
    m = torch.sign(a) * (torch.abs(a) % torch.abs(safe_b))
    return m.to(out_t.device_dtype), errors


def _negate(ctx, out_t, arg_ts, a):
    return -a


_reg.register("plus", [NUMERIC, NUMERIC], _decimal_add_type, _plus, coerce_common_numeric=True)
_reg.register("minus", [NUMERIC, NUMERIC], _decimal_add_type, _minus, coerce_common_numeric=True)
# decimal*decimal keeps raw scales (registered first so it wins over the
# coercing generic overload; int/float mixes widen to decimal and land here too)
_reg.register("multiply", [TypeKind.DECIMAL, TypeKind.DECIMAL], _decimal_mul_type, _multiply)
_reg.register("multiply", [NUMERIC, NUMERIC], _decimal_mul_type, _multiply, coerce_common_numeric=True)
_reg.register("divide", [TypeKind.DOUBLE, TypeKind.DOUBLE], DOUBLE, _divide_float)
_reg.register("divide", [TypeKind.REAL, TypeKind.REAL], _same_type, _divide_float, coerce_common_numeric=True)
_reg.register("divide", [TypeKind.DECIMAL, TypeKind.DECIMAL], _decimal_div_type, _divide_decimal)
_reg.register("divide", [INT_M, INT_M], _same_type, _divide_int, coerce_common_numeric=True)
_reg.register("mod", [NUMERIC, NUMERIC], _same_type, _mod, coerce_common_numeric=True)
_reg.register("negate", [NUMERIC], _same_type, _negate)
_reg.register("abs", [NUMERIC], _same_type, lambda ctx, out_t, arg_ts, a: torch.abs(a))

# DATE +/- integer days (Presto: date + interval day; simplified to int days).
_reg.register(
    "date_add_days",
    [TypeKind.DATE, INT_M],
    lambda ts: ts[0],
    lambda ctx, out_t, arg_ts, d, n: d + n.to(torch.int32),
)

# ---- comparisons ---------------------------------------------------------


def _cmp(op):
    def impl(ctx, out_t, arg_ts, a, b):
        return op(a, b)

    return impl


for _name, _op in [
    ("eq", lambda a, b: a == b),
    ("neq", lambda a, b: a != b),
    ("lt", lambda a, b: a < b),
    ("gt", lambda a, b: a > b),
    ("lte", lambda a, b: a <= b),
    ("gte", lambda a, b: a >= b),
]:
    _reg.register(_name, [NUMERIC, NUMERIC], BOOLEAN, _cmp(_op), coerce_common_numeric=True)
    _reg.register(_name, [TypeKind.DATE, TypeKind.DATE], BOOLEAN, _cmp(_op))
    _reg.register(_name, [TypeKind.TIMESTAMP, TypeKind.TIMESTAMP], BOOLEAN, _cmp(_op))
    _reg.register(_name, [TypeKind.BOOLEAN, TypeKind.BOOLEAN], BOOLEAN, _cmp(_op))

# String equality compares dictionary codes — valid because literals are interned
# into the column's table at bind time (expr/binding.py).
_reg.register("eq", [STRINGY, STRINGY], BOOLEAN, _cmp(lambda a, b: a == b))
_reg.register("neq", [STRINGY, STRINGY], BOOLEAN, _cmp(lambda a, b: a != b))


def _unbound_string_fn(name):
    def impl(ctx, out_t, arg_ts, *args):
        raise RuntimeError(
            f"{name}() must be bound to a dictionary first — run "
            "expr.binding.bind_string_literals (PlanBuilder does this)"
        )

    return impl


# Dictionary-rewritten string functions: these signatures exist for type
# resolution; evaluation happens via DictLookup after the bind-time rewrite
# (expr/binding.py).
_reg.register("like", [STRINGY, STRINGY], BOOLEAN, _unbound_string_fn("like"))
_reg.register("like", [STRINGY, STRINGY, STRINGY], BOOLEAN, _unbound_string_fn("like"))
_reg.register("length", [STRINGY], BIGINT, _unbound_string_fn("length"))
for _sname in ("lower", "upper", "trim", "ltrim", "rtrim", "reverse"):
    _reg.register(_sname, [STRINGY], VARCHAR, _unbound_string_fn(_sname))
_reg.register("substr", [STRINGY, INT_M], VARCHAR, _unbound_string_fn("substr"))
_reg.register("substr", [STRINGY, INT_M, INT_M], VARCHAR, _unbound_string_fn("substr"))
_reg.register("substring", [STRINGY, INT_M], VARCHAR, _unbound_string_fn("substring"))
_reg.register("substring", [STRINGY, INT_M, INT_M], VARCHAR, _unbound_string_fn("substring"))
_reg.register("strpos", [STRINGY, STRINGY], BIGINT, _unbound_string_fn("strpos"))
for _bname in ("starts_with", "ends_with", "regexp_like"):
    _reg.register(_bname, [STRINGY, STRINGY], BOOLEAN, _unbound_string_fn(_bname))
_reg.register("concat", [STRINGY, STRINGY], VARCHAR, _unbound_string_fn("concat"))
_reg.register("concat", [STRINGY, STRINGY, STRINGY], VARCHAR, _unbound_string_fn("concat"))


def _between(ctx, out_t, arg_ts, x, lo, hi):
    return (x >= lo) & (x <= hi)


_reg.register("between", [NUMERIC, NUMERIC, NUMERIC], BOOLEAN, _between, coerce_common_numeric=True)
_reg.register("between", [TypeKind.DATE, TypeKind.DATE, TypeKind.DATE], BOOLEAN, _between)
_reg.register(
    "between",
    [TypeKind.TIMESTAMP, TypeKind.TIMESTAMP, TypeKind.TIMESTAMP],
    BOOLEAN,
    _between,
)

# ---- null handling (null-aware) -----------------------------------------


def _is_null(ctx, out_t, arg_ts, a):
    values, validity = a
    if validity is None:
        return torch.zeros_like(values, dtype=torch.bool), None
    return ~validity, None


def _is_not_null(ctx, out_t, arg_ts, a):
    values, validity = a
    if validity is None:
        return torch.ones_like(values, dtype=torch.bool), None
    return validity, None


_reg.register("is_null", [ANY], BOOLEAN, _is_null, null_aware=True)
_reg.register("is_not_null", [ANY], BOOLEAN, _is_not_null, null_aware=True)

# ---- logical -------------------------------------------------------------

_reg.register(
    "not",
    [TypeKind.BOOLEAN],
    BOOLEAN,
    lambda ctx, out_t, arg_ts, a: ~a,
)


# ---- datetime ------------------------------------------------------------
#
# DATE is int32 days since 1970-01-01.  The civil-calendar decomposition is
# the days-to-(y, m, d) algorithm over the proleptic Gregorian calendar, in
# integer tensor ops.  Only ``year`` is registered: no ported plan or SQL text
# binds quarter, month or day.


def _civil_from_days(z: torch.Tensor):
    z = z.to(torch.int64) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097  # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365  # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)  # [0, 365]
    mp = (5 * doy + 2) // 153  # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1  # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)  # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d, doy


def _date_days(values: torch.Tensor, dtype: DataType) -> torch.Tensor:
    if dtype.kind == TypeKind.TIMESTAMP:
        return torch.div(values, 86_400_000_000, rounding_mode="floor")
    return values


def _year(ctx, out_t, arg_ts, a):
    y, _, _, _ = _civil_from_days(_date_days(a, arg_ts[0]))
    return y.to(torch.int64)


_reg.register("year", [TypeKind.DATE], BIGINT, _year)
_reg.register("year", [TypeKind.TIMESTAMP], BIGINT, _year)
