"""Presto-semantic scalar functions (core package).

Counterpart of the JAX package's ``functions/presto/scalar.py``, under the same
registered names and in the same order (the first matching overload wins).
Reference: velox/functions/prestosql/registration/ and
velox/functions/prestosql/Arithmetic.h, Comparisons.h, DateTimeFunctions.h.

Every impl is a batch function over decoded torch tensors on the batch's
device.  DECIMAL args arrive as unscaled int64 at an aligned scale (the
registry's common-numeric coercion inserts rescale casts), so decimal
plus/minus/compare are plain int64 ops; long decimals (precision > 18) are
lowered onto 32-bit pieces by ``exec/hugeint.py`` before a plan runs.

Where the two packages differ on purpose:

* rounding is the reference's rule, half away from zero (``torch.round``
  rounds half to even);
* ``betainc`` (beta_cdf, binomial_cdf) has no torch function: it is the
  continued fraction of ``_betainc`` in torch ops, with a fixed number of
  terms, on the tensor's device;
* subnormal results are kept (IEEE); XLA on the CPU flushes them to zero;
* torch has no ``cbrt``: it is ``sign(x) * |x| ** (1/3)``.

String functions evaluate once per dictionary entry on the host and gather
on the device (``expr/binding.py``): the signatures registered here for them
type the call, and evaluating one unbound raises.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ...dtypes import (
    BIGINT,
    BOOLEAN,
    DATE as _DATE,
    DOUBLE,
    TIMESTAMP as _TIMESTAMP,
    VARCHAR as _VARCHAR,
    DataType,
    TypeKind,
    decimal,
)
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
    # carry.  Long-decimal inputs stay long (exec/hugeint.py lowers them).
    cap = 38 if a.precision > 18 else 18
    return decimal(min(cap, a.precision + 1), a.scale)


def _decimal_mul_type(arg_types):
    # Presto rule: multiply does NOT align scales — result scale is s1+s2.
    # (Aligning first would inflate the scale and overflow int64 sums.)
    # Short x short stays int64-clamped (documented deviation: the reference
    # widens to HUGEINT past 18 digits; use widening_multiply for the exact
    # 128-bit product).  An already-long input types long.
    a, b = arg_types[0], arg_types[1]
    if a.kind != TypeKind.DECIMAL:
        return a
    cap = 38 if (a.precision > 18 or b.precision > 18) else 18
    return decimal(min(cap, a.precision + b.precision), a.scale + b.scale)


def _widening_mul_type(arg_types):
    a, b = arg_types[0], arg_types[1]
    return decimal(min(38, a.precision + b.precision), a.scale + b.scale)


def _widening_mul_unlowered(ctx, out_t, arg_ts, a, b):
    raise NotImplementedError(
        "widening_multiply must be lowered by exec/hugeint.py "
        "(LocalExecutor applies it automatically)"
    )


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


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
    q = torch.sign(a) * torch.sign(safe_b) * _floordiv(torch.abs(a), torch.abs(safe_b))
    return q.to(out_t.device_dtype), errors


def _decimal_div_type(arg_types):
    # Long inputs get exact decimal division (Presto rule: scale =
    # max(s1, s2), precision = p1 + s2 + max(0, s2 - s1)), lowered by
    # exec/hugeint.py.  Short/short keeps the DOUBLE deviation (the int64
    # surface cannot hold the rescaled dividend exactly).
    a, b = arg_types[0], arg_types[1]
    if a.kind != TypeKind.DECIMAL or b.kind != TypeKind.DECIMAL:
        return DOUBLE
    if a.precision > 18 or b.precision > 18:
        prec = a.precision + b.scale + max(0, b.scale - a.scale)
        # force the long surface so one lowering path handles all cases
        return decimal(min(38, max(19, prec)), max(a.scale, b.scale))
    return DOUBLE


def _divide_decimal(ctx, out_t, arg_ts, a, b):
    if out_t.kind == TypeKind.DECIMAL:
        raise NotImplementedError(
            "long-decimal division must be lowered by exec/hugeint.py "
            "(LocalExecutor applies it automatically)"
        )
    # short DECIMAL / DECIMAL -> DOUBLE (documented deviation: Presto keeps
    # decimals; the exact path requires the 128-bit rescaled dividend).
    sa, sb = arg_ts[0].scale, arg_ts[1].scale
    errors = b == 0
    safe_b = torch.where(errors, torch.ones_like(b), b)
    val = (a.to(torch.float64) / 10.0**sa) / (safe_b.to(torch.float64) / 10.0**sb)
    return val, errors


def _mod(ctx, out_t, arg_ts, a, b):
    if arg_ts[0].is_floating:
        return torch.fmod(a, b)
    errors = b == 0
    safe_b = torch.where(errors, torch.ones_like(b), b)
    # Presto mod takes the dividend's sign (fmod semantics), not Python's.
    m = torch.sign(a) * torch.remainder(torch.abs(a), torch.abs(safe_b))
    return m.to(out_t.device_dtype), errors


def _negate(ctx, out_t, arg_ts, a):
    return -a


_reg.register("plus", [NUMERIC, NUMERIC], _decimal_add_type, _plus, coerce_common_numeric=True)
_reg.register("minus", [NUMERIC, NUMERIC], _decimal_add_type, _minus, coerce_common_numeric=True)
# decimal*decimal keeps raw scales (registered first so it wins over the
# coercing generic overload; int/float mixes widen to decimal and land here too)
_reg.register("multiply", [TypeKind.DECIMAL, TypeKind.DECIMAL], _decimal_mul_type, _multiply)
# exact 128-bit product of two short decimals (reference: the HUGEINT
# promotion of DecimalUtil multiply); lowered by exec/hugeint.py
_reg.register(
    "widening_multiply",
    [TypeKind.DECIMAL, TypeKind.DECIMAL],
    _widening_mul_type,
    _widening_mul_unlowered,
)
_reg.register("multiply", [NUMERIC, NUMERIC], _decimal_mul_type, _multiply, coerce_common_numeric=True)
_reg.register("divide", [TypeKind.DOUBLE, TypeKind.DOUBLE], DOUBLE, _divide_float)
_reg.register("divide", [TypeKind.REAL, TypeKind.REAL], _same_type, _divide_float, coerce_common_numeric=True)
_reg.register("divide", [TypeKind.DECIMAL, TypeKind.DECIMAL], _decimal_div_type, _divide_decimal)
_reg.register("divide", [INT_M, INT_M], _same_type, _divide_int, coerce_common_numeric=True)
_reg.register("mod", [NUMERIC, NUMERIC], _same_type, _mod, coerce_common_numeric=True)
_reg.register("negate", [NUMERIC], _same_type, _negate)

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
    _reg.register(_sname, [STRINGY], _VARCHAR, _unbound_string_fn(_sname))
_reg.register("substr", [STRINGY, INT_M], _VARCHAR, _unbound_string_fn("substr"))
_reg.register("substr", [STRINGY, INT_M, INT_M], _VARCHAR, _unbound_string_fn("substr"))
_reg.register("substring", [STRINGY, INT_M], _VARCHAR, _unbound_string_fn("substring"))
_reg.register("substring", [STRINGY, INT_M, INT_M], _VARCHAR, _unbound_string_fn("substring"))
_reg.register("codepoint", [STRINGY], BIGINT, _unbound_string_fn("codepoint"))
_reg.register("strpos", [STRINGY, STRINGY], BIGINT, _unbound_string_fn("strpos"))
for _bname in ("starts_with", "ends_with", "regexp_like"):
    _reg.register(_bname, [STRINGY, STRINGY], BOOLEAN, _unbound_string_fn(_bname))
_reg.register("concat", [STRINGY, STRINGY], _VARCHAR, _unbound_string_fn("concat"))
_reg.register("concat", [STRINGY, STRINGY, STRINGY], _VARCHAR, _unbound_string_fn("concat"))
_reg.register("replace", [STRINGY, STRINGY], _VARCHAR, _unbound_string_fn("replace"))
_reg.register("replace", [STRINGY, STRINGY, STRINGY], _VARCHAR, _unbound_string_fn("replace"))
for _pname in ("lpad", "rpad"):
    _reg.register(_pname, [STRINGY, INT_M], _VARCHAR, _unbound_string_fn(_pname))
    _reg.register(_pname, [STRINGY, INT_M, STRINGY], _VARCHAR, _unbound_string_fn(_pname))
_reg.register("split_part", [STRINGY, STRINGY, INT_M], _VARCHAR, _unbound_string_fn("split_part"))
_reg.register("regexp_extract", [STRINGY, STRINGY], _VARCHAR, _unbound_string_fn("regexp_extract"))
_reg.register("regexp_extract", [STRINGY, STRINGY, INT_M], _VARCHAR, _unbound_string_fn("regexp_extract"))
_reg.register("regexp_replace", [STRINGY, STRINGY], _VARCHAR, _unbound_string_fn("regexp_replace"))
_reg.register("regexp_replace", [STRINGY, STRINGY, STRINGY], _VARCHAR, _unbound_string_fn("regexp_replace"))


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


def _nullif(ctx, out_t, arg_ts, a, b):
    av, avalid = a
    bv, bvalid = b
    both_valid = None
    if avalid is not None and bvalid is not None:
        both_valid = avalid & bvalid
    elif avalid is not None:
        both_valid = avalid
    elif bvalid is not None:
        both_valid = bvalid
    equal = av == bv
    if both_valid is not None:
        equal = equal & both_valid
    validity = ~equal if avalid is None else (avalid & ~equal)
    return av, validity


_reg.register("is_null", [ANY], BOOLEAN, _is_null, null_aware=True)
_reg.register("is_not_null", [ANY], BOOLEAN, _is_not_null, null_aware=True)
_reg.register("nullif", [ANY, ANY], _same_type, _nullif, null_aware=True)

# ---- logical -------------------------------------------------------------

_reg.register(
    "not",
    [TypeKind.BOOLEAN],
    BOOLEAN,
    lambda ctx, out_t, arg_ts, a: ~a,
)

# ---- math ----------------------------------------------------------------


def _abs(ctx, out_t, arg_ts, a):
    return torch.abs(a)


def _round(ctx, out_t, arg_ts, a, *rest):
    digits = rest[0] if rest else None
    t = arg_ts[0]
    if t.kind == TypeKind.DECIMAL:
        # round to `digits` fractional digits in decimal space, half away from zero
        if digits is None:
            drop = t.scale
        else:
            raise TypeError("round(decimal, n) with traced n unsupported; use cast")
        factor = 10**drop
        half = factor // 2
        return torch.sign(a) * _floordiv(torch.abs(a) + half, factor) * factor
    x = a.to(torch.float64) if t.is_integer else a
    if digits is None:
        # Presto rounds half away from zero; torch.round is half-to-even.
        out = torch.sign(x) * torch.floor(torch.abs(x) + 0.5)
    else:
        factor = torch.pow(10.0, digits.to(torch.float64))
        out = torch.sign(x) * torch.floor(torch.abs(x) * factor + 0.5) / factor
    # an integer rounds through DOUBLE, as in the JAX package, and keeps its type
    return out.to(out_t.device_dtype) if t.is_integer else out


def _floor(ctx, out_t, arg_ts, a):
    t = arg_ts[0]
    if t.kind == TypeKind.DECIMAL:
        return _floordiv(a, 10**t.scale)
    if t.is_integer:
        return a
    return torch.floor(a)


def _ceil(ctx, out_t, arg_ts, a):
    t = arg_ts[0]
    if t.kind == TypeKind.DECIMAL:
        return -_floordiv(-a, 10**t.scale)
    if t.is_integer:
        return a
    return torch.ceil(a)


def _ceil_floor_type(arg_types):
    t = arg_types[0]
    if t.kind == TypeKind.DECIMAL:
        return BIGINT
    return t


def _cbrt(a):
    # torch has no cbrt; the real cube root keeps the sign
    return torch.sign(a) * torch.abs(a).pow(1.0 / 3.0)


_reg.register("abs", [NUMERIC], _same_type, _abs)
_reg.register("round", [NUMERIC], _same_type, _round)
_reg.register("round", [NUMERIC, INT_M], _same_type, _round)
_reg.register("floor", [NUMERIC], _ceil_floor_type, _floor)
_reg.register("ceil", [NUMERIC], _ceil_floor_type, _ceil)
_reg.register("ceiling", [NUMERIC], _ceil_floor_type, _ceil)

for _name, _fn in [
    ("sqrt", torch.sqrt),
    ("cbrt", _cbrt),
    ("exp", torch.exp),
    ("ln", torch.log),
    ("log2", torch.log2),
    ("log10", torch.log10),
    ("sin", torch.sin),
    ("cos", torch.cos),
    ("tan", torch.tan),
    ("asin", torch.asin),
    ("acos", torch.acos),
    ("atan", torch.atan),
    ("sinh", torch.sinh),
    ("cosh", torch.cosh),
    ("tanh", torch.tanh),
    ("asinh", torch.asinh),
    ("acosh", torch.acosh),
    ("atanh", torch.atanh),
    ("sign", torch.sign),
]:
    _reg.register(
        _name,
        [TypeKind.DOUBLE],
        DOUBLE if _name != "sign" else _same_type,
        (lambda f: lambda ctx, out_t, arg_ts, a: f(a))(_fn),
    )

# Presto sign() also takes exact numerics and keeps their type.
_reg.register(
    "sign", [NUMERIC], _same_type,
    lambda ctx, out_t, arg_ts, a: torch.sign(a),
)

for _pname in ("power", "pow"):
    _reg.register(
        _pname,
        [TypeKind.DOUBLE, TypeKind.DOUBLE],
        DOUBLE,
        lambda ctx, out_t, arg_ts, a, b: torch.pow(a, b),
    )
_reg.register(
    "atan2",
    [TypeKind.DOUBLE, TypeKind.DOUBLE],
    DOUBLE,
    lambda ctx, out_t, arg_ts, a, b: torch.atan2(a, b),
)


def _greatest(ctx, out_t, arg_ts, *args):
    out = args[0]
    for a in args[1:]:
        out = torch.maximum(out, a)
    return out


def _least(ctx, out_t, arg_ts, *args):
    out = args[0]
    for a in args[1:]:
        out = torch.minimum(out, a)
    return out


_reg.register("greatest", [NUMERIC, NUMERIC], _same_type, _greatest, coerce_common_numeric=True, variadic=True)
_reg.register("least", [NUMERIC, NUMERIC], _same_type, _least, coerce_common_numeric=True, variadic=True)

# ---- datetime ------------------------------------------------------------
#
# DATE is int32 days since 1970-01-01.  The civil-calendar decomposition is
# the days-to-(y, m, d) algorithm over the proleptic Gregorian calendar, in
# integer tensor ops (no lookup tables).


def _civil_from_days(z: torch.Tensor):
    z = z.to(torch.int64) + 719468
    era = _floordiv(z, 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365  # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)  # [0, 365]
    mp = (5 * doy + 2) // 153  # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1  # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)  # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d, doy


def _days_from_civil(y, m, d):
    """Inverse of _civil_from_days over tensors."""
    y = torch.where(m <= 2, y - 1, y)
    era = _floordiv(y, 400)
    yoe = y - era * 400
    mp = torch.remainder(m + 9, 12)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _date_days(values: torch.Tensor, dtype: DataType) -> torch.Tensor:
    if dtype.kind == TypeKind.TIMESTAMP:
        return _floordiv(values, 86_400_000_000)
    return values


def _year(ctx, out_t, arg_ts, a):
    y, _, _, _ = _civil_from_days(_date_days(a, arg_ts[0]))
    return y.to(torch.int64)


def _quarter(ctx, out_t, arg_ts, a):
    _, m, _, _ = _civil_from_days(_date_days(a, arg_ts[0]))
    return ((m - 1) // 3 + 1).to(torch.int64)


def _month(ctx, out_t, arg_ts, a):
    _, m, _, _ = _civil_from_days(_date_days(a, arg_ts[0]))
    return m.to(torch.int64)


def _day(ctx, out_t, arg_ts, a):
    _, _, d, _ = _civil_from_days(_date_days(a, arg_ts[0]))
    return d.to(torch.int64)


def _day_of_week(ctx, out_t, arg_ts, a):
    days = _date_days(a, arg_ts[0]).to(torch.int64)
    # 1970-01-01 was a Thursday; Presto dow: Monday=1..Sunday=7.
    return torch.remainder(days + 3, 7) + 1


def _day_of_year(ctx, out_t, arg_ts, a):
    days = _date_days(a, arg_ts[0]).to(torch.int64)
    y, m, d, _ = _civil_from_days(days)
    jan1 = _days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
    return days - jan1 + 1


for _name, _impl in [
    ("year", _year),
    ("quarter", _quarter),
    ("month", _month),
    ("day", _day),
    ("day_of_month", _day),
    ("day_of_week", _day_of_week),
    ("dow", _day_of_week),
    ("day_of_year", _day_of_year),
    ("doy", _day_of_year),
]:
    _reg.register(_name, [TypeKind.DATE], BIGINT, _impl)
    _reg.register(_name, [TypeKind.TIMESTAMP], BIGINT, _impl)


# ---- bitwise (reference: functions/prestosql/Bitwise.h) -------------------
#
# torch has no uint64 arithmetic: a logical right shift is an arithmetic one
# with the sign-extended bits masked off.  A shift count outside [0, 63]
# gives what XLA gives: 0, or the sign fill for the arithmetic shift.


def _shift_ok(b):
    return (b >= 0) & (b < 64)


def _shl(a, b):
    ok = _shift_ok(b)
    return torch.where(ok, a << torch.where(ok, b, 0), torch.zeros_like(a))


def _shr_logical(a, b):
    ok = _shift_ok(b) & (b > 0)
    k = torch.where(ok, b, 1)
    low_bits = (torch.ones_like(a) << (64 - k)) - 1
    out = torch.where(ok, (a >> k) & low_bits, torch.zeros_like(a))
    return torch.where(b == 0, a, out)


def _shr_arith(a, b):
    return a >> torch.where(_shift_ok(b), b, 63)


def _bit(name, fn):
    _reg.register(
        name, [INT_M, INT_M], lambda ts: BIGINT,
        lambda ctx, out_t, arg_ts, a, b, _fn=fn: _fn(
            a.to(torch.int64), b.to(torch.int64)
        ),
    )


_bit("bitwise_and", lambda a, b: a & b)
_bit("bitwise_or", lambda a, b: a | b)
_bit("bitwise_xor", lambda a, b: a ^ b)
_bit("bitwise_left_shift", _shl)
_bit("bitwise_right_shift", _shr_logical)
_bit("bitwise_arithmetic_shift_right", _shr_arith)
_reg.register(
    "bitwise_not", [INT_M], BIGINT,
    lambda ctx, out_t, arg_ts, a: ~a.to(torch.int64),
)


def _popcount(ctx, out_t, arg_ts, a):
    # the uint64 SWAR count on int64 lanes: every mask clears the bits an
    # arithmetic shift fills, and the adds and the multiply wrap alike
    x = a.to(torch.int64)
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


_reg.register("bit_count", [INT_M], BIGINT, _popcount)

# ---- more math -------------------------------------------------------------

_reg.register("log2", [TypeKind.DOUBLE], DOUBLE, lambda c, o, t, a: torch.log2(a))
_reg.register("log10", [TypeKind.DOUBLE], DOUBLE, lambda c, o, t, a: torch.log10(a))
_reg.register("degrees", [TypeKind.DOUBLE], DOUBLE, lambda c, o, t, a: torch.rad2deg(a))
_reg.register("radians", [TypeKind.DOUBLE], DOUBLE, lambda c, o, t, a: torch.deg2rad(a))
_reg.register("atan2", [TypeKind.DOUBLE, TypeKind.DOUBLE], DOUBLE, lambda c, o, t, a, b: torch.atan2(a, b))
_reg.register("is_nan", [TypeKind.DOUBLE], BOOLEAN, lambda c, o, t, a: torch.isnan(a))
_reg.register("is_finite", [TypeKind.DOUBLE], BOOLEAN, lambda c, o, t, a: torch.isfinite(a))
_reg.register("is_infinite", [TypeKind.DOUBLE], BOOLEAN, lambda c, o, t, a: torch.isinf(a))


def _truncate(ctx, out_t, arg_ts, a, *rest):
    if arg_ts[0].kind == TypeKind.DECIMAL or arg_ts[0].is_integer:
        return a  # decimal truncate handled by cast layer; ints are exact
    n = rest[0] if rest else 0
    factor = 10.0 ** n
    return torch.trunc(a * factor) / factor


_reg.register("truncate", [TypeKind.DOUBLE], DOUBLE, _truncate)
_reg.register("truncate", [TypeKind.DOUBLE, INT_M], DOUBLE, _truncate)


# ---- probability / statistics family (reference: functions/prestosql/
# ProbabilityFunctions.cpp — boost::math there, torch.special here) ---------

# terms of the continued fraction: it converges in O(sqrt(max(a, b))) terms
# on its side of the symmetry point, so 300 hold a and b into the 10^4s
_BETAINC_TERMS = 300
_TINY = 1e-300


def _betainc(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Regularized incomplete beta I_x(a, b) in torch ops on the inputs'
    device: the modified Lentz evaluation of its continued fraction
    (Numerical Recipes ``betacf``) with a fixed number of terms, on the side
    of the symmetry point x = (a + 1) / (a + b + 2) where it converges."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)
    log_front = (
        aa * torch.log(xx) + bb * torch.log1p(-xx)
        - (torch.lgamma(aa) + torch.lgamma(bb) - torch.lgamma(aa + bb))
    )
    front = torch.exp(log_front) / aa

    def floor_tiny(v):
        return torch.where(torch.abs(v) < _TINY, torch.full_like(v, _TINY), v)

    qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0
    c = torch.ones_like(xx)
    d = 1.0 / floor_tiny(1.0 - qab * xx / qap)
    h = d
    for m in range(1, _BETAINC_TERMS + 1):
        m2 = 2.0 * m
        num = m * (bb - m) * xx / ((qam + m2) * (aa + m2))
        d = 1.0 / floor_tiny(1.0 + num * d)
        c = floor_tiny(1.0 + num / c)
        h = h * d * c
        num = -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))
        d = 1.0 / floor_tiny(1.0 + num * d)
        c = floor_tiny(1.0 + num / c)
        h = h * d * c
    part = front * h
    out = torch.where(swap, 1.0 - part, part)
    out = torch.where(x <= 0.0, torch.zeros_like(out), out)
    out = torch.where(x >= 1.0, torch.ones_like(out), out)
    bad = (a <= 0.0) | (b <= 0.0) | (x < 0.0) | (x > 1.0) | torch.isnan(x)
    return torch.where(bad, torch.full_like(out, math.nan), out)


def _prob(name, arity, fn):
    _reg.register(
        name, [NUMERIC] * arity, DOUBLE,
        (lambda f: lambda ctx, out_t, arg_ts, *a: f(
            *[x.to(torch.float64) for x in a]
        ))(fn),
    )


def _normal_cdf(mean, sd, v):
    return 0.5 * (1.0 + torch.special.erf((v - mean) / (sd * math.sqrt(2.0))))


def _inverse_normal_cdf(mean, sd, p):
    return mean + sd * torch.special.ndtri(p)


def _binomial_cdf(n, p, k):
    kf = torch.floor(k)
    mid = _betainc(torch.clamp(n - kf, min=1e-12), kf + 1.0, 1.0 - p)
    return torch.where(kf < 0, 0.0, torch.where(kf >= n, 1.0, mid))


def _poisson_cdf(lam, k):
    return torch.where(k < 0, 0.0, torch.special.gammaincc(torch.floor(k) + 1.0, lam))


def _wilson(ns, n, z, sign):
    p = ns / n
    z2 = z * z
    center = p + z2 / (2.0 * n)
    margin = z * torch.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    return (center + sign * margin) / (1.0 + z2 / n)


_prob("normal_cdf", 3, _normal_cdf)
_prob("inverse_normal_cdf", 3, _inverse_normal_cdf)
_prob("beta_cdf", 3, lambda a, b, v: _betainc(a, b, torch.clamp(v, 0.0, 1.0)))
_prob("binomial_cdf", 3, _binomial_cdf)
_prob(
    "cauchy_cdf", 3,
    lambda median, scale, v: torch.atan((v - median) / scale) / math.pi + 0.5,
)
_prob("chi_squared_cdf", 2, lambda df, v: torch.special.gammainc(df / 2.0, v / 2.0))
_prob("poisson_cdf", 2, _poisson_cdf)
_prob("wilson_interval_lower", 3, lambda ns, n, z: _wilson(ns, n, z, -1.0))
_prob("wilson_interval_upper", 3, lambda ns, n, z: _wilson(ns, n, z, 1.0))

# ---- more date functions (reference: prestosql/DateTimeFunctions.h) --------


def _week_of_year(ctx, out_t, arg_ts, a):
    """ISO 8601 week number."""
    days = _date_days(a, arg_ts[0]).to(torch.int64)
    dow = torch.remainder(days + 3, 7)  # 0=Monday
    thursday = days - dow + 3
    y, _, _, _ = _civil_from_days(thursday)
    jan1 = _days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
    return (thursday - jan1) // 7 + 1


def _year_of_week(ctx, out_t, arg_ts, a):
    days = _date_days(a, arg_ts[0]).to(torch.int64)
    dow = torch.remainder(days + 3, 7)
    thursday = days - dow + 3
    y, _, _, _ = _civil_from_days(thursday)
    return y


def _last_day_of_month(ctx, out_t, arg_ts, a):
    days = _date_days(a, arg_ts[0]).to(torch.int64)
    y, m, _, _ = _civil_from_days(days)
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, torch.ones_like(m), m + 1)
    first_next = _days_from_civil(ny, nm, torch.ones_like(m))
    return (first_next - 1).to(torch.int32)


for _name, _impl in [("week", _week_of_year), ("week_of_year", _week_of_year),
                     ("year_of_week", _year_of_week), ("yow", _year_of_week)]:
    _reg.register(_name, [TypeKind.DATE], BIGINT, _impl)
    _reg.register(_name, [TypeKind.TIMESTAMP], BIGINT, _impl)

_reg.register("last_day_of_month", [TypeKind.DATE], _DATE, _last_day_of_month)


def _trunc_to(unit):
    def impl(ctx, out_t, arg_ts, a):
        days = _date_days(a, arg_ts[0]).to(torch.int64)
        y, m, d, _ = _civil_from_days(days)
        one = torch.ones_like(m)
        if unit == "year":
            out = _days_from_civil(y, one, one)
        elif unit == "quarter":
            qm = ((m - 1) // 3) * 3 + 1
            out = _days_from_civil(y, qm, one)
        elif unit == "month":
            out = _days_from_civil(y, m, one)
        elif unit == "week":
            out = days - torch.remainder(days + 3, 7)  # Monday
        else:  # day
            out = days
        return out.to(torch.int32)

    return impl


for _unit in ("year", "quarter", "month", "week", "day"):
    _reg.register(f"date_trunc_{_unit}", [TypeKind.DATE], _DATE, _trunc_to(_unit))


def _months_between_floor(a_days, b_days):
    """Whole months from a to b (Presto date_diff('month', a, b))."""
    ya, ma, da, _ = _civil_from_days(a_days)
    yb, mb, db, _ = _civil_from_days(b_days)
    months = (yb - ya) * 12 + (mb - ma)
    # subtract one when b's day-of-month is earlier than a's
    return months - (db < da).to(months.dtype)


def _date_diff(unit):
    def impl(ctx, out_t, arg_ts, a, b):
        a64 = _date_days(a, arg_ts[0]).to(torch.int64)
        b64 = _date_days(b, arg_ts[1]).to(torch.int64)
        if unit == "day":
            return b64 - a64
        if unit == "week":
            return _floordiv(b64 - a64, 7)
        if unit == "month":
            return _months_between_floor(a64, b64)
        if unit == "quarter":
            return _floordiv(_months_between_floor(a64, b64), 3)
        return _floordiv(_months_between_floor(a64, b64), 12)  # year

    return impl


for _unit in ("day", "week", "month", "quarter", "year"):
    _reg.register(
        f"date_diff_{_unit}", [TypeKind.DATE, TypeKind.DATE], BIGINT, _date_diff(_unit)
    )


def _date_add_unit(unit):
    def impl(ctx, out_t, arg_ts, n, d):
        days = _date_days(d, arg_ts[1]).to(torch.int64)
        n64 = n.to(torch.int64)
        if unit == "day":
            return (days + n64).to(torch.int32)
        if unit == "week":
            return (days + 7 * n64).to(torch.int32)
        y, m, dd, _ = _civil_from_days(days)
        months = n64 * (12 if unit == "year" else (3 if unit == "quarter" else 1))
        total = y * 12 + (m - 1) + months
        ny, nm = _floordiv(total, 12), torch.remainder(total, 12) + 1
        # clamp day to the target month's length (Presto semantics)
        one = torch.ones_like(nm)
        nny = torch.where(nm == 12, ny + 1, ny)
        nnm = torch.where(nm == 12, one, nm + 1)
        month_len = _days_from_civil(nny, nnm, one) - _days_from_civil(ny, nm, one)
        dd = torch.minimum(dd, month_len)
        return _days_from_civil(ny, nm, dd).to(torch.int32)

    return impl


for _unit in ("day", "week", "month", "quarter", "year"):
    _reg.register(
        f"date_add_{_unit}", [INT_M, TypeKind.DATE], _DATE, _date_add_unit(_unit)
    )


# ---- timestamp functions ---------------------------------------------------
# TIMESTAMP is int64 microseconds since epoch (dtypes.py).

_USEC_DAY = 86_400_000_000


def _ts_in_day(a):
    return torch.remainder(a, _USEC_DAY)


def _from_unixtime(c, o, t, a):
    if t[0].is_floating:
        return (a.to(torch.float64) * 1e6).to(torch.int64)
    return a.to(torch.int64) * 1_000_000


_reg.register("from_unixtime", [NUMERIC], _TIMESTAMP, _from_unixtime)
_reg.register(
    "to_unixtime", [TypeKind.TIMESTAMP], DOUBLE,
    lambda c, o, t, a: a.to(torch.float64) / 1e6,
)
_reg.register(
    "hour", [TypeKind.TIMESTAMP], BIGINT,
    lambda c, o, t, a: _floordiv(_ts_in_day(a), 3_600_000_000),
)
_reg.register(
    "minute", [TypeKind.TIMESTAMP], BIGINT,
    lambda c, o, t, a: torch.remainder(_floordiv(_ts_in_day(a), 60_000_000), 60),
)
_reg.register(
    "second", [TypeKind.TIMESTAMP], BIGINT,
    lambda c, o, t, a: torch.remainder(_floordiv(_ts_in_day(a), 1_000_000), 60),
)
_reg.register(
    "millisecond", [TypeKind.TIMESTAMP], BIGINT,
    lambda c, o, t, a: torch.remainder(_floordiv(_ts_in_day(a), 1000), 1000),
)
for _u, _usec in [
    ("second", 1_000_000), ("minute", 60_000_000), ("hour", 3_600_000_000),
    ("day", _USEC_DAY),
]:
    _reg.register(
        f"date_trunc_{_u}", [TypeKind.TIMESTAMP], _TIMESTAMP,
        (lambda us: lambda c, o, t, a: _floordiv(a, us) * us)(_usec),
    )
    _reg.register(
        f"date_add_{_u}", [INT_M, TypeKind.TIMESTAMP], _TIMESTAMP,
        (lambda us: lambda c, o, t, n, a: a + n.to(torch.int64) * us)(_usec),
    )
    _reg.register(
        f"date_diff_{_u}", [TypeKind.TIMESTAMP, TypeKind.TIMESTAMP], BIGINT,
        (lambda us: lambda c, o, t, a, b: _floordiv(b - a, us))(_usec),
    )
_reg.register("date_trunc", [STRINGY, TypeKind.TIMESTAMP], _TIMESTAMP, _unbound_string_fn("date_trunc"))
_reg.register("date_add", [STRINGY, INT_M, TypeKind.TIMESTAMP], _TIMESTAMP, _unbound_string_fn("date_add"))
_reg.register("date_diff", [STRINGY, TypeKind.TIMESTAMP, TypeKind.TIMESTAMP], BIGINT, _unbound_string_fn("date_diff"))


# Unit-literal date functions: parse-time signatures; the bind-time rewrite
# (expr/binding.py) dispatches to the date_{trunc,diff,add}_<unit> kernels.
_reg.register("date_trunc", [STRINGY, TypeKind.DATE], _DATE, _unbound_string_fn("date_trunc"))
_reg.register("date_diff", [STRINGY, TypeKind.DATE, TypeKind.DATE], BIGINT, _unbound_string_fn("date_diff"))
_reg.register("date_add", [STRINGY, INT_M, TypeKind.DATE], _DATE, _unbound_string_fn("date_add"))


def _is_distinct_from(ctx, result_dtype, arg_types, a, b):
    """NULL-safe inequality (reference: prestosql IS DISTINCT FROM special
    form): two NULLs are not distinct; NULL vs value is distinct."""
    av, avalid = a
    bv, bvalid = b
    a_null = ~avalid if avalid is not None else ctx._zeros(torch.bool)
    b_null = ~bvalid if bvalid is not None else ctx._zeros(torch.bool)
    differ = av != bv
    out = torch.where(a_null & b_null, False, torch.where(a_null ^ b_null, True, differ))
    return out, None  # never NULL


_reg.register(
    "is_distinct_from", [ANY, ANY], BOOLEAN, _is_distinct_from,
    null_aware=True, coerce_common_numeric=True,
)


# digest / codec families (bind-time dictionary rewrites)
for _dname in ("md5", "sha1", "sha256", "sha512", "to_hex", "from_hex",
               "to_base64", "from_base64"):
    _reg.register(_dname, [STRINGY], _VARCHAR, _unbound_string_fn(_dname))
_reg.register(
    "hamming_distance", [STRINGY, STRINGY], BIGINT,
    _unbound_string_fn("hamming_distance"),
)


# zero-argument constants (reference: MathematicalConstants.h)
def _const_impl(value):
    def impl(ctx, result_dtype, arg_types):
        return torch.full((ctx.capacity,), value, dtype=torch.float64, device=ctx.device)

    return impl


_reg.register("e", [], DOUBLE, _const_impl(2.718281828459045))
_reg.register("pi", [], DOUBLE, _const_impl(3.141592653589793))
_reg.register("infinity", [], DOUBLE, _const_impl(float("inf")))
_reg.register("nan", [], DOUBLE, _const_impl(float("nan")))


def _width_bucket(ctx, result_dtype, arg_types, x, lo, hi, n):
    """width_bucket(x, bound1, bound2, n) (reference: WidthBucketArray.cpp's
    scalar sibling): 0 below, n+1 above, else 1-based equal-width bucket."""

    def f64(v, t):
        out = v.to(torch.float64)
        if t.kind == TypeKind.DECIMAL and t.scale:
            out = out / (10.0 ** t.scale)
        return out

    xf = f64(x, arg_types[0])
    lof = f64(lo, arg_types[1])
    hif = f64(hi, arg_types[2])
    nn = n.to(torch.int64)
    width = (hif - lof) / torch.clamp(nn.to(torch.float64), min=1.0)
    raw = torch.floor((xf - lof) / torch.where(width == 0, 1.0, width)).to(torch.int64) + 1
    out = torch.minimum(torch.maximum(raw, torch.zeros_like(raw)), nn + 1)
    errors = (nn <= 0) | (hif == lof)
    return out, errors


_reg.register(
    "width_bucket", [NUMERIC, NUMERIC, NUMERIC, INT_M], BIGINT, _width_bucket
)


# JSON / URL (bind-time dictionary rewrites; signatures for type resolution)
for _jname in ("json_extract_scalar", "json_extract"):
    _reg.register(_jname, [STRINGY, STRINGY], _VARCHAR, _unbound_string_fn(_jname))
_reg.register("json_array_length", [STRINGY], BIGINT, _unbound_string_fn("json_array_length"))
_reg.register("json_size", [STRINGY, STRINGY], BIGINT, _unbound_string_fn("json_size"))
for _uname in (
    "url_extract_host", "url_extract_path", "url_extract_query",
    "url_extract_protocol", "url_extract_fragment", "url_encode",
    "url_decode", "json_parse", "json_format", "to_base64url",
    "from_base64url", "to_utf8", "from_utf8", "char2hexint",
):
    _reg.register(_uname, [STRINGY], _VARCHAR, _unbound_string_fn(_uname))
_reg.register(
    "url_extract_port", [STRINGY], BIGINT, _unbound_string_fn("url_extract_port")
)
_reg.register(
    "url_extract_parameter", [STRINGY, STRINGY], _VARCHAR,
    _unbound_string_fn("url_extract_parameter"),
)
for _nname in ([STRINGY], [STRINGY, STRINGY]):
    _reg.register("normalize", _nname, _VARCHAR, _unbound_string_fn("normalize"))
    _reg.register("word_stem", _nname, _VARCHAR, _unbound_string_fn("word_stem"))
_reg.register(
    "strrpos", [STRINGY, STRINGY], BIGINT, _unbound_string_fn("strrpos")
)
_reg.register(
    "levenshtein_distance", [STRINGY, STRINGY], BIGINT,
    _unbound_string_fn("levenshtein_distance"),
)
_reg.register(
    "concat_ws", [STRINGY, STRINGY], _VARCHAR,
    _unbound_string_fn("concat_ws"), variadic=True,
)


def register_all() -> None:
    """Import-time registration happened above; kept for explicit call sites."""
