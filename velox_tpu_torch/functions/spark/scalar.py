"""Spark-semantic scalar functions.

Counterpart of the JAX package's ``functions/spark/scalar.py``, under the
same names and overloads.  Reference: velox/functions/sparksql/
(Register.cpp; Hash.cpp murmur3 / xxhash64, Arithmetic.h pmod,
DateTimeFunctions.h, Rand.h).  Device-native where the math is lane-wise
(hash, pmod, shifts, date arithmetic); the string family evaluates once per
dictionary entry on the host, as the Presto package does
(``expr/binding.py``).

Spark vs Presto semantic differences carried faithfully:

* ``pmod`` returns a non-negative remainder and NULL on a zero divisor;
* ``hash`` / ``xxhash64`` are Spark's Murmur3_x86_32 / XXH64 with seed 42,
  a multi-column call chaining each column's hash in as the next seed, so
  shuffles can interoperate with Spark partitioning (Gluten's use case);
* ``date_add(date, n)`` / ``datediff(end, start)`` take Spark's argument
  shapes beside the Presto package's ``date_add('unit', n, date)``; the
  registry picks the overload by signature.

The hashes compute on int64 lanes (``ops/u64.py``: torch has no full uint64
arithmetic).  Murmur3 works on 32-bit
words held in int64 lanes masked to 32 bits and becomes an INTEGER, with its
sign, only at the end.

``rand(seed)`` is a splitmix64 counter keyed by (seed, global row index): the
tile's ``row_offset`` plus the row's position.  The JAX package keys it by
the position within the batch alone, so its values repeat every tile.
``rand()`` fixes its seed when the package registers, drawn from
``RAND_GENERATOR``.
"""

from __future__ import annotations

import hashlib
import re
import zlib

import numpy as np
import torch

from ...dtypes import (
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    TIMESTAMP,
    VARCHAR,
    DataType,
    TypeKind,
)
from ...expr.registry import (
    ANY,
    DEFAULT_REGISTRY,
    INTEGER as INT_M,
    NUMERIC,
    STRINGY,
)

from ...ops.u64 import GOLDEN_GAMMA, signed64, splitmix64_mix, srl64

_reg = DEFAULT_REGISTRY
_M32 = 0xFFFFFFFF


def _int32_of_word(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit word held in [0, 2^32) as the INTEGER with the same bits."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


# ---------------------------------------------------------------------------
# Spark Murmur3_x86_32 (reference: velox/functions/sparksql/Hash.cpp), on
# 32-bit words in int64 lanes

_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1):
    k1 = (k1 * _C1) & _M32
    k1 = _rotl32(k1, 15)
    return (k1 * _C2) & _M32


def _mix_h1(h1, k1):
    h1 = h1 ^ k1
    h1 = _rotl32(h1, 13)
    return (h1 * 5 + 0xE6546B64) & _M32


def _fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def _murmur3_int(v32, seed):
    return _fmix(_mix_h1(seed, _mix_k1(v32)), 4)


def _murmur3_long(v64, seed):
    h1 = _mix_h1(seed, _mix_k1(v64 & _M32))
    h1 = _mix_h1(h1, _mix_k1(srl64(v64, 32)))
    return _fmix(h1, 8)


def _word32(values: torch.Tensor, kind: TypeKind) -> torch.Tensor:
    """The 32-bit word Spark hashes for a 4-byte value, in [0, 2^32)."""
    if kind == TypeKind.BOOLEAN:
        return values.to(torch.int64)
    if kind == TypeKind.REAL:
        return values.to(torch.float32).view(torch.int32).to(torch.int64) & _M32
    return values.to(torch.int32).to(torch.int64) & _M32


def _word64(values: torch.Tensor, kind: TypeKind) -> torch.Tensor:
    """The 64-bit word Spark hashes for an 8-byte value."""
    if kind == TypeKind.DOUBLE:
        return values.to(torch.float64).view(torch.int64)
    # BIGINT / TIMESTAMP / short DECIMAL hash as long
    return values.to(torch.int64)


_FOUR_BYTE = (
    TypeKind.INTEGER, TypeKind.DATE, TypeKind.SMALLINT, TypeKind.TINYINT,
    TypeKind.BOOLEAN, TypeKind.REAL,
)


def _spark_hash_one(values, dtype: DataType, seed):
    if dtype.kind in _FOUR_BYTE:
        return _murmur3_int(_word32(values, dtype.kind), seed)
    return _murmur3_long(_word64(values, dtype.kind), seed)


def _hash_chain(h, packed, arg_types):
    for (values, validity), t in zip(packed, arg_types):
        nh = _spark_hash_one(values, t, h)
        h = nh if validity is None else torch.where(validity, nh, h)
    return h


def _spark_hash(ctx, result_dtype, arg_types, *packed):
    h = torch.full((ctx.capacity,), 42, dtype=torch.int64, device=ctx.device)
    return _int32_of_word(_hash_chain(h, packed, arg_types)), None


def _hash_with_seed(ctx, result_dtype, arg_types, seed, *packed):
    sv, _ = seed
    h = (sv.to(torch.int32).to(torch.int64) & _M32).expand((ctx.capacity,))
    return _int32_of_word(_hash_chain(h, packed, arg_types[1:])), None


# ---------------------------------------------------------------------------
# Spark XXH64 (reference: velox/functions/sparksql/Hash.cpp), on int64 lanes

_P1 = signed64(0x9E3779B185EBCA87)
_P2 = signed64(0xC2B2AE3D27D4EB4F)
_P3 = signed64(0x165667B19E3779F9)
_P4 = signed64(0x85EBCA77C2B2AE63)
_P5 = signed64(0x27D4EB2F165667C5)


def _rotl64(x, r):
    return (x << r) | srl64(x, 64 - r)


def _xxh64_avalanche(h):
    h = h ^ srl64(h, 33)
    h = h * _P2
    h = h ^ srl64(h, 29)
    h = h * _P3
    return h ^ srl64(h, 32)


def _xxh64_long(v64, seed):
    h = seed + _P5 + 8
    k1 = _rotl64(v64 * _P2, 31) * _P1
    h = h ^ k1
    h = _rotl64(h, 27) * _P1 + _P4
    return _xxh64_avalanche(h)


def _xxh64_int(v32, seed):
    # Spark XxHash64Function.hashInt: the word times P1 goes into the state
    # before the rotation.  The JAX package rotates the product first, which
    # differs from Spark for every word but 0 (ROADMAP Queue 3)
    h = seed + _P5 + 4
    h = h ^ (v32 * _P1)
    h = _rotl64(h, 23) * _P2 + _P3
    return _xxh64_avalanche(h)


def _xxhash_chain(h, packed, arg_types):
    for (values, validity), t in zip(packed, arg_types):
        if t.kind in _FOUR_BYTE:
            nh = _xxh64_int(_word32(values, t.kind), h)
        else:
            nh = _xxh64_long(_word64(values, t.kind), h)
        h = nh if validity is None else torch.where(validity, nh, h)
    return h


def _spark_xxhash64(ctx, result_dtype, arg_types, *packed):
    h = torch.full((ctx.capacity,), 42, dtype=torch.int64, device=ctx.device)
    return _xxhash_chain(h, packed, arg_types), None


def _xxhash64_with_seed(ctx, result_dtype, arg_types, seed, *packed):
    sv, _ = seed
    h = sv.to(torch.int64).expand((ctx.capacity,))
    return _xxhash_chain(h, packed, arg_types[1:]), None


# ---------------------------------------------------------------------------
# arithmetic / conditional


def _pmod(ctx, result_dtype, arg_types, a, b):
    # ((a % b) + b) % b; NULL on zero divisor (Spark returns NULL, not error)
    av, avalid = a
    bv, bvalid = b
    zero = bv == 0
    safe = torch.where(zero, torch.ones_like(bv), bv)
    r = torch.remainder(torch.remainder(av, safe) + safe, safe)
    validity = ~zero
    if avalid is not None:
        validity = validity & avalid
    if bvalid is not None:
        validity = validity & bvalid
    return r, validity


def _nanvl(ctx, result_dtype, arg_types, a, b):
    av, avalid = a
    bv, bvalid = b
    take_b = torch.isnan(av.to(torch.float64))
    values = torch.where(take_b, bv, av)
    validity = None
    if avalid is not None or bvalid is not None:
        ones = torch.ones_like(take_b)
        va = avalid if avalid is not None else ones
        vb = bvalid if bvalid is not None else ones
        validity = torch.where(take_b, vb, va)
    return values, validity


def _nvl(ctx, result_dtype, arg_types, a, b):
    av, avalid = a
    bv, bvalid = b
    if avalid is None:
        return av, None
    values = torch.where(avalid, av, bv)
    validity = avalid if bvalid is None else (avalid | bvalid)
    return values, validity


# ---------------------------------------------------------------------------
# date/time (Spark argument shapes)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _date_add(ctx, result_dtype, arg_types, d, n):
    return d.to(torch.int32) + n.to(torch.int32)


def _date_sub(ctx, result_dtype, arg_types, d, n):
    return d.to(torch.int32) - n.to(torch.int32)


def _datediff(ctx, result_dtype, arg_types, end, start):
    return (end.to(torch.int64) - start.to(torch.int64)).to(torch.int32)


def _civil(days):
    """days-since-epoch -> (year, month, day) via the Howard Hinnant civil
    algorithm, branch-free."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    y = torch.where(m <= 2, y - 1, y)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


_MONTH_LENGTHS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _days_in_month(y, m):
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    lengths = torch.tensor(_MONTH_LENGTHS, dtype=torch.int64, device=m.device)
    base = lengths[torch.clamp(m - 1, 0, 11)]
    return torch.where((m == 2) & leap, torch.full_like(base, 29), base)


def _add_months(ctx, result_dtype, arg_types, d, n):
    y, m, day = _civil(d)
    months = (y * 12 + (m - 1)) + n.to(torch.int64)
    ny = _fdiv(months, 12)
    nm = months - ny * 12 + 1
    nd = torch.minimum(day, _days_in_month(ny, nm))
    return _days_from_civil(ny, nm, nd).to(torch.int32)


def _months_between(ctx, result_dtype, arg_types, a, b):
    ya, ma, da = _civil(a)
    yb, mb, db = _civil(b)
    whole = (ya * 12 + ma) - (yb * 12 + mb)
    both_last = (da == _days_in_month(ya, ma)) & (db == _days_in_month(yb, mb))
    frac = (da - db).to(torch.float64) / 31.0
    out = whole.to(torch.float64) + torch.where(both_last, torch.zeros_like(frac), frac)
    return torch.round(out, decimals=8)


def _unix_timestamp(ctx, result_dtype, arg_types, ts):
    return _fdiv(ts.to(torch.int64), 1_000_000)


def _from_unixtime_ts(ctx, result_dtype, arg_types, secs):
    return secs.to(torch.int64) * 1_000_000


def _unix_date(ctx, result_dtype, arg_types, d):
    return d.to(torch.int32)


# ---------------------------------------------------------------------------
# math


def _f64(v, t: DataType):
    """Decimal-aware float64 view (unscaled int -> real value)."""
    out = v.to(torch.float64)
    if t.kind == TypeKind.DECIMAL and t.scale:
        out = out / (10.0 ** t.scale)
    return out


def _hypot(ctx, result_dtype, arg_types, a, b):
    return torch.hypot(_f64(a, arg_types[0]), _f64(b, arg_types[1]))


def _log1p(ctx, result_dtype, arg_types, a):
    return torch.log1p(_f64(a, arg_types[0]))


def _expm1(ctx, result_dtype, arg_types, a):
    return torch.expm1(_f64(a, arg_types[0]))


def _rint(ctx, result_dtype, arg_types, a):
    return torch.round(_f64(a, arg_types[0]))  # half to even, as rint


def _shift(left: bool):
    def impl(ctx, result_dtype, arg_types, a, n):
        wide = arg_types[0].kind == TypeKind.BIGINT
        av = a.to(torch.int64 if wide else torch.int32)
        nn = n.to(av.dtype) & (63 if wide else 31)  # Spark masks the amount
        return (av << nn) if left else (av >> nn)

    return impl


# ---------------------------------------------------------------------------
# operator-name functions (Spark registers its operators as named functions so
# substrait/Gluten plans can call them by name: sparksql/RegisterArithmetic.cpp
# add/subtract/..., RegisterCompare.cpp equalto/...)


def _add(ctx, result_dtype, arg_types, a, b):
    return a + b


def _subtract(ctx, result_dtype, arg_types, a, b):
    return a - b


def _remainder(ctx, result_dtype, arg_types, a, b):
    # Spark %: NULL on a zero divisor, the sign follows the dividend
    av, avalid = a
    bv, bvalid = b
    zero = bv == 0
    safe = torch.where(zero, torch.ones_like(bv), bv)
    if av.is_floating_point():
        r = av - torch.trunc(av / safe) * safe
    else:
        q = torch.trunc(av.to(torch.float64) / safe.to(torch.float64))
        r = av - q.to(av.dtype) * safe
    validity = ~zero
    if avalid is not None:
        validity = validity & avalid
    if bvalid is not None:
        validity = validity & bvalid
    return r, validity


def _unaryminus(ctx, result_dtype, arg_types, a):
    return -a


_COMPARE = {
    "eq": torch.eq, "gt": torch.gt, "ge": torch.ge, "lt": torch.lt, "le": torch.le,
}


def _cmp(op):
    fn = _COMPARE[op]

    def impl(ctx, result_dtype, arg_types, a, b):
        return fn(a, b)

    return impl


def _equalnullsafe(ctx, result_dtype, arg_types, a, b):
    # <=> : TRUE when both NULL, FALSE when exactly one is; never NULL
    av, avalid = a
    bv, bvalid = b
    va = avalid if avalid is not None else torch.ones(av.shape, dtype=torch.bool, device=av.device)
    vb = bvalid if bvalid is not None else torch.ones(bv.shape, dtype=torch.bool, device=bv.device)
    eq = (av == bv) & va & vb
    return eq | (~va & ~vb), None


def _isnull(ctx, result_dtype, arg_types, a):
    av, avalid = a
    if avalid is None:
        return torch.zeros(av.shape, dtype=torch.bool, device=av.device), None
    return ~avalid, None


def _isnotnull(ctx, result_dtype, arg_types, a):
    av, avalid = a
    if avalid is None:
        return torch.ones(av.shape, dtype=torch.bool, device=av.device), None
    return avalid, None


# ---------------------------------------------------------------------------
# math tail (sparksql/Arithmetic.h sec/csc/cot)


def _trig_recip(which):
    def impl(ctx, result_dtype, arg_types, a):
        x = _f64(a, arg_types[0])
        if which == "sec":
            return 1.0 / torch.cos(x)
        if which == "csc":
            return 1.0 / torch.sin(x)
        return torch.cos(x) / torch.sin(x)  # cot

    return impl


# ---------------------------------------------------------------------------
# date tail (sparksql/DateTimeFunctions.h)


def _dayofmonth(ctx, result_dtype, arg_types, d):
    _, _, day = _civil(d)
    return day.to(torch.int32)


def _dayofweek(ctx, result_dtype, arg_types, d):
    # Spark: 1 = Sunday .. 7 = Saturday; 1970-01-01 was a Thursday
    return (torch.remainder(d.to(torch.int64) + 4, 7) + 1).to(torch.int32)


def _dayofyear(ctx, result_dtype, arg_types, d):
    y, _, _ = _civil(d)
    jan1 = _days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
    return (d.to(torch.int64) - jan1 + 1).to(torch.int32)


def _last_day(ctx, result_dtype, arg_types, d):
    y, m, _ = _civil(d)
    return _days_from_civil(y, m, _days_in_month(y, m)).to(torch.int32)


def _make_date(ctx, result_dtype, arg_types, y, m, d):
    yv, yvalid = y
    mv, mvalid = m
    dv, dvalid = d
    yy = yv.to(torch.int64)
    mm = mv.to(torch.int64)
    dd = dv.to(torch.int64)
    ok = (mm >= 1) & (mm <= 12) & (dd >= 1)
    safe_m = torch.clamp(mm, 1, 12)
    ok = ok & (dd <= _days_in_month(yy, safe_m))
    for v in (yvalid, mvalid, dvalid):
        if v is not None:
            ok = ok & v
    out = _days_from_civil(yy, safe_m, torch.clamp(dd, 1, 31))
    return out.to(torch.int32), ok  # NULL on invalid (non-ANSI Spark)


def _to_unix_timestamp_date(ctx, result_dtype, arg_types, d):
    return d.to(torch.int64) * 86400


# ---------------------------------------------------------------------------
# rand (sparksql/Rand.h): per-row uniform [0, 1).  Spark's rand(seed) streams
# xorshift per partition; exact stream parity is not meaningful across
# engines, so this is a splitmix64 counter keyed by (seed, global row index).

# rand() without a seed fixes its seed when the package registers, drawn
# from this generator (seeded from the operating system's entropy)
RAND_GENERATOR = torch.Generator()
RAND_GENERATOR.seed()


def rand_values(seed: int, row_index: torch.Tensor) -> torch.Tensor:
    """The splitmix64 counter of (seed, row index) as a double in [0, 1)."""
    z = splitmix64_mix(row_index * signed64(GOLDEN_GAMMA) + seed)
    return srl64(z, 11).to(torch.float64) * (1.0 / (1 << 53))


def _row_index(ctx) -> torch.Tensor:
    """Each row's global index: the tile's first row plus its position."""
    idx = torch.arange(ctx.capacity, dtype=torch.int64, device=ctx.device)
    offset = ctx.batch.row_offset
    return idx if offset is None else idx + offset


def _rand_impl(bind_seed: int):
    def impl(ctx, result_dtype, arg_types, *maybe_seed):
        if maybe_seed:
            (sv, validity), = maybe_seed
            return rand_values(sv.to(torch.int64), _row_index(ctx)), validity
        return rand_values(signed64(bind_seed), _row_index(ctx)), None

    return impl


# ---------------------------------------------------------------------------
# string tail: host-per-dictionary-entry helpers (sparksql/String.h family)


def _spark_left(v, _ci, n):
    n = int(n)
    return v[:n] if n > 0 else ""


def _overlay(v, _ci, repl, pos, length=None):
    pos = int(pos)
    ln = len(repl) if length is None else int(length)
    if pos < 1:
        pos = 1
    return v[: pos - 1] + repl + v[pos - 1 + max(ln, 0):]


def _substring_index(v, _ci, delim, count):
    count = int(count)
    if count == 0 or not delim:
        return ""
    parts = v.split(delim)
    if count > 0:
        return delim.join(parts[:count])
    return delim.join(parts[count:])


def _conv(v, _ci, from_base, to_base):
    from_base, to_base = int(from_base), int(to_base)
    if not (2 <= from_base <= 36) or not (2 <= abs(to_base) <= 36):
        return ""
    try:
        n = int(v.strip(), from_base)
    except ValueError:
        return "0"
    if n < 0 and to_base > 0:
        n &= (1 << 64) - 1  # Spark treats negatives as unsigned 64-bit
    digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    neg = n < 0
    n = abs(n)
    out = ""
    base = abs(to_base)
    while True:
        out = digits[n % base] + out
        n //= base
        if n == 0:
            break
    return ("-" + out) if neg else out


def _sha2(v, _ci, bits):
    algo = {0: "sha256", 224: "sha224", 256: "sha256",
            384: "sha384", 512: "sha512"}.get(int(bits))
    if algo is None:
        return ""
    return getattr(hashlib, algo)(v.encode("utf-8")).hexdigest()


def _levenshtein(a, _ci, b):
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


_SOUNDEX = {
    **dict.fromkeys("BFPV", "1"),
    **dict.fromkeys("CGJKQSXZ", "2"),
    **dict.fromkeys("DT", "3"),
    "L": "4",
    **dict.fromkeys("MN", "5"),
    "R": "6",
}


def _soundex(v, _ci):
    if not v or not v[0].isalpha():
        return v
    up = v.upper()
    out = [up[0]]
    prev = _SOUNDEX.get(up[0], "")
    for ch in up[1:]:
        code = _SOUNDEX.get(ch, "")
        if code and code != prev:
            out.append(code)
        if ch not in "HW":
            prev = code
    return ("".join(out) + "000")[:4]


def murmur3_bytes(data: bytes, seed: int) -> int:
    """Spark Murmur3_x86_32 over bytes (host, one dictionary entry): 4-byte
    little-endian blocks, then each tail byte as a SIGNED int block."""

    def mixk1(k1):
        k1 = (k1 * 0xCC9E2D51) & 0xFFFFFFFF
        k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
        return (k1 * 0x1B873593) & 0xFFFFFFFF

    def mixh1(h1, k1):
        h1 ^= k1
        h1 = ((h1 << 13) | (h1 >> 19)) & 0xFFFFFFFF
        return (h1 * 5 + 0xE6546B64) & 0xFFFFFFFF

    h1 = seed & 0xFFFFFFFF
    n = len(data)
    for i in range(0, n - n % 4, 4):
        h1 = mixh1(h1, mixk1(int.from_bytes(data[i : i + 4], "little")))
    for i in range(n - n % 4, n):
        b = data[i]
        if b >= 128:
            b -= 256
        h1 = mixh1(h1, mixk1(b & 0xFFFFFFFF))
    h1 ^= n
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & 0xFFFFFFFF
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & 0xFFFFFFFF
    h1 ^= h1 >> 16
    if h1 >= 1 << 31:
        h1 -= 1 << 32
    return h1


def xxh64_bytes(data: bytes, seed: int) -> int:
    """XXH64 over bytes (host, one dictionary entry)."""
    P1 = 0x9E3779B185EBCA87
    P2 = 0xC2B2AE3D27D4EB4F
    P3 = 0x165667B19E3779F9
    P4 = 0x85EBCA77C2B2AE63
    P5 = 0x27D4EB2F165667C5
    M = 0xFFFFFFFFFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def round_(acc, lane):
        return (rotl((acc + lane * P2) & M, 31) * P1) & M

    n = len(data)
    i = 0
    if n >= 32:
        v = [(seed + P1 + P2) & M, (seed + P2) & M, seed & M, (seed - P1) & M]
        while i + 32 <= n:
            for vi in range(4):
                v[vi] = round_(v[vi], int.from_bytes(data[i : i + 8], "little"))
                i += 8
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & M
        for acc in v:
            h = ((h ^ round_(0, acc)) * P1 + P4) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i + 8 <= n:
        lane = int.from_bytes(data[i : i + 8], "little")
        h = ((rotl(h ^ round_(0, lane), 27) * P1) + P4) & M
        i += 8
    if i + 4 <= n:
        lane = int.from_bytes(data[i : i + 4], "little")
        h = ((rotl(h ^ ((lane * P1) & M), 23) * P2) + P3) & M
        i += 4
    while i < n:
        h = (rotl(h ^ (data[i] * P5) & M, 11) * P1) & M
        i += 1
    h ^= h >> 33
    h = (h * P2) & M
    h ^= h >> 29
    h = (h * P3) & M
    h ^= h >> 32
    if h >= 1 << 63:
        h -= 1 << 64
    return h


def _unbound(name):
    def impl(*_a, **_k):  # pragma: no cover
        raise RuntimeError(
            f"{name}() on strings is rewritten at bind time; "
            "run it through a plan so dictionaries are available"
        )

    return impl


def _gate(name, why):
    def impl(*_a, **_k):
        raise NotImplementedError(f"{name}: {why}")

    return impl


def _string_binders():
    """The Spark string functions' dictionary binders (expr/binding.py)."""
    from ...expr import binding as _b

    def fn(result, np_dtype, pyfn, makes_strings=False):
        return _b._literal_args_fn(result, np_dtype, pyfn, makes_strings=makes_strings)

    return {
        "ascii": fn(BIGINT, np.int64, lambda v, _ci: ord(v[0]) if v else -1),
        "instr": fn(BIGINT, np.int64, lambda v, _ci, sub: v.find(sub) + 1),
        "translate": fn(
            None, None,
            lambda v, _ci, src, dst: v.translate(
                str.maketrans(src[: len(dst)], dst[: len(src)])
            ),
            makes_strings=True,
        ),
        "levenshtein": fn(BIGINT, np.int64, _levenshtein),
        "soundex": fn(None, None, _soundex, makes_strings=True),
        "crc32": fn(BIGINT, np.int64, lambda v, _ci: zlib.crc32(v.encode("utf-8"))),
        "hash": fn(INTEGER, np.int32, lambda v, _ci: murmur3_bytes(v.encode("utf-8"), 42)),
        "xxhash64": fn(BIGINT, np.int64, lambda v, _ci: xxh64_bytes(v.encode("utf-8"), 42)),
        "startswith": fn(BOOLEAN, np.bool_, lambda v, _ci, p: v.startswith(p)),
        "endswith": fn(BOOLEAN, np.bool_, lambda v, _ci, p: v.endswith(p)),
        "left": fn(None, None, _spark_left, makes_strings=True),
        "overlay": fn(None, None, _overlay, makes_strings=True),
        "substring_index": fn(None, None, _substring_index, makes_strings=True),
        "rlike": fn(BOOLEAN, np.bool_, lambda v, _ci, p: re.search(p, v) is not None),
        "get_json_object": fn(None, None, _b._json_extract, makes_strings=True),
        "conv": fn(None, None, _conv, makes_strings=True),
        "sha2": fn(None, None, _sha2, makes_strings=True),
    }


def register_all() -> None:
    """Idempotent registration into the default registry, in the JAX
    package's order."""
    if getattr(register_all, "_done", False):
        return
    register_all._done = True

    def same(ts):
        return ts[0]

    _reg.register("pmod", [NUMERIC, NUMERIC], same, _pmod,
                  null_aware=True, coerce_common_numeric=True)
    _reg.register("nanvl", [NUMERIC, NUMERIC], same, _nanvl,
                  null_aware=True, coerce_common_numeric=True)
    for nm in ("nvl", "ifnull"):
        _reg.register(nm, [ANY, ANY], same, _nvl,
                      null_aware=True, coerce_common_numeric=True)
    _reg.register("hash", [ANY], INTEGER, _spark_hash,
                  null_aware=True, variadic=True)
    _reg.register("xxhash64", [ANY], BIGINT, _spark_xxhash64,
                  null_aware=True, variadic=True)
    _reg.register("shiftleft", [INT_M, INT_M], same, _shift(True))
    _reg.register("shiftright", [INT_M, INT_M], same, _shift(False))
    _reg.register("hypot", [NUMERIC, NUMERIC], DOUBLE, _hypot)
    _reg.register("log1p", [NUMERIC], DOUBLE, _log1p)
    _reg.register("expm1", [NUMERIC], DOUBLE, _expm1)
    _reg.register("rint", [NUMERIC], DOUBLE, _rint)

    _reg.register("date_add", [TypeKind.DATE, INT_M], DATE, _date_add)
    _reg.register("date_sub", [TypeKind.DATE, INT_M], DATE, _date_sub)
    _reg.register("datediff", [TypeKind.DATE, TypeKind.DATE], INTEGER, _datediff)
    _reg.register("add_months", [TypeKind.DATE, INT_M], DATE, _add_months)
    _reg.register("months_between", [TypeKind.DATE, TypeKind.DATE], DOUBLE,
                  _months_between)
    _reg.register("unix_timestamp", [TypeKind.TIMESTAMP], BIGINT, _unix_timestamp)
    _reg.register("from_unixtime", [INT_M], TIMESTAMP, _from_unixtime_ts)
    _reg.register("unix_date", [TypeKind.DATE], INTEGER, _unix_date)

    # string family: dictionary rewrites (expr/binding.py); the signatures
    # type the call, and evaluating one unbound raises
    from ...expr import binding as _b

    _b._STRING_FN_BINDERS.update(_string_binders())
    for nm, matchers, rt in (
        ("ascii", [STRINGY], BIGINT),
        ("instr", [STRINGY, STRINGY], BIGINT),
        ("translate", [STRINGY, STRINGY, STRINGY], VARCHAR),
        ("levenshtein", [STRINGY, STRINGY], BIGINT),
        ("soundex", [STRINGY], VARCHAR),
        ("crc32", [STRINGY], BIGINT),
        ("startswith", [STRINGY, STRINGY], BOOLEAN),
        ("endswith", [STRINGY, STRINGY], BOOLEAN),
        ("left", [STRINGY, INT_M], VARCHAR),
        ("overlay", [STRINGY, STRINGY, INT_M], VARCHAR),
        ("overlay", [STRINGY, STRINGY, INT_M, INT_M], VARCHAR),
        ("substring_index", [STRINGY, STRINGY, INT_M], VARCHAR),
        ("rlike", [STRINGY, STRINGY], BOOLEAN),
        ("get_json_object", [STRINGY, STRINGY], VARCHAR),
        ("conv", [STRINGY, INT_M, INT_M], VARCHAR),
        ("sha2", [STRINGY, INT_M], VARCHAR),
    ):
        _reg.register(nm, matchers, rt, _unbound(nm))
    _reg.register("hash", [STRINGY], INTEGER, _unbound("hash"))
    _reg.register("xxhash64", [STRINGY], BIGINT, _unbound("xxhash64"))

    # operator-name functions (RegisterArithmetic.cpp / RegisterCompare.cpp)
    _reg.register("add", [NUMERIC, NUMERIC], same, _add,
                  coerce_common_numeric=True)
    _reg.register("subtract", [NUMERIC, NUMERIC], same, _subtract,
                  coerce_common_numeric=True)
    _reg.register("remainder", [NUMERIC, NUMERIC], same, _remainder,
                  null_aware=True, coerce_common_numeric=True)
    _reg.register("unaryminus", [NUMERIC], same, _unaryminus)
    for nm, op in (
        ("equalto", "eq"), ("greaterthan", "gt"),
        ("greaterthanorequal", "ge"), ("lessthan", "lt"),
        ("lessthanorequal", "le"),
    ):
        _reg.register(nm, [NUMERIC, NUMERIC], BOOLEAN, _cmp(op),
                      coerce_common_numeric=True)
    _reg.register("equalnullsafe", [NUMERIC, NUMERIC], BOOLEAN,
                  _equalnullsafe, null_aware=True,
                  coerce_common_numeric=True)
    _reg.register("isnull", [ANY], BOOLEAN, _isnull, null_aware=True)
    _reg.register("isnotnull", [ANY], BOOLEAN, _isnotnull, null_aware=True)

    # math tail
    for nm in ("sec", "csc", "cot"):
        _reg.register(nm, [NUMERIC], DOUBLE, _trig_recip(nm))

    # date tail
    _reg.register("dayofmonth", [TypeKind.DATE], INTEGER, _dayofmonth)
    _reg.register("dayofweek", [TypeKind.DATE], INTEGER, _dayofweek)
    _reg.register("dayofyear", [TypeKind.DATE], INTEGER, _dayofyear)
    _reg.register("last_day", [TypeKind.DATE], DATE, _last_day)
    _reg.register("make_date", [INT_M, INT_M, INT_M], DATE, _make_date,
                  null_aware=True)
    _reg.register("to_unix_timestamp", [TypeKind.TIMESTAMP], BIGINT,
                  _unix_timestamp)
    _reg.register("to_unix_timestamp", [TypeKind.DATE], BIGINT,
                  _to_unix_timestamp_date)

    # rand: rand() takes a seed drawn now; rand(seed) is null-aware so that
    # a literal seed is not folded into one value for every row
    bind_seed = int(torch.randint(0, (1 << 63) - 1, (), generator=RAND_GENERATOR))
    register_all.rand_seed = bind_seed
    for nm in ("rand", "random"):
        _reg.register(nm, [], DOUBLE, _rand_impl(bind_seed))
        _reg.register(nm, [INT_M], DOUBLE, _rand_impl(bind_seed), null_aware=True)

    # seeded hash variants (Hash.cpp hashWithSeed)
    _reg.register("hash_with_seed", [INT_M, ANY], INTEGER, _hash_with_seed,
                  null_aware=True, variadic=True)
    _reg.register("xxhash64_with_seed", [INT_M, ANY], BIGINT,
                  _xxhash64_with_seed, null_aware=True, variadic=True)

    # bloom-filter probe (MightContain.h): a literal filter binds to a probe
    # specialised on its words (expr/binding.py); any other form raises
    _reg.register("might_contain", [STRINGY, ANY], BOOLEAN, _gate(
        "might_contain", "the bloom filter must be a literal (X'...') or NULL"
    ))

    # bin / chr build strings from device values: the string-construction
    # rewrite (exec/strcast.py) renders them on the host; evaluating one
    # unrewritten raises
    for nm in ("bin", "chr"):
        _reg.register(nm, [INT_M], VARCHAR, _gate(
            nm, "rendered by the string-construction rewrite (exec/strcast.py)"
        ))
