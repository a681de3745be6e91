"""128-bit integer arithmetic over (hi, lo) int64 limb pairs.

Counterpart of the JAX package's ``ops/int128.py``.  Reference:
velox/type/HugeInt.h + DecimalUtil.h — the reference backs DECIMAL(p>18) with
a native __int128.  A hugeint value v is two int64 columns with
``v = hi * 2**64 + uint64(lo)`` — hi carries the sign, lo is the raw low
word.  The numpy twins (host side) are the JAX package's, copied.

The device functions are elementwise torch expressions registered into the
scalar function registry under ``__i128_*`` names; exec/hugeint.py lowers
long-decimal expressions onto them as a plan rewrite.  torch has no uint64
arithmetic and no 64x64 -> 128 multiply, so everything runs on int64 lanes:

* adds, subtracts, negation and multiplies wrap mod 2^64 exactly as uint64;
* an unsigned compare flips the sign bit of both sides first;
* a logical right shift masks off the bits an arithmetic shift fills;
* a 64x64 product is built from four 32x32 half-limb products, each exact in
  uint64 (its int64 bits are the same).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# numpy twins (host side; wrap-safe)


def np_from_int(values) -> Tuple[np.ndarray, np.ndarray]:
    """Python ints / int64 array -> (hi, lo) limbs."""
    if isinstance(values, np.ndarray) and values.dtype == np.int64:
        return values >> 63, values.copy()
    out_hi = np.empty(len(values), np.int64)
    out_lo = np.empty(len(values), np.int64)
    for i, v in enumerate(values):
        v = int(v)
        out_lo[i] = np.int64((v & ((1 << 64) - 1)) - (1 << 64)) if (
            v & (1 << 63)
        ) else np.int64(v & ((1 << 64) - 1))
        out_hi[i] = np.int64(v >> 64)
    return out_hi, out_lo


def np_to_int(hi: np.ndarray, lo: np.ndarray):
    """(hi, lo) limbs -> python ints (exact)."""
    return [
        (int(h) << 64) + (int(l) & ((1 << 64) - 1))
        for h, l in zip(np.asarray(hi), np.asarray(lo))
    ]


def np_add(ah, al, bh, bl):
    with np.errstate(over="ignore"):
        lo = (al.astype(np.uint64) + bl.astype(np.uint64)).astype(np.int64)
        carry = lo.astype(np.uint64) < al.astype(np.uint64)
        hi = ah + bh + carry.astype(np.int64)
    return hi, lo


def np_neg(hi, lo):
    with np.errstate(over="ignore"):
        nlo = (-lo.astype(np.uint64)).astype(np.int64)
        nhi = ~hi + (lo == 0).astype(np.int64)
    return nhi, nlo


def np_mul_i64(a, b):
    """Exact int64 x int64 -> (hi, lo) via 32-bit partial products."""
    with np.errstate(over="ignore"):
        au = a.astype(np.uint64)
        bu = b.astype(np.uint64)
        a0, a1 = au & np.uint64(_MASK32), au >> np.uint64(32)
        b0, b1 = bu & np.uint64(_MASK32), bu >> np.uint64(32)
        p00 = a0 * b0
        p01 = a0 * b1
        p10 = a1 * b0
        p11 = a1 * b1
        mid = (p00 >> np.uint64(32)) + (p01 & np.uint64(_MASK32)) + (
            p10 & np.uint64(_MASK32)
        )
        lo = ((mid & np.uint64(_MASK32)) << np.uint64(32)) | (
            p00 & np.uint64(_MASK32)
        )
        hi_u = p11 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (
            mid >> np.uint64(32)
        )
        # unsigned -> signed correction: subtract (b if a<0) and (a if b<0)
        hi = hi_u.astype(np.int64)
        hi = hi - np.where(a < 0, b, 0) - np.where(b < 0, a, 0)
    return hi, lo.astype(np.int64)


def np_mul(ah, al, bh, bl):
    """Truncated (mod 2**128) product of two limb pairs — the semantics of
    the reference's __int128 multiply (DecimalUtil.h); overflow past 128 bits
    wraps (the lowering adds explicit guards where the reference throws)."""
    vals_a = np_to_int(np.asarray(ah), np.asarray(al))
    vals_b = np_to_int(np.asarray(bh), np.asarray(bl))
    prods = [
        ((a * b) + (1 << 128)) % (1 << 129) - (1 << 128)
        if ((a * b) % (1 << 128)) >> 127
        else (a * b) % (1 << 128)
        for a, b in zip(vals_a, vals_b)
    ]
    return np_from_int(prods)


def np_div_round(a_ints, b_ints):
    """Round-half-away-from-zero integer division (python ints, exact) — the
    oracle twin of __i128_div_* (reference: DecimalUtil::divideWithRoundUp)."""
    out = []
    for a, b in zip(a_ints, b_ints):
        q, r = divmod(abs(int(a)), abs(int(b)))
        if 2 * r >= abs(int(b)):
            q += 1
        out.append(-q if (a < 0) != (b < 0) else q)
    return out


def np_lt(ah, al, bh, bl):
    return (ah < bh) | (
        (ah == bh) & (al.astype(np.uint64) < bl.astype(np.uint64))
    )


def np_eq(ah, al, bh, bl):
    return (ah == bh) & (al == bl)


def np_to_double(hi, lo):
    return hi.astype(np.float64) * 2.0**64 + lo.astype(np.uint64).astype(
        np.float64
    )


# ---------------------------------------------------------------------------
# device helpers: uint64 semantics on int64 tensors

_MIN64 = -(1 << 63)


def _ult(a, b):
    """a < b as uint64."""
    return (a ^ _MIN64) < (b ^ _MIN64)


def _ule(a, b):
    return (a ^ _MIN64) <= (b ^ _MIN64)


def _shr(x, k: int):
    """uint64 ``x >> k`` for a constant 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _lo32(x):
    return x & _MASK32


def _u64_to_double(x):
    """uint64 -> float64, rounded once (the high half times 2^32 is exact)."""
    return _shr(x, 32).to(torch.float64) * 4294967296.0 + _lo32(x).to(torch.float64)


def _umul128(a, b):
    """uint64 x uint64 -> (hi, lo) words of the exact product, from 32-bit
    half-limb products."""
    a0, a1 = _lo32(a), _shr(a, 32)
    b0, b1 = _lo32(b), _shr(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = _shr(p00, 32) + _lo32(p01) + _lo32(p10)
    lo = (_lo32(mid) << 32) | _lo32(p00)
    hi = p11 + _shr(p01, 32) + _shr(p10, 32) + _shr(mid, 32)
    return hi, lo


def _neg_pair(hi, lo):
    return ~hi + (lo == 0).to(hi.dtype), -lo


def _magnitude(hi, lo):
    """|(hi, lo)| as uint64 words, and the sign."""
    neg = hi < 0
    nhi, nlo = _neg_pair(hi, lo)
    return torch.where(neg, nhi, hi), torch.where(neg, nlo, lo), neg


def _signed(hi, lo, neg):
    nhi, nlo = _neg_pair(hi, lo)
    return torch.where(neg, nhi, hi), torch.where(neg, nlo, lo)


def _mul_parts(a, b):
    """Exact int64 x int64 -> (hi, lo): the unsigned product, corrected by
    the other factor where a factor is negative."""
    hi, lo = _umul128(a, b)
    zero = torch.zeros_like(a)
    return hi - torch.where(a < 0, b, zero) - torch.where(b < 0, a, zero), lo


def _mul_chk_hi(ah, al, bh, bl):
    """hi limb of the 128x128 product, with an error lane where the exact
    product does not fit 128 bits (reference: DecimalUtil.h
    __builtin_mul_overflow on __int128)."""
    mah, mal, na = _magnitude(ah, al)
    mbh, mbl, nb = _magnitude(bh, bl)
    p_hi, p_lo = _umul128(mal, mbl)  # Al*Bl
    c1_hi, c1_lo = _umul128(mah, mbl)  # Ah*Bl
    c2_hi, c2_lo = _umul128(mal, mbh)  # Al*Bh
    cross = c1_lo + c2_lo
    hi = p_hi + cross
    over = (
        ((mah != 0) & (mbh != 0))
        | (c1_hi != 0)
        | (c2_hi != 0)
        | _ult(cross, c1_lo)
        | _ult(hi, p_hi)
    )
    neg = na ^ nb
    top_set = hi < 0  # bit 63 of the magnitude's high word
    edge = neg & (hi == _MIN64) & (p_lo == 0)
    over = over | (top_set & ~edge)
    nhi, _ = _neg_pair(hi, p_lo)
    return torch.where(neg, nhi, hi), over


def _from_double(x, which):
    """float64 -> i128 limbs, rounded half away from zero, exactly: a
    float64's integer value is a 53-bit mantissa shifted by its exponent, so
    the limbs are built with integer shifts (reference:
    DecimalUtil::rescaleDouble; the scale factor is multiplied in by the
    lowering before this conversion)."""
    r = torch.sign(x) * torch.floor(torch.abs(x) + 0.5)
    err = ~torch.isfinite(x) | (torch.abs(r) >= 2.0**127)
    rs = torch.where(err, torch.zeros_like(r), r)
    m2, e2 = torch.frexp(torch.abs(rs))  # |rs| = m2 * 2^e2, m2 in [0.5, 1)
    m = (m2 * 2.0**53).to(torch.int64)  # exact: integer in [2^52, 2^53)
    sh = e2.to(torch.int64) - 53  # value = m << sh (sh in [-53, 74])
    shn = torch.clamp(-sh, min=0)  # |rs| integer => low shn bits of m are 0
    shp = torch.clamp(sh, 0, 127)
    m = m >> shn  # m < 2^53: an arithmetic shift is a logical one
    zero = torch.zeros_like(m)
    lo = torch.where(shp < 64, m << torch.clamp(shp, max=63), zero)
    hi = torch.where(
        shp == 0,
        zero,
        torch.where(
            shp < 64,
            m >> (64 - torch.clamp(shp, 1, 63)),
            m << torch.clamp(shp - 64, 0, 63),
        ),
    )
    hi, lo = _signed(hi, lo, rs < 0.0)
    if which == "hi":
        return hi, err
    return lo


def _div_signed(ah, al, bh, bl):
    """(q_hi, q_lo, err): the quotient rounded half away from zero, by
    shift-subtract 128/128 long division on magnitudes (128 steps of
    elementwise ops); err where b == 0 (reference:
    DecimalUtil::divideWithRoundUp)."""
    err = (bh == 0) & (bl == 0)
    bl_s = torch.where(err, torch.ones_like(bl), bl)
    bh_s = torch.where(err, torch.zeros_like(bh), bh)
    xh, xl, na = _magnitude(ah, al)
    dh, dl, nb = _magnitude(bh_s, bl_s)
    qh = ql = rh = rl = torch.zeros_like(xh)
    for _ in range(128):
        rh = (rh << 1) | _shr(rl, 63)
        rl = (rl << 1) | _shr(xh, 63)
        xh = (xh << 1) | _shr(xl, 63)
        xl = xl << 1
        ge = _ult(dh, rh) | ((rh == dh) & _ule(dl, rl))
        borrow = _ult(rl, dl).to(torch.int64)
        rh = torch.where(ge, rh - dh - borrow, rh)
        rl = torch.where(ge, rl - dl, rl)
        qh = (qh << 1) | _shr(ql, 63)
        ql = (ql << 1) | ge.to(torch.int64)
    # round half away: 2*r >= d  (r < d < 2^127, so 2r fits u128)
    r2h = (rh << 1) | _shr(rl, 63)
    r2l = rl << 1
    bump = (_ult(dh, r2h) | ((r2h == dh) & _ule(dl, r2l))).to(torch.int64)
    ql2 = ql + bump
    qh = qh + _ult(ql2, ql).to(torch.int64)
    qh, ql = _signed(qh, ql2, na ^ nb)
    return qh, ql, err


def _guard_abs_le(x, ah, al, th, tl):
    """x, with an error lane where |(ah, al)| > (th, tl)."""
    mh, ml, _ = _magnitude(ah, al)
    over = _ult(th, mh) | ((mh == th) & _ult(tl, ml))
    return x, over


# ---------------------------------------------------------------------------
# device function registration


def register_i128_functions() -> None:
    """Register the ``__i128_*`` device functions (idempotent)."""
    from ..dtypes import BIGINT, BOOLEAN, DOUBLE
    from ..expr.registry import DEFAULT_REGISTRY as reg, NUMERIC

    if reg.signatures("__i128_add_lo"):
        return

    def f(name, arity, out, fn):
        reg.register(
            name, [NUMERIC] * arity, out,
            (lambda g: lambda ctx, out_t, arg_ts, *a: g(
                *[x.to(torch.int64) for x in a]
            ))(fn),
        )

    f("__i128_add_lo", 2, BIGINT, lambda al, bl: al + bl)
    f(
        "__i128_add_hi", 4, BIGINT,
        lambda ah, al, bh, bl: ah + bh + _ult(al + bl, al).to(torch.int64),
    )
    f("__i128_neg_lo", 1, BIGINT, lambda lo: -lo)
    f("__i128_neg_hi", 2, BIGINT, lambda hi, lo: _neg_pair(hi, lo)[0])
    f(
        "__i128_lt", 4, BOOLEAN,
        lambda ah, al, bh, bl: (ah < bh) | ((ah == bh) & _ult(al, bl)),
    )
    f(
        "__i128_lte", 4, BOOLEAN,
        lambda ah, al, bh, bl: (ah < bh) | ((ah == bh) & _ule(al, bl)),
    )
    f("__i128_eq", 4, BOOLEAN, lambda ah, al, bh, bl: (ah == bh) & (al == bl))
    f(
        "__i128_to_double", 2, DOUBLE,
        lambda hi, lo: hi.to(torch.float64) * 2.0**64 + _u64_to_double(lo),
    )
    f("__i128_mul64_hi", 2, BIGINT, lambda a, b: _mul_parts(a, b)[0])
    f("__i128_mul64_lo", 2, BIGINT, lambda a, b: _mul_parts(a, b)[1])
    # 32-bit pieces + shifts for overflow-free sum accumulation and limb
    # recombination (exec/hugeint.py): a limb splits into an unsigned low
    # half (p0), an unsigned (p1u) or sign-carrying (sar32) high half
    f("__i128_p0", 1, BIGINT, _lo32)
    f("__i128_p1u", 1, BIGINT, lambda x: _shr(x, 32))
    f("__i128_sar32", 1, BIGINT, lambda x: x >> 32)
    f("__i128_sar63", 1, BIGINT, lambda x: x >> 63)
    f("__i128_shl32", 1, BIGINT, lambda x: x << 32)
    f("__i128_cast_double", 1, DOUBLE, lambda x: x.to(torch.float64))

    # (ah*2^64+al)*(bh*2^64+bl) mod 2^128: lo = wrap(al*bl) (=mul64_lo);
    # hi = mulhi_u(al,bl) + wrap(al*bh) + wrap(ah*bl).  Wrapping products
    # are sign-agnostic; only the 64x64 high word needs unsigned care.
    f(
        "__i128_mul_hi", 4, BIGINT,
        lambda ah, al, bh, bl: _umul128(al, bl)[0] + al * bh + ah * bl,
    )
    f("__i128_mul_chk_hi", 4, BIGINT, _mul_chk_hi)

    # identity on the lo limb whose second arg exists only to pull the hi
    # limb's error lane into this expression (TRY-over-long-decimal lowering)
    reg.register(
        "__i128_pair_lo", [NUMERIC, NUMERIC], BIGINT,
        lambda ctx, out_t, arg_ts, lo, hi: lo,
    )
    reg.register(
        "__i128_from_double_hi", [NUMERIC], BIGINT,
        lambda ctx, out_t, arg_ts, x: _from_double(x.to(torch.float64), "hi"),
    )
    reg.register(
        "__i128_from_double_lo", [NUMERIC], BIGINT,
        lambda ctx, out_t, arg_ts, x: _from_double(x.to(torch.float64), "lo"),
    )

    def _div_lo(*a):
        r = _div_signed(*a)
        return r[1], r[2]

    f("__i128_div_hi", 4, BIGINT, lambda *a: _div_signed(*a)[0])
    f("__i128_div_lo", 4, BIGINT, _div_lo)

    # passthrough-with-error-lane helper: the lowering attaches this to one
    # limb expression so overflow surfaces as a per-row query error (the
    # reference throws VeloxUserError on decimal overflow)
    f("__i128_guard_abs_le", 5, BIGINT, _guard_abs_le)

    # narrow a 128-bit value into int64 (err when it does not fit)
    f("__i128_narrow", 2, BIGINT, lambda hi, lo: (lo, hi != (lo >> 63)))
