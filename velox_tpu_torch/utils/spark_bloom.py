"""Spark-compatible blocked bloom filter (bloom_filter_agg / might_contain).

Counterpart of the JAX package's ``utils/spark_bloom.py``.  Reference:
velox/common/base/BloomFilter.h (blocked bloom: 64-bit blocks, 4 bits set
per value from the low 24 bits of the hash, block index from bits 24+),
velox/functions/sparksql/aggregates/BloomFilterAggAggregate.cpp (capacity =
min(numBits, maxNumBits) / 16; hash = folly::hasher<int64_t> = twang_mix64),
velox/functions/sparksql/MightContain.h.

Wire format (BloomFilter::serialize): int8 version (=1) + int32 word count +
uint64 words, all little-endian.

The filter BUILDS on the device as a grouped bitwise-OR aggregation (the
``exec/sketch.py`` rewrite: no scatter), is assembled into the wire format on
the host, and PROBES on the device with one gather and a mask test a row.
The device half computes on int64 lanes: uint64 multiplication and left
shifts wrap to the same bits, and right shifts are made logical.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..ops.u64 import srl64

KVERSION = 1
DEFAULT_EXPECTED_NUM_ITEMS = 1_000_000
DEFAULT_NUM_BITS = 8_388_608
MAX_NUM_BITS = 4_096 * 1024


def num_words(num_bits: int) -> int:
    """Word count for a target bit budget (BloomFilter::reset: capacity is
    value count at ~16 bits/value; words = max(4, nextPow2(capacity) / 4))."""
    capacity = max(int(min(num_bits, MAX_NUM_BITS)) // 16, 1)
    p = 1
    while p < capacity:
        p *= 2
    return max(4, p // 4)


def twang_mix64_np(x: np.ndarray) -> np.ndarray:
    """folly::hasher<int64_t> (twang_mix64), vectorized."""
    k = np.asarray(x).astype(np.uint64)
    with np.errstate(over="ignore"):
        k = (~k) + (k << np.uint64(21))
        k = k ^ (k >> np.uint64(24))
        k = k * np.uint64(265)
        k = k ^ (k >> np.uint64(14))
        k = k * np.uint64(21)
        k = k ^ (k >> np.uint64(28))
        k = k + (k << np.uint64(31))
    return k


def twang_mix64(x: torch.Tensor) -> torch.Tensor:
    """twang_mix64 on int64 lanes: the bits of the uint64 result."""
    k = x.to(torch.int64)
    k = (~k) + (k << 21)
    k = k ^ srl64(k, 24)
    k = k * 265
    k = k ^ srl64(k, 14)
    k = k * 21
    k = k ^ srl64(k, 28)
    return k + (k << 31)


def bloom_mask(h: torch.Tensor) -> torch.Tensor:
    """4 bits from the low 24 hash bits, one 64-bit block (BloomFilter.h
    bloomMask); bit 63 comes out as the int64 sign bit."""
    one = torch.ones((), dtype=torch.int64, device=h.device)
    return (
        (one << (h & 63))
        | (one << ((h >> 6) & 63))
        | (one << ((h >> 12) & 63))
        | (one << ((h >> 18) & 63))
    )


def _mask_np(h: np.ndarray) -> np.ndarray:
    one = np.uint64(1)
    return (
        (one << (h & np.uint64(63)))
        | (one << ((h >> np.uint64(6)) & np.uint64(63)))
        | (one << ((h >> np.uint64(12)) & np.uint64(63)))
        | (one << ((h >> np.uint64(18)) & np.uint64(63)))
    )


def serialize(words: np.ndarray) -> bytes:
    words = np.asarray(words, dtype="<u8")
    return struct.pack("<bi", KVERSION, len(words)) + words.tobytes()


def deserialize(data: bytes) -> np.ndarray:
    version, n = struct.unpack_from("<bi", data, 0)
    if version != KVERSION:
        raise ValueError(f"bad bloom filter version {version}")
    return np.frombuffer(data, dtype="<u8", count=n, offset=5)


def build_host(values: np.ndarray, num_bits: int = DEFAULT_NUM_BITS) -> bytes:
    """Host-side build (oracle / small inputs)."""
    n = num_words(num_bits)
    h = twang_mix64_np(values)
    idx = ((h >> np.uint64(24)) & np.uint64(n - 1)).astype(np.int64)
    words = np.zeros(n, dtype=np.uint64)
    np.bitwise_or.at(words, idx, _mask_np(h))
    return serialize(words)


def might_contain_host(data: bytes, values: np.ndarray) -> np.ndarray:
    words = deserialize(data)
    n = len(words)
    h = twang_mix64_np(values)
    mask = _mask_np(h)
    idx = ((h >> np.uint64(24)) & np.uint64(n - 1)).astype(np.int64)
    return (words[idx] & mask) == mask


def register_bloom_device_fns() -> None:
    """Register (once) the device-side build projections used by the
    bloom_filter_agg plan rewrite (exec/sketch.py): per-row block index and
    block bitmask — the filter then builds as a grouped bitwise-OR."""
    from ..dtypes import BIGINT
    from ..expr.registry import DEFAULT_REGISTRY, NUMERIC

    if DEFAULT_REGISTRY.signatures("__bloom_word64"):
        return

    def _word(ctx, out_t, arg_ts, x, n):
        # the word count is a power of two below 2^62: the mask keeps the
        # logical shift's result non-negative
        return (twang_mix64(x) >> 24) & (n.to(torch.int64) - 1)

    def _mask(ctx, out_t, arg_ts, x):
        return bloom_mask(twang_mix64(x))

    DEFAULT_REGISTRY.register("__bloom_word64", [NUMERIC, NUMERIC], BIGINT, _word)
    DEFAULT_REGISTRY.register("__bloom_mask64", [NUMERIC], BIGINT, _mask)


_PROBE_CACHE = {}


def register_bloom_probe(data: bytes) -> str:
    """Register (once per distinct filter) a device probe function
    ``__bloom_probe_<id>(x) -> boolean`` closing over the filter words —
    the same bind-time specialization as the timezone functions
    (functions/presto/tzfuncs.register_zone_fn).  The words reach a device
    once, at the first probe there, and stay cached for every later tile.
    An EMPTY (but non-null) filter probes as constant false (MightContain.h:
    isSet() ?: false); a NULL filter never reaches here — expr/binding.py
    folds it to a NULL constant (MightContainTest.nullBloomFilter)."""
    from ..dtypes import BOOLEAN
    from ..expr.registry import DEFAULT_REGISTRY, NUMERIC

    key = data
    hit = _PROBE_CACHE.get(key)
    if hit is not None:
        return hit
    name = f"__bloom_probe_{len(_PROBE_CACHE)}"
    if data is None or len(data) == 0:
        words_np = None
    else:
        words_np = np.asarray(deserialize(data)).view(np.int64)
    on_device = {}

    def impl(ctx, out_t, arg_ts, x):
        if words_np is None:
            return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        words = on_device.get(x.device)
        if words is None:
            words = torch.from_numpy(words_np.copy()).to(x.device)
            on_device[x.device] = words
            impl.uploads += 1
        h = twang_mix64(x)
        mask = bloom_mask(h)
        idx = srl64(h, 24) & (len(words_np) - 1)
        return (words[idx] & mask) == mask

    impl.uploads = 0
    DEFAULT_REGISTRY.register(name, [NUMERIC], BOOLEAN, impl)
    _PROBE_CACHE[key] = name
    return name


def probe_uploads(name: str) -> int:
    """How many times the words of probe function ``name`` went to a device."""
    from ..expr.registry import DEFAULT_REGISTRY

    return DEFAULT_REGISTRY.signatures(name)[0].impl.uploads
