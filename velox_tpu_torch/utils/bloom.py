"""Bloom filter over 64-bit keys: host build, device-queryable.

Counterpart of the JAX package's ``utils/bloom.py``.  Reference:
velox/common/base/BloomFilter.h.  The bit array is a uint32 word vector
built on the host (``add``); a membership test is, per hash, one gather and
one bit test, on the host (``might_contain_host``) or on the keys' device
(``might_contain_device``, the splitmix64 mix on int64 lanes: ``ops/u64.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.u64 import GOLDEN_GAMMA, signed64, splitmix64_mix

_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)


def _mix(x: np.ndarray, salt: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64) + np.uint64((salt * int(_C1)) & 0xFFFFFFFFFFFFFFFF)
        x ^= x >> np.uint64(30)
        x *= _C2
        x ^= x >> np.uint64(27)
        x *= _C3
        x ^= x >> np.uint64(31)
    return x


def _mix_device(k: torch.Tensor, salt: int) -> torch.Tensor:
    return splitmix64_mix(k + signed64(salt * GOLDEN_GAMMA))


class BloomFilter:
    """num_hashes-way bloom over a power-of-two bit array."""

    def __init__(self, capacity: int, bits_per_key: int = 8, num_hashes: int = 3):
        bits = 64
        want = max(capacity, 1) * bits_per_key
        while bits < want:
            bits *= 2
        self.num_bits = bits
        self.num_hashes = num_hashes
        self.words = np.zeros(bits // 32, dtype=np.uint32)

    def add(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys).astype(np.uint64)
        mask = np.uint64(self.num_bits - 1)
        for h in range(self.num_hashes):
            bit = _mix(keys, h + 1) & mask
            np.bitwise_or.at(
                self.words, (bit >> np.uint64(5)).astype(np.int64),
                (np.uint32(1) << (bit & np.uint64(31)).astype(np.uint32)),
            )

    def might_contain_host(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys).astype(np.uint64)
        mask = np.uint64(self.num_bits - 1)
        out = np.ones(len(keys), dtype=bool)
        for h in range(self.num_hashes):
            bit = _mix(keys, h + 1) & mask
            word = self.words[(bit >> np.uint64(5)).astype(np.int64)]
            out &= (word >> (bit & np.uint64(31)).astype(np.uint32)) & 1 != 0
        return out

    def might_contain_device(self, keys: torch.Tensor) -> torch.Tensor:
        """Membership test on the keys' device: gathers and bit tests only."""
        words = torch.from_numpy(self.words.astype(np.int64)).to(keys.device)
        k = keys.to(torch.int64)
        out = torch.ones(k.shape, dtype=torch.bool, device=k.device)
        for h in range(self.num_hashes):
            bit = _mix_device(k, h + 1) & (self.num_bits - 1)
            word = words[bit >> 5]
            out &= ((word >> (bit & 31)) & 1) != 0
        return out
