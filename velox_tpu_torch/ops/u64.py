"""uint64 arithmetic on int64 lanes.

torch has no full uint64 arithmetic, and the hashes of the engine (splitmix64,
folly's twang_mix64, Spark's XXH64 and Murmur3, HyperLogLog's register hash)
are written on uint64 in the JAX package.  On int64 lanes, addition,
multiplication and left shifts wrap to the same low 64 bits; a constant at or
above 2^63 is given as the int64 with the same bits (``signed64``), and a
right shift is made logical by a mask (``srl64``; torch's ``>>`` on int64 is
arithmetic).
"""

from __future__ import annotations

import torch

GOLDEN_GAMMA = 0x9E3779B97F4A7C15  # splitmix64's increment


def signed64(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= 1 << 63 else c


def srl64(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes by ``k`` (0 < k < 64)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64_mix(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's output mix (two xor-shift-multiply rounds and a final
    xor-shift) of int64 lanes: the bits of the uint64 result."""
    z = (z ^ srl64(z, 30)) * signed64(0xBF58476D1CE4E5B9)
    z = (z ^ srl64(z, 27)) * signed64(0x94D049BB133111EB)
    return z ^ srl64(z, 31)
