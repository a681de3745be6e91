"""Memory pools: hierarchical byte reservations of device-resident state.

Counterpart of the pool half of the JAX package's ``exec/memory.py``.
Reference: velox/common/memory/MemoryPool.h:109 (hierarchical pools with
limits/tracking) and MemoryArbitrator.h:43 (reclaimers).

The pool tree tracks *logical* byte reservations of device-resident state
(scan tiles, join builds, aggregation carries and their merge).  When a reservation would exceed a pool's
limit, registered reclaimers run largest child first.  The host data cache
(``io/cache.py``) reserves its bytes on the root pool and registers its LRU
eviction as the root's reclaimer; spilling (``Spiller``) comes with the
memory / spill slice, and until then an over-limit reservation that nothing
reclaims raises ``MemoryPoolError``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch


class MemoryPoolError(RuntimeError):
    pass


class MemoryPool:
    """Hierarchical byte-reservation pool (reference: memory::MemoryPool)."""

    def __init__(
        self,
        name: str,
        limit: Optional[int] = None,
        parent: Optional["MemoryPool"] = None,
    ):
        self.name = name
        self.limit = limit
        self.parent = parent
        self.reserved = 0
        self.peak = 0
        self.children: List["MemoryPool"] = []
        self._reclaimers: List[Callable[[int], int]] = []
        if parent is not None:
            parent.children.append(self)

    def add_child(self, name: str, limit: Optional[int] = None) -> "MemoryPool":
        return MemoryPool(name, limit, self)

    def add_reclaimer(self, fn: Callable[[int], int]) -> None:
        """fn(target_bytes) -> bytes actually released (reference: MemoryReclaimer)."""
        self._reclaimers.append(fn)

    def reserve(self, nbytes: int) -> None:
        # check limits (arbitrating if needed) along the whole chain BEFORE
        # committing any increment, so reclaimers see consistent usage
        pool = self
        while pool is not None:
            if pool.limit is not None and pool.reserved + nbytes > pool.limit:
                freed = pool._arbitrate(pool.reserved + nbytes - pool.limit)
                if pool.reserved + nbytes > pool.limit:
                    raise MemoryPoolError(
                        f"pool {pool.name}: reservation of {nbytes} bytes exceeds "
                        f"limit {pool.limit} (reserved {pool.reserved}, "
                        f"reclaimed {freed})"
                    )
            pool = pool.parent
        pool = self
        while pool is not None:
            pool.reserved += nbytes
            pool.peak = max(pool.peak, pool.reserved)
            pool = pool.parent

    def release(self, nbytes: int) -> None:
        pool = self
        while pool is not None:
            pool.reserved = max(0, pool.reserved - nbytes)
            pool = pool.parent

    def detach(self) -> None:
        """Remove this pool from its parent, releasing whatever the subtree
        still holds (reference: MemoryPool destruction releasing to parent)."""
        if self.parent is None:
            return
        try:
            self.parent.children.remove(self)
        except ValueError:
            pass
        pool = self.parent
        while pool is not None:
            pool.reserved = max(0, pool.reserved - self.reserved)
            pool = pool.parent
        self.parent = None

    def _arbitrate(self, target: int) -> int:
        """Run reclaimers bottom-up, largest child first (SharedArbitrator)."""
        freed = 0
        for child in sorted(self.children, key=lambda c: -c.reserved):
            freed += child._arbitrate(target - freed)
            if freed >= target:
                return freed
        for fn in self._reclaimers:
            freed += fn(target - freed)
            if freed >= target:
                break
        return freed

    def usage_tree(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [
            f"{pad}{self.name}: reserved={self.reserved:,} peak={self.peak:,}"
            + (f" limit={self.limit:,}" if self.limit else "")
        ]
        for c in self.children:
            lines.append(c.usage_tree(indent + 1))
        return "\n".join(lines)


# The process root pool (reference: MemoryManager singleton).
ROOT_POOL = MemoryPool("root")


def batch_bytes(batches) -> int:
    """Total bytes of every tensor in a list of Batches (the accounting unit
    of device-resident scan tiles)."""
    total = 0

    def col_bytes(c) -> int:
        n = c.data.numel() * c.data.element_size()
        if c.validity is not None:
            n += c.validity.numel() * c.validity.element_size()
        if c.base is not None:
            n += col_bytes(c.base)
        return n

    for b in batches:
        total += sum(col_bytes(c) for c in b.columns)
        if isinstance(b.selection, torch.Tensor):
            total += b.selection.numel() * b.selection.element_size()
    return total
