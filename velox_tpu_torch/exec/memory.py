"""Memory pools, arbitration, and host / disk spilling.

Counterpart of the JAX package's ``exec/memory.py``.  Reference:
velox/common/memory/MemoryPool.h:109 (hierarchical pools with
limits/tracking), MemoryArbitrator.h:43 (reclaimers: pause -> spill ->
resume), exec/Spiller.h:26 and docs/develop/spilling.rst.

The pool tree tracks *logical* byte reservations of device-resident state
(scan tiles, join builds, aggregation carries and their merge, resident
sorted runs): the bytes of the tensors reserved.  When a reservation would
exceed a pool's limit, registered reclaimers run largest child first.  The
host data cache (``io/cache.py``) reserves its bytes on the root pool and
registers its LRU eviction as the root's reclaimer.  A reservation that
nothing reclaims raises ``MemoryPoolError``; the executor catches it where
the reference degrades (the carry to the host merge, a join build to the
Grace path), and its host-side state past ``spill_bytes_threshold`` goes to
disk through ``Spiller`` (serde pages).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..io.table import Table


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


def device_tree_bytes(tree) -> int:
    """Total bytes of every tensor in a nested tuple / list / dict of
    tensors (the device-memory accounting unit); other leaves count 0."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(device_tree_bytes(t) for t in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(device_tree_bytes(t) for t in tree)
    return 0


def table_nbytes(table: Table) -> int:
    """Bytes of a host Table's value and validity arrays."""
    total = 0
    for arr in table.columns.values():
        total += np.asarray(arr).nbytes
    for v in table.validities.values():
        total += np.asarray(v).nbytes
    return total


def no_spill() -> dict:
    """An empty spill report (the fields of ``Spiller.report``)."""
    return dict(spilled_bytes=0, spilled_rows=0, spill_files=0, spill_s=0.0)


def add_spill(total: dict, report: dict) -> None:
    """Add one spill report into another, field by field."""
    for k in total:
        total[k] += report[k]


class Spiller:
    """Spills host Tables to disk as serde pages and restores them in order.

    Reference: exec/Spiller.h + SpillState / SpillFile (the file format there
    is VectorStream pages + compression; here it is ``serde/page.py``).
    Partial-aggregate chunks are key-ordered per tile, so restore-and-merge
    keeps exactness.  ``spill_seconds`` is the time spent serializing and
    writing."""

    def __init__(self, directory: Optional[str] = None, compress: bool = True):
        self._own = directory is None
        self.directory = directory or tempfile.mkdtemp(prefix="velox_torch_spill_")
        self.compress = compress
        self.files: List[str] = []
        self.spilled_bytes = 0
        self.spilled_rows = 0
        self.spill_seconds = 0.0

    @classmethod
    def for_config(cls, config) -> "Spiller":
        """A spiller in a new temporary directory, compressing unless
        ``config.spill_compression`` is "none"."""
        return cls(compress=config.spill_compression != "none")

    def spill(self, table: Table) -> None:
        from ..serde.page import serialize_page
        from ..utils import reporter
        from ..utils.testvalue import adjust

        adjust("Spiller::spill", table)
        t0 = time.perf_counter()
        path = os.path.join(self.directory, f"spill_{len(self.files)}.page")
        buf = serialize_page(table, compress=self.compress)
        with open(path, "wb") as f:
            f.write(buf)
        self.files.append(path)
        self.spilled_bytes += len(buf)
        reporter.increment_counter(reporter.METRIC_SPILLED_BYTES, len(buf))
        self.spilled_rows += table.num_rows
        self.spill_seconds += time.perf_counter() - t0

    def report(self) -> dict:
        """What this spiller wrote (read it before ``cleanup``)."""
        return dict(
            spilled_bytes=self.spilled_bytes,
            spilled_rows=self.spilled_rows,
            spill_files=len(self.files),
            spill_s=self.spill_seconds,
        )

    def restore(self):
        from ..serde.page import deserialize_page

        for path in self.files:
            with open(path, "rb") as f:
                yield deserialize_page(f.read())

    def cleanup(self) -> None:
        for path in self.files:
            try:
                os.unlink(path)
            except OSError:
                pass
        self.files.clear()
        if self._own:
            try:
                os.rmdir(self.directory)
            except OSError:
                pass
