"""Host-RAM table cache: the AsyncDataCache analog.

Counterpart of the JAX package's ``io/cache.py``.  Reference:
velox/common/caching/AsyncDataCache.h:639 — an in-RAM cache of file data
integrated with the allocator, fronting storage.  The engine's scan path
reads whole parquet column chunks into host Tables; the cache keeps those
Tables resident keyed by (path, mtime, columns) with a byte budget and LRU
eviction, so repeated queries over the same dataset skip storage and decode
entirely (the reference's hot-read path).  Its bytes are reserved on the
root memory pool, and the root pool's reclaimer evicts them first.

The SSD tier of the reference is the parquet dataset itself here (columnar,
compressed, durable), so no separate checkpointing cache is needed.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

from .table import Table


def _table_bytes(t: Table) -> int:
    total = sum(arr.nbytes for arr in t.columns.values())
    total += sum(v.nbytes for v in t.validities.values())
    return total


class DataCache:
    """Byte-budgeted LRU of host Tables (reference: AsyncDataCache + CacheShard)."""

    def __init__(self, max_bytes: int = 4 << 30, pool=None):
        self.max_bytes = max_bytes
        self._lock = threading.RLock()
        self._entries: "collections.OrderedDict[Tuple, Table]" = (
            collections.OrderedDict()
        )
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        # files decoded from storage (a prefetch's load included; a read
        # that joins an in-flight prefetch counts as a hit, as in the JAX
        # package)
        self.loads = 0
        self._inflight: Dict[Tuple, object] = {}
        self._io_pool = None
        if pool is None:
            from ..exec.memory import ROOT_POOL

            pool = ROOT_POOL.add_child("data-cache")
        self.pool = pool

    def _key(self, path: str, columns: Optional[Sequence[str]]):
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            mtime = 0
        return (os.path.abspath(path), mtime, tuple(columns) if columns else None)

    def prefetch(
        self, path: str, columns: Optional[Sequence[str]] = None
    ) -> None:
        """Start loading ``path`` into the cache on the I/O executor and
        return immediately (reference: CachedBufferedInput prefetch — the
        async half of AsyncDataCache).  A later get_or_load for the same
        key JOINS the in-flight load instead of reading twice."""
        import concurrent.futures

        key = self._key(path, columns)
        with self._lock:
            if key in self._entries or key in self._inflight:
                return
            if self._io_pool is None:
                self._io_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="datacache-io"
                )
            # the worker loads DIRECTLY (never through get_or_load, which
            # would join its own in-flight future and deadlock)
            fut = self._io_pool.submit(
                self._load_and_insert, path, columns, key
            )
            self._inflight[key] = fut
            fut.add_done_callback(
                lambda _f, k=key: self._inflight.pop(k, None)
            )

    def get_or_load(
        self, path: str, columns: Optional[Sequence[str]] = None
    ) -> Table:
        from ..utils import reporter as _rep

        key = self._key(path, columns)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                _rep.increment_counter(_rep.METRIC_CACHE_HITS)
                return hit
            fut = self._inflight.get(key)
        if fut is not None:
            try:
                table = fut.result()
                with self._lock:
                    self.hits += 1
                    _rep.increment_counter(_rep.METRIC_CACHE_HITS)
                return table
            except Exception:
                pass  # prefetch failed: fall through to a direct load
        with self._lock:
            self.misses += 1
            _rep.increment_counter(_rep.METRIC_CACHE_MISSES)
        return self._load_and_insert(path, columns, key)

    def _load_and_insert(
        self, path: str, columns: Optional[Sequence[str]], key
    ) -> Table:
        table = Table.load_parquet(path, columns=columns)
        nbytes = _table_bytes(table)
        with self._lock:
            self.loads += 1
            if key not in self._entries and nbytes <= self.max_bytes:
                from ..exec.memory import MemoryPoolError

                try:
                    # a real reservation: arbitration (which may re-enter
                    # evict_bytes — hence the RLock) sees cache bytes and can
                    # reclaim them
                    self.pool.reserve(nbytes)
                except MemoryPoolError:
                    return table  # memory pressure: serve uncached
                self._entries[key] = table
                self._bytes += nbytes
                while self._bytes > self.max_bytes and self._entries:
                    _, evicted = self._entries.popitem(last=False)
                    freed = _table_bytes(evicted)
                    self._bytes -= freed
                    self.pool.release(freed)
        return table

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.pool.release(self._bytes)
            self._bytes = 0

    def evict_bytes(self, target: int) -> int:
        """LRU-evict at least ``target`` bytes; returns bytes freed.  This is
        the cache's MemoryReclaimer hook (reference: AsyncDataCache::shrink,
        called by the arbitrator under memory pressure)."""
        freed = 0
        with self._lock:
            while freed < target and self._entries:
                _, evicted = self._entries.popitem(last=False)
                n = _table_bytes(evicted)
                self._bytes -= n
                freed += n
            self.pool.release(freed)
        return freed

    @property
    def cached_bytes(self) -> int:
        return self._bytes


DEFAULT_CACHE = DataCache(
    max_bytes=int(os.environ.get("VELOX_TORCH_DATA_CACHE_BYTES", 4 << 30))
)

# Under memory pressure the root arbitrator shrinks the data cache first —
# the cheapest state to drop (reference: SharedArbitrator evicting cache
# before spilling operators).
from ..exec.memory import ROOT_POOL as _ROOT_POOL  # noqa: E402

_ROOT_POOL.add_reclaimer(DEFAULT_CACHE.evict_bytes)


def cached_load_parquet(
    path: str,
    columns: Optional[Sequence[str]] = None,
    ranges=None,
) -> Table:
    if ranges:
        # predicate-pruned reads bypass the whole-file cache (they decode a
        # subset of row groups; caching them under the file key would poison
        # full reads)
        return Table.load_parquet(path, columns=columns, ranges=ranges)
    return DEFAULT_CACHE.get_or_load(path, columns)
