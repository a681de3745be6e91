"""Element-pool primitives for ARRAY / MAP columns and span expansions.

Counterpart of the JAX package's ``ops/segpool.py``.  A complex column stores
its elements in a flat, fixed-capacity *pool* plus per-row (start, size)
spans (Arrow/Velox list layout: velox/vector/ComplexVector.h ArrayVector
offsets+sizes).  The same span form serves the expansion (N:M) join.

The central invariant is the **normalized pool**: rows' element runs are
contiguous, in row order, starting at 0 (``dense_starts``: the exclusive
prefix sum of the sizes).  Host ingestion produces normalized pools; device
row reordering (filter compaction, joins) permutes the spans without touching
the pool, so consumers call :func:`normalize` first, a gather repack that
tolerates arbitrary, even duplicated, row->span maps.  With spans at hand, a
per-row reduction is a segmented scan plus a gather at each span's end.

Pool positions are int64 here (torch's index dtype); the JAX package holds
them as int32.  Every multi-operand ``lax.sort`` of the JAX package becomes a
chain of stable ``torch.sort`` calls (``ops/sortkey.py sort_operands``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .segmented import identity_for, segmented_scan
from .sortkey import sort_operands


def _take(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """values[indices] with indices clamped into range (``mode="clip"``)."""
    idx = indices.to(torch.int64).clamp(0, max(values.shape[0] - 1, 0))
    return values.index_select(0, idx)


def dense_starts(sizes: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of ``sizes``: the normalized run starts (int64)."""
    c = torch.cumsum(sizes, 0, dtype=torch.int64)
    return torch.cat([torch.zeros((1,), dtype=torch.int64, device=c.device), c[:-1]])


def owner_rows(starts: torch.Tensor, pool_cap: int) -> torch.Tensor:
    """``rowid[p]`` for each pool position p, given *non-decreasing* row
    starts: the number of rows whose start is <= p, minus one — for a dense
    pool, the owning row.  Positions past the pool's total get the last row;
    the caller masks them.

    The count of starts at each position (a bincount, as a scatter-add so
    that no host read sizes it; starts at or past ``pool_cap`` own no
    position and land in a spare slot) and a prefix sum over it.  The JAX
    package merges start markers and positions in two sorts; the result is
    the same for every position."""
    idx = starts.to(torch.int64).clamp(0, pool_cap)
    counts = torch.zeros((pool_cap + 1,), dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return torch.cumsum(counts[:pool_cap], 0) - 1


def normalize(
    starts: torch.Tensor,
    sizes: torch.Tensor,
    pools: Tuple[torch.Tensor, ...],
    pool_cap: int,
):
    """Repack spans into a dense, row-ordered pool.

    Returns (new_starts, sizes, new_pools, rowid, emask, overflow): ``rowid[p]``
    is the owning row of new pool slot p, ``emask`` marks live slots and
    ``overflow`` (0-d bool) says the spans held more elements than
    ``pool_cap``; rows past the fit are truncated and the caller surfaces the
    flag as a row error, so this never silently corrupts."""
    sizes = sizes.to(torch.int64)
    new_starts = dense_starts(sizes)
    total = new_starts[-1] + sizes[-1]
    rowid = owner_rows(new_starts, pool_cap)
    pos = torch.arange(pool_cap, dtype=torch.int64, device=sizes.device)
    emask = pos < total
    offset = pos - _take(new_starts, rowid)
    src = _take(starts.to(torch.int64), rowid) + offset
    src = torch.where(emask, src, torch.zeros_like(src))
    new_pools = tuple(_take(p, src) for p in pools)
    return new_starts, sizes, new_pools, rowid, emask, total > pool_cap


def pool_boundaries(rowid: torch.Tensor, emask: torch.Tensor) -> torch.Tensor:
    """True at the first live slot of each row's run (normalized pools)."""
    prev = torch.cat([torch.full((1,), -1, dtype=rowid.dtype, device=rowid.device), rowid[:-1]])
    return emask & (rowid != prev)


def segment_reduce(
    values: torch.Tensor,
    starts: torch.Tensor,
    sizes: torch.Tensor,
    rowid: torch.Tensor,
    emask: torch.Tensor,
    op: str,
    init=None,
    value_mask=None,
) -> torch.Tensor:
    """Per-row reduction over a *normalized* pool -> [rows] tensor.

    Empty rows (and rows whose elements are all masked off by ``value_mask``)
    get ``init`` (default: the op identity).  sum = prefix-sum difference at
    span ends; min / max = segmented scan + a gather at each span's end."""
    ident = identity_for(op, values.dtype)
    fill = ident if init is None else init
    live = emask if value_mask is None else (emask & value_mask)
    v = torch.where(live, values, torch.full_like(values, ident))
    starts = starts.to(torch.int64)
    sizes = sizes.to(torch.int64)
    ends = (starts + sizes - 1).clamp(min=0)
    if op == "sum":
        totals = torch.cumsum(v, 0).to(v.dtype)
        at_end = _take(totals, ends)
        before = torch.where(
            starts > 0, _take(totals, starts - 1), torch.zeros_like(at_end)
        )
        out = at_end - before
    else:
        boundary = pool_boundaries(rowid, emask)
        scanned = segmented_scan(v, boundary, op)
        out = _take(scanned, ends)
    if value_mask is not None:
        nlive = segment_reduce(
            live.to(torch.int64), starts, sizes, rowid, emask, "sum"
        )
        return torch.where(nlive > 0, out, torch.full_like(out, fill))
    return torch.where(sizes > 0, out, torch.full_like(out, fill))


def segment_any(match, starts, sizes, rowid, emask) -> torch.Tensor:
    return (
        segment_reduce(
            match.to(torch.int64), starts, sizes, rowid, emask, "sum", init=0
        )
        > 0
    )


def compact_pool(
    keep: torch.Tensor,
    starts: torch.Tensor,
    sizes: torch.Tensor,
    rowid: torch.Tensor,
    emask: torch.Tensor,
    pools: Tuple[torch.Tensor, ...],
):
    """Drop pool elements where ``keep`` is False (array filter / distinct).

    Input must be normalized; output is normalized.  Returns
    (starts, sizes, pools, rowid, emask) of the compacted pool."""
    live = keep & emask
    new_sizes = segment_reduce(
        live.to(torch.int64), starts, sizes, rowid, emask, "sum", init=0
    )
    # stable partition: kept elements first, original (row, offset) order kept
    perm = torch.sort((~live).to(torch.uint8), stable=True).indices
    new_pools = tuple(p.index_select(0, perm) for p in pools)
    pool_cap = keep.shape[0]
    new_starts = dense_starts(new_sizes)
    total = new_starts[-1] + new_sizes[-1]
    new_rowid = owner_rows(new_starts, pool_cap)
    pos = torch.arange(pool_cap, dtype=torch.int64, device=keep.device)
    return new_starts, new_sizes, new_pools, new_rowid, pos < total


def sort_within_rows(
    order_key: torch.Tensor,
    rowid: torch.Tensor,
    emask: torch.Tensor,
    pools: Tuple[torch.Tensor, ...],
    descending: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Sort each row's elements by ``order_key`` (normalized pool, spans kept)."""
    if descending:
        if order_key.dtype.is_floating_point:
            order_key = -order_key
        else:
            order_key = -order_key.to(torch.int64)
    row_key = torch.where(emask, rowid, torch.full_like(rowid, 2**62))
    sorted_ops = sort_operands([row_key, order_key] + list(pools), num_keys=2)
    return tuple(sorted_ops[2:])
