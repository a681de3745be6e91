"""Masked, small-group and sorted-run reductions: the grouping primitives.

Counterpart of the JAX package's ``ops/segmented.py``.

Direct modes (static, small group count):

* ``masked_reduce`` — one reduction over the live rows (ungrouped aggregation).
* ``direct_group_reduce`` — a small static group count: the reduction of every
  group in one scatter pass into ``num_groups`` slots (``index_add_`` for sums,
  ``scatter_reduce_`` for min/max).  The reference lowers this as num_groups
  masked reductions because its target had no cheap scatter; the results are
  the same.

Sort mode (group count bounded only by the tile capacity): rows arrive
key-sorted, groups are runs of equal keys, and every reduction is a scan plus
a gather or one scatter into run slots:

* ``run_boundaries`` / ``run_is_end`` — run starts and ends over rows whose
  dead rows may sit inside or between runs (the fused join probe emits such
  batches).
* ``SortedRuns`` — the run structure of one sorted tile, built once and reused
  for every accumulator: ``reduce`` (sum / min / max), ``first``,
  ``start_positions``, ``run_mask``.
* ``segmented_scan`` — inclusive scan that resets at segment starts.
* ``last_flagged`` / ``next_flagged`` — the value at the last flagged row at
  or before each row (the next one at or after it): the propagation the
  reference writes as a running maximum (``lax.cummax``), built here from a
  prefix count of the flags, one scatter and one gather.  torch's
  ``cummax`` / ``cummin`` give one row of a tensor to one block, so on a
  column of 2^24 rows they run 50x slower than these three passes.

Index tensors (``run_index``, ``end_positions``, ``start_positions``) are int64,
the dtype torch indexes with; the JAX package holds them as int32.  Gathers
clamp their indices explicitly (``jnp.take(..., mode="clip")`` there).

Not ported yet (each raises ``NotImplementedError`` by name): the bitwise ops
``band`` / ``bor``, lexicographic pairs (``reduce_pair``,
``segmented_scan_pair``), ``sparse_table`` and ``rank_in_segments``.

Reference counterpart: velox/exec/HashTable.h kArray mode for the direct
half, velox/exec/StreamingAggregation.h for the run half.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

_SCATTER = {"min": "amin", "max": "amax"}


def identity_for(op: str, dtype: torch.dtype):
    if op == "sum":
        return 0
    if op == "band":
        return -1  # all ones in two's complement
    if op == "bor":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _with_identity(values: torch.Tensor, mask: torch.Tensor, op: str) -> torch.Tensor:
    ident = identity_for(op, values.dtype)
    return torch.where(mask, values, torch.full_like(values, ident))


def masked_reduce(values: torch.Tensor, mask: torch.Tensor, op: str) -> torch.Tensor:
    v = _with_identity(values, mask, op)
    if op == "sum":
        return v.sum()
    if op == "min":
        return v.amin()
    if op == "max":
        return v.amax()
    raise NotImplementedError(f"masked_reduce op {op!r} is not ported yet")


def direct_group_reduce(
    values: torch.Tensor,
    mask: torch.Tensor,
    gids: torch.Tensor,
    num_groups: int,
    op: str,
) -> torch.Tensor:
    """[num_groups] reduction with a static, small num_groups (kArray mode).

    Dead rows contribute the op's identity; a group id outside
    [0, num_groups) contributes to no group."""
    gid = gids.to(torch.int64)
    live = mask & (gid >= 0) & (gid < num_groups)
    index = torch.where(live, gid, torch.zeros_like(gid))
    v = _with_identity(values, live, op)
    ident = identity_for(op, values.dtype)
    out = torch.full((num_groups,), ident, dtype=values.dtype, device=values.device)
    if op == "sum":
        return out.index_add_(0, index, v)
    if op in _SCATTER:
        return out.scatter_reduce_(0, index, v, _SCATTER[op], include_self=True)
    raise NotImplementedError(f"direct_group_reduce op {op!r} is not ported yet")


def direct_group_reduce_batch(
    items: Sequence[Tuple[torch.Tensor, str]],
    mask: torch.Tensor,
    gids: torch.Tensor,
    num_groups: int,
) -> List[torch.Tensor]:
    """All of a node's accumulator reductions over one (mask, gids).

    ``items``: sequence of (values [capacity], op).  Returns a list of
    [num_groups] tensors, one per item."""
    return [
        direct_group_reduce(values, mask, gids, num_groups, op)
        for values, op in items
    ]


# ---------------------------------------------------------------------------
# Sorted-run half


def _take(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """values[indices] with out-of-range indices clamped to the ends."""
    idx = indices.to(torch.int64).clamp(0, max(values.shape[0] - 1, 0))
    return values.index_select(0, idx)


def _shift_in(first, rest: torch.Tensor) -> torch.Tensor:
    """``rest`` shifted one slot right, ``first`` entering at slot 0."""
    head = torch.full((1,), first, dtype=rest.dtype, device=rest.device)
    return torch.cat([head, rest[:-1]])


def _not_ported(name: str):
    def raiser(*args, **kwargs):
        raise NotImplementedError(f"ops.segmented.{name} is not ported yet")

    raiser.__name__ = name
    return raiser


segmented_scan_pair = _not_ported("segmented_scan_pair")
sparse_table = _not_ported("sparse_table")
sparse_table_query = _not_ported("sparse_table_query")
rank_in_segments = _not_ported("rank_in_segments")


def _flagged_table(flags: torch.Tensor, values: torch.Tensor, fill):
    """(table, count): ``count[i]`` = flagged rows at or before row i;
    ``table[c]`` = the value at the c-th flagged row (1-based), ``table[0]``
    and every slot past the last flagged row = ``fill``.  Unflagged rows
    scatter into the spare last slot, which is never read."""
    n = flags.shape[0]
    count = torch.cumsum(flags, 0, dtype=torch.int64)
    slot = torch.where(flags, count, torch.full_like(count, n + 1))
    table = torch.full((n + 2,), fill, dtype=values.dtype, device=values.device)
    return table.scatter_(0, slot, values), count


def last_flagged(flags: torch.Tensor, values: torch.Tensor, fill) -> torch.Tensor:
    """Per row, ``values`` at the last row at or before it where ``flags``
    holds, ``fill`` where there is none.  Equals ``torch.cummax`` of
    ``where(flags, values, fill)`` whenever the flagged values do not
    decrease and ``fill`` is below them: each call site states why."""
    table, count = _flagged_table(flags, values, fill)
    return table.index_select(0, count)


def next_flagged(flags: torch.Tensor, values: torch.Tensor, fill) -> torch.Tensor:
    """Per row, ``values`` at the first row at or after it where ``flags``
    holds, ``fill`` where there is none (the mirror of ``last_flagged``:
    a reversed ``cummin`` when the flagged values do not decrease and
    ``fill`` is above them)."""
    table, count = _flagged_table(flags, values, fill)
    return table.index_select(0, count - flags.to(torch.int64) + 1)


def segmented_scan(values: torch.Tensor, boundary: torch.Tensor, op: str) -> torch.Tensor:
    """Inclusive scan of ``op`` that resets at rows where boundary=True.

    sum: a prefix sum minus the prefix at the segment's start (exact for
    integers: wrapping cancels; floats round as two prefix sums do).
    min / max: the segment id is non-decreasing, so the running extreme of the
    pair (segment id, value rank) is the segmented running extreme; ranks come
    from one stable sort.  That is a true running maximum, not a propagation,
    so it stays on ``torch.cummax``; no path of the engine calls it."""
    n = values.shape[0]
    if n == 0:
        return values.clone()
    iota = torch.arange(n, dtype=torch.int64, device=values.device)
    if op == "sum":
        totals = torch.cumsum(values, 0)
        # positions increase, so the last boundary's position is their
        # running maximum
        start = last_flagged(boundary, iota, 0)
        before = torch.where(
            start > 0, _take(totals, start - 1), torch.zeros_like(totals)
        )
        return (totals - before).to(values.dtype)
    if op not in _SCATTER:
        raise NotImplementedError(f"segmented_scan op {op!r} is not ported yet")
    seg = torch.cumsum(boundary, 0)
    order = torch.argsort(values, stable=True)
    rank = torch.empty_like(order)
    rank[order] = iota
    if op == "min":
        rank = (n - 1) - rank
    bits = max(1, int(n - 1).bit_length())
    best = torch.cummax((seg << bits) | rank, 0).values & ((1 << bits) - 1)
    if op == "min":
        best = (n - 1) - best
    return values.index_select(0, order.index_select(0, best))


def run_boundaries(diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Run starts over key-sorted rows with dead rows possibly INTERLEAVED
    (merged-order join output, exec/joins.py): the first LIVE row at/after each
    key change starts a run — a dead row carrying the key change must not
    swallow the boundary.

    ``diff``: raw key-change marker per row (ignoring liveness); ``mask``:
    live rows."""
    n = diff.shape[0]
    if n == 0:
        return mask.clone()
    head = diff.clone()
    head[0] = True
    region = torch.cumsum(head, 0)
    # region ids never decrease, so the last live row's region is the
    # running maximum of the live rows' regions
    prev_live_region = _shift_in(0, last_flagged(mask, region, 0))
    return mask & (prev_live_region != region)


def run_is_end(
    boundary: torch.Tensor,
    mask: torch.Tensor,
    run_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A run's END is its LAST LIVE row.  Dead rows may sit INSIDE or BETWEEN
    runs, so "the next row is dead or a new run" does NOT mark an end —
    instead a live row ends its run iff no LATER live row shares its run id
    (one reversed scan)."""
    cap = boundary.shape[0]
    if cap == 0:
        return mask.clone()
    if run_index is None:
        run_index = torch.cumsum(boundary, 0) - 1
    big = cap + 1
    # run ids never decrease, so the least run id of the later live rows is
    # the id of the next live row: the first live row at or after i + 1
    at_or_after = next_flagged(mask, run_index, big)
    next_live_rid = torch.cat(
        [at_or_after[1:], torch.full((1,), big, dtype=run_index.dtype, device=run_index.device)]
    )
    return mask & (next_live_rid != run_index)


class SortedRuns:
    """Run structure of a key-sorted tile; built once, reused per column.

    ``end_positions`` is a [capacity] int64 tensor whose first ``num_runs``
    entries are the row indices of each run's last element, in run order —
    produced by a stable argsort of the run-end mask (compaction-by-sort, the
    reference's algorithm; no host read of the run count is needed)."""

    def __init__(
        self,
        boundary: torch.Tensor,
        mask: torch.Tensor,
        end_positions: Optional[torch.Tensor] = None,
    ):
        self.capacity = boundary.shape[0]
        self.boundary = boundary  # True at first row of each run (live rows only)
        self.mask = mask
        self.run_index = torch.cumsum(boundary, 0) - 1  # run id per row
        self.is_end = run_is_end(boundary, mask, self.run_index)
        if end_positions is None:
            end_positions = torch.argsort(
                (~self.is_end).to(torch.uint8), stable=True
            )
        self.end_positions = end_positions
        self.num_runs = self.is_end.sum().to(torch.int32)
        self._start_of_row: Optional[torch.Tensor] = None  # see first()

    def reduce(self, values: torch.Tensor, value_mask: torch.Tensor, op: str) -> torch.Tensor:
        """[capacity] tensor: slot r = reduction of run r (slots >= num_runs
        are garbage; mask with run_mask()).

        sum is a prefix sum and a difference at the run ends: exact for int64
        (wrapping cancels), rounded like two prefix sums for float64."""
        v = _with_identity(values, value_mask & self.mask, op)
        if op == "sum":
            totals = torch.cumsum(v, 0)
            at_ends = _take(totals, self.end_positions)
            return at_ends - _shift_in(0, at_ends)
        if op in _SCATTER:
            # one scatter into run slots; dead rows carry the identity, so
            # clamping their run id (-1 before the first run) is harmless
            gid = self.run_index.clamp(0, max(self.capacity - 1, 0))
            out = torch.full_like(v, identity_for(op, v.dtype))
            return out.scatter_reduce_(0, gid, v, _SCATTER[op], include_self=True)
        raise NotImplementedError(f"SortedRuns.reduce op {op!r} is not ported yet")

    reduce_pair = _not_ported("SortedRuns.reduce_pair")

    def start_positions(self) -> torch.Tensor:
        """[capacity] int64: slot r = row index of run r's first element (a
        boundary row — always live by construction)."""
        return torch.argsort((~self.boundary).to(torch.uint8), stable=True)

    def first(self, values: torch.Tensor) -> torch.Tensor:
        """Value at each run's first row (e.g. the key itself): slot r = run r.

        The last boundary's position at or before each row (kept for the next
        column) + two gathers.  Dead rows interleaved with a run inherit the
        last boundary's index, so merged-order join output is handled."""
        if self.capacity == 0:
            return values.clone()
        if self._start_of_row is None:
            iota = torch.arange(self.capacity, dtype=torch.int64, device=values.device)
            # positions increase: the last boundary is the running maximum
            self._start_of_row = last_flagged(self.boundary, iota, 0)
        return _take(_take(values, self._start_of_row), self.end_positions)

    def run_mask(self) -> torch.Tensor:
        return (
            torch.arange(self.capacity, dtype=torch.int32, device=self.mask.device)
            < self.num_runs
        )
