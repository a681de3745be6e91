"""Span-expansion primitives: rows that each own a run of pool positions.

Counterpart of the part of the JAX package's ``ops/segpool.py`` that the
expansion (N:M) join uses.  A *normalized* pool holds each row's run
contiguously, in row order, starting at 0: the run starts are the exclusive
prefix sum of the run sizes (``dense_starts``), and ``owner_rows`` maps every
pool position back to the row that owns it.

Pool positions are int64 here (torch's index dtype); the JAX package holds
them as int32.  The rest of that module (``normalize``, ``segment_reduce``,
``compact_pool``, ``sort_within_rows``) serves ARRAY / MAP columns, which are
not ported yet.
"""

from __future__ import annotations

import torch


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
