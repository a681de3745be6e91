"""Masked and small-group reductions: the direct-mode grouping primitives.

Counterpart of the first part of the JAX package's ``ops/segmented.py``
(``identity_for`` .. ``direct_group_reduce_batch``).  The sorted-run half of
that file (scans, ``SortedRuns``) comes with sort-mode grouping.

* ``masked_reduce`` — one reduction over the live rows (ungrouped aggregation).
* ``direct_group_reduce`` — a small static group count: the reduction of every
  group in one scatter pass into ``num_groups`` slots (``index_add_`` for sums,
  ``scatter_reduce_`` for min/max).  The reference lowers this as num_groups
  masked reductions because its target had no cheap scatter; the results are
  the same.

Reference counterpart: velox/exec/HashTable.h kArray mode.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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
