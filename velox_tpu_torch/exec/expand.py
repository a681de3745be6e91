"""Cardinality-changing streaming operators: Unnest, GroupId, AssignUniqueId.

Counterpart of the JAX package's ``exec/expand.py``.  Reference:
velox/exec/Unnest.cpp, GroupId.cpp, AssignUniqueId.cpp.  Each is a batch
transform that returns a batch of a *different capacity* (the element pool
size for Unnest, capacity x number of sets for GroupId), which the steps
after it consume like any other tile.
"""

from __future__ import annotations

from typing import List

import torch

from ..dtypes import BIGINT
from ..expr.seg import SegValue
from ..ops.segpool import dense_starts, owner_rows
from ..plan.nodes import AssignUniqueIdNode, GroupIdNode, UnnestNode
from ..vector.column import Batch, Column, _take_clamped
from ..vector.complex import note_pool


def apply_unnest(batch: Batch, node: UnnestNode) -> Batch:
    """One row per element of the unnested columns, zipped to the longest
    (shorter ones pad with NULL); a NULL or inactive row yields no rows."""
    mask = batch.active_mask()
    segs: List[SegValue] = []
    sizes_list = []
    for name in node.unnest:
        col = batch.column(name)
        seg = SegValue.from_column(col)
        sizes = seg.sizes.to(torch.int64)
        live = mask if col.validity is None else (mask & col.validity)
        sizes_list.append(torch.where(live, sizes, torch.zeros_like(sizes)))
        segs.append(seg)
    out_sizes = sizes_list[0]
    for s in sizes_list[1:]:
        out_sizes = torch.maximum(out_sizes, s)
    out_starts = dense_starts(out_sizes)
    pool_cap = max(sum(s.pool_cap for s in segs), 1)
    total = out_starts[-1] + out_sizes[-1]
    note_pool(pool_cap, total)
    rowid = owner_rows(out_starts, pool_cap)
    pos = torch.arange(pool_cap, dtype=torch.int64, device=batch.device)
    offset = pos - _take_clamped(out_starts, rowid)

    cols: List[Column] = []
    for name in node.replicate:
        src = batch.column(name)
        if src.dtype.is_complex:
            cols.append(src.gather(rowid))
            continue
        values, validity = src.decode(batch.capacity)
        v = _take_clamped(values, rowid)
        val = None if validity is None else _take_clamped(validity, rowid)
        cols.append(Column.flat(v, src.dtype, val, src.strings))
    for seg, sizes in zip(segs, sizes_list):
        within = offset < _take_clamped(sizes, rowid)
        idx = (_take_clamped(seg.starts.to(torch.int64), rowid) + offset).clamp(
            0, seg.pool_cap - 1
        )
        for elems in seg.children:
            taken = elems.take(idx)
            validity = taken.validity
            validity = within if validity is None else (validity & within)
            if isinstance(taken.values, SegValue):
                cols.append(taken.values.to_column(validity))
            else:
                cols.append(
                    Column.flat(taken.values, elems.dtype, validity, elems.strings)
                )
    if node.ordinality_name:
        cols.append(Column.flat(offset + 1, BIGINT))
    return Batch.make(node.output_schema, cols, total, capacity=pool_cap)


def apply_groupid(batch: Batch, node: GroupIdNode) -> Batch:
    """The tile once per grouping set; keys outside a set are NULL with a
    zero value, and the BIGINT set id makes every set's rows distinct."""
    nsets = len(node.grouping_sets)
    cap = batch.capacity
    dev = batch.device
    mask = batch.active_mask()
    cols: List[Column] = []
    for name in node.output_schema.names[:-1]:  # all but group_id
        src = batch.column(name)
        values, validity = src.decode(cap)
        tiled = values.repeat(nsets)
        base_validity = validity.repeat(nsets) if validity is not None else None
        if name in node.grouping_keys and name not in node.agg_inputs:
            in_set = torch.cat(
                [
                    torch.full((cap,), name in s, dtype=torch.bool, device=dev)
                    for s in node.grouping_sets
                ]
            )
            # zero the VALUES too: the grouping after compares raw values,
            # so out-of-set keys must collapse to one constant per set (the
            # planner restores their NULL-ness from group_id afterwards)
            tiled = torch.where(in_set, tiled, torch.zeros_like(tiled))
            base_validity = (
                in_set if base_validity is None else (base_validity & in_set)
            )
        cols.append(Column.flat(tiled, src.dtype, base_validity, src.strings))
    gid = torch.arange(nsets, dtype=torch.int64, device=dev).repeat_interleave(cap)
    cols.append(Column.flat(gid, BIGINT))
    return Batch.make(
        node.output_schema,
        cols,
        cap * nsets,
        selection=mask.repeat(nsets),
        capacity=cap * nsets,
    )


def apply_assign_unique_id(batch: Batch, node: AssignUniqueIdNode) -> Batch:
    """Append ``task_unique_id << 40 | global row index`` (the tile's
    ``row_offset`` plus the row's position)."""
    offset = (
        batch.row_offset
        if batch.row_offset is not None
        else torch.zeros((), dtype=torch.int64, device=batch.device)
    )
    ids = (node.task_unique_id << 40) | (
        offset + torch.arange(batch.capacity, dtype=torch.int64, device=batch.device)
    )
    cols = list(batch.columns) + [Column.flat(ids, node.output_schema.types[-1])]
    return batch.with_columns(node.output_schema, cols)
