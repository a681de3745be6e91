"""Device-resident sort: OrderBy / TopN execute on the device, not the host.

Counterpart of the JAX package's ``exec/sort.py``.  Reference:
velox/exec/OrderBy.h:35 + SortBuffer.cpp (accumulate, sort, emit),
velox/exec/TopN.h:23 (bounded priority queue), velox/exec/Merge.h:187 +
TreeOfLosers.h (k-way merge of sorted runs).

No priority queues, no loser trees, no scatters:

* Every sort key is encoded as an **order-preserving int64 operand**
  (``sort_operand``): integers widen, DOUBLE uses the sign-flip bit trick,
  VARCHAR codes gather through the dictionary's lexicographic ranks, DESC is
  bitwise NOT, NULLs go to an extreme sentinel per ``nulls_first``.  A chain
  of stable sorts (ops/sortkey.py ``sort_operands``) then implements any
  ORDER BY clause.
* **TopN**: each tile sorts itself and keeps only its top K rows (a tile's
  K+1-th row can never be in the global top K), then one merge sorts the
  n_tiles*K survivors and the host fetches exactly K rows: bytes fetched
  scale with K, not with the input (utils/transfer.py discipline).
* **OrderBy**: tiles are concatenated on device (dead rows carry a liveness
  flag that sorts them last) and sorted at once; the host fetch of the live
  prefix arrives already ordered — the host lexsort finisher disappears.

Ties resolve by input position (every sort is stable), which is what the host
finisher's lexsort does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtypes import RowType
from ..ops.sortkey import sort_operands
from ..plan.nodes import SortKey
from ..vector.column import Batch, Column, _take_clamped

_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min


def float_to_ordered_i64(x: torch.Tensor) -> torch.Tensor:
    """Map a float column to an int64 whose ordering matches the float
    ordering; NaN maps above +inf (Presto's NaN-is-largest convention) and
    ±0.0 share one code: the sign-magnitude flip of the IEEE bits."""
    x = x.to(torch.float64)
    x = torch.where(x != x, torch.full_like(x, float("nan")), x)  # canonical NaN
    x = x + 0.0  # -0.0 -> +0.0: zeros get ONE code (they compare equal)
    b = x.contiguous().view(torch.int64)
    return b ^ ((b >> 63) & _I64_MAX)


def sort_operand(
    values: torch.Tensor,
    validity: Optional[torch.Tensor],
    key: SortKey,
    ranks: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Encode one sort key column as an order-preserving int64 operand."""
    if ranks is not None:
        table = torch.as_tensor(np.asarray(ranks, dtype=np.int32), device=values.device)
        v = _take_clamped(table, values).to(torch.int64)
    elif values.dtype.is_floating_point:
        v = float_to_ordered_i64(values)
    else:
        v = values.to(torch.int64)
    if not key.ascending:
        v = ~v  # monotone-decreasing, overflow-free (unlike negation)
    if validity is not None:
        sentinel = _I64_MIN if key.nulls_first else _I64_MAX
        v = torch.where(validity, v, torch.full_like(v, sentinel))
    return v


@dataclasses.dataclass(frozen=True)
class SortSpec:
    """Static description of an ORDER BY over a pipeline's output schema.

    ``ranks`` holds, per key, the VARCHAR dictionary's code->lexicographic-rank
    table (resolved at plan time from the column's StringTable) or None.
    """

    keys: Tuple[SortKey, ...]
    key_indices: Tuple[int, ...]  # column index per key
    ranks: Tuple[Optional[np.ndarray], ...]
    schema: RowType

    @staticmethod
    def plan(
        keys: Sequence[SortKey],
        schema: RowType,
        strings_of: Dict[str, object],
    ) -> Optional["SortSpec"]:
        """None if the sort cannot run on device: a complex-typed output
        column, a missing key, or a VARCHAR key with no resolvable dictionary
        (the host finisher covers those)."""
        if any(t.is_complex for t in schema.types):
            return None
        idx, ranks = [], []
        for k in keys:
            if k.name not in schema:
                return None
            idx.append(schema.index_of(k.name))
            if schema.type_of(k.name).is_string:
                tab = strings_of.get(k.name)
                if tab is None:
                    return None
                ranks.append(np.asarray(tab.sort_permutation(), np.int32))
            else:
                ranks.append(None)
        return SortSpec(tuple(keys), tuple(idx), tuple(ranks), schema)

    def operands(self, cols: Sequence[Column], capacity: int) -> List[torch.Tensor]:
        ops = []
        for key, i, rk in zip(self.keys, self.key_indices, self.ranks):
            values, validity = cols[i].decode(capacity)
            ops.append(sort_operand(values, validity, key, rk))
        return ops


def flatten_columns(
    cols: Sequence[Column], capacity: int
) -> Tuple[List[torch.Tensor], List[bool]]:
    """(arrays, layout): per column its data then (optionally) its validity."""
    arrays: List[torch.Tensor] = []
    layout: List[bool] = []
    for c in cols:
        fc = c.flatten(capacity)
        arrays.append(fc.data)
        layout.append(fc.validity is not None)
        if fc.validity is not None:
            arrays.append(fc.validity)
    return arrays, layout


def _sorted_permutation(dead: torch.Tensor, ops: List[torch.Tensor]) -> torch.Tensor:
    """Row order by (dead flag, ops..., input position): the stable chain's
    permutation is the position operand carried through it."""
    n = dead.shape[0]
    position = torch.arange(n, dtype=torch.int64, device=dead.device)
    return sort_operands([dead] + ops + [position], num_keys=1 + len(ops))[-1]


def tile_sorted_prefix(
    spec: SortSpec, batch: Batch, keep: Optional[int]
) -> Tuple[List[torch.Tensor], List[bool], torch.Tensor]:
    """Sort one tile by ``spec`` and keep the first ``keep`` live rows
    (None = all).  Returns (flat arrays, layout, live-count): each column's
    data (+validity) truncated to ``keep`` rows, live rows first in sort
    order.

    The per-tile half of device TopN: a tile's K+1-th row can never reach the
    global top K, so each tile forwards only K rows to the merge (the
    reference's per-thread TopN priority queue, velox/exec/TopN.cpp, as a
    sorted prefix).
    """
    cap = batch.capacity
    mask = batch.active_mask()
    perm = _sorted_permutation(~mask, spec.operands(batch.columns, cap))
    count = mask.sum().to(torch.int32)
    if keep is not None and keep < cap:
        perm = perm[:keep]
        count = count.clamp(max=keep)
    arrays, layout = flatten_columns(
        [c.gather(perm) for c in batch.columns], perm.shape[0]
    )
    return arrays, layout, count


def merge_sorted_chunks(
    spec: SortSpec,
    chunks: Sequence[Sequence[torch.Tensor]],
    counts: Sequence[torch.Tensor],
    layout: Sequence[bool],
    keep: Optional[int],
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Merge per-tile flat-array chunks into one globally sorted prefix.

    One concatenated sort replaces the reference's TreeOfLosers k-way merge
    (velox/exec/TreeOfLosers.h): dead/padding rows carry a liveness flag that
    sorts them past every live row.  Returns (flat arrays, total live count),
    truncated to ``keep`` rows if given.
    """
    n_arrays = len(layout) + sum(bool(v) for v in layout)
    cat = [torch.cat([c[k] for c in chunks]) for k in range(n_arrays)]
    dead = torch.cat(
        [
            torch.arange(chunk[0].shape[0], dtype=torch.int32, device=cnt.device) >= cnt
            for chunk, cnt in zip(chunks, counts)
        ]
    )
    total = dead.shape[0]

    # rebuild flat Column views over the concatenated arrays for the operands
    cols: List[Column] = []
    k = 0
    for dtype, has_validity in zip(spec.schema.types, layout):
        data = cat[k]
        k += 1
        validity = None
        if has_validity:
            validity = cat[k]
            k += 1
        cols.append(Column.flat(data, dtype, validity))
    perm = _sorted_permutation(dead, spec.operands(cols, total))
    live = (~dead).sum().to(torch.int32)
    if keep is not None and keep < total:
        perm = perm[:keep]
        live = live.clamp(max=keep)
    return [a.index_select(0, perm) for a in cat], live
