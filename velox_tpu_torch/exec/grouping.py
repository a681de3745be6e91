"""Group-id computation strategies: the VectorHasher / HashTable-mode analog.

Counterpart of the JAX package's ``exec/grouping.py``.  Reference:
velox/exec/VectorHasher.h:118,206 (per-key value ids; range/dictionary modes)
and velox/exec/HashTable.h:74 (adaptive kArray / kNormalizedKey / kHash modes).

The mode decision is made when the plan is compiled, from static metadata
(dictionary sizes, column bounds):

* ArrayGrouping (kArray): every key has a small static value-id range
  (dictionary-encoded strings, booleans, bounded integers); the composite id
  is a mixed-radix code and aggregation is a direct reduction into
  ``num_groups`` slots.
* SortGrouping (replaces kHash): no static range — not ported yet; it comes
  with the sort-mode grouping slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtypes import DataType, TypeKind
from ..vector.column import Batch
from ..vector.string_table import StringTable

# Array mode reduces into one slot per composite key value, so the composite
# range must stay small; larger key spaces go to sort mode.
MAX_ARRAY_GROUPS = 256


@dataclasses.dataclass
class KeyInfo:
    name: str
    dtype: DataType
    strings: Optional[StringTable]
    radix: Optional[int]  # static value-id range, None if unbounded
    # inclusive (lo, hi) value bounds in the device representation, when the
    # planner can resolve them (runner.resolve_column_bounds)
    bounds: Optional[Tuple[int, int]] = None
    # May this key column hold NULLs (runner.resolve_column_nullable)?  SQL
    # groups all NULL keys together (reference: velox/exec/VectorHasher.h
    # reserves value-id 0 for null); nullable keys get a dedicated null code.
    nullable: bool = False
    # Synthetic null-flag key of sort mode (not ported yet).
    null_sources: Optional[Tuple[str, ...]] = None


def key_info(
    name: str,
    dtype: DataType,
    strings: Optional[StringTable],
    bounds: Optional[Tuple[int, int]] = None,
    nullable: bool = False,
) -> KeyInfo:
    if dtype.kind == TypeKind.BOOLEAN:
        return KeyInfo(name, dtype, None, 2, (0, 1), nullable)
    if dtype.is_string and strings is not None:
        return KeyInfo(
            name, dtype, strings, len(strings),
            (0, max(len(strings) - 1, 0)), nullable,
        )
    if (
        bounds is not None
        and not dtype.is_string
        and not dtype.is_complex
        and dtype.numpy_dtype.kind == "i"
    ):
        # bounded integer-backed key (ints, dates, short decimals): value id
        # = value - lo, exactly the reference VectorHasher's range mode
        # (velox/exec/VectorHasher.h:118) — makes small-range int keys
        # eligible for kArray-style direct grouping
        span = int(bounds[1]) - int(bounds[0]) + 1
        if 0 < span <= MAX_ARRAY_GROUPS:
            return KeyInfo(name, dtype, strings, span, bounds, nullable)
    return KeyInfo(name, dtype, strings, None, bounds, nullable)


class ArrayGrouping:
    """Direct-indexed grouping over a static composite key range.

    Nullable keys get one extra value id (== radix) so NULL keys form a single
    dedicated group (reference: velox/exec/VectorHasher.h reserves id 0 for
    null; here null takes the id past the range)."""

    def __init__(self, keys: Sequence[KeyInfo]):
        assert all(k.radix is not None for k in keys)
        self.keys = list(keys)
        self.radixes = [k.radix + (1 if k.nullable else 0) for k in keys]
        self.num_groups = 1
        self.strides: List[int] = []
        for r in reversed(self.radixes):
            self.strides.append(self.num_groups)
            self.num_groups *= r
        self.strides.reverse()

    def group_ids(self, batch: Batch) -> torch.Tensor:
        gid = None
        for k, stride in zip(self.keys, self.strides):
            values, validity = batch.column(k.name).decode(batch.capacity)
            base = int(k.bounds[0]) if k.bounds else 0
            if base:
                values = values - base
            v = values.to(torch.int32)
            if k.nullable and validity is not None:
                v = torch.where(validity, v, torch.full_like(v, k.radix))
            term = v * stride if stride != 1 else v
            gid = term if gid is None else gid + term
        return gid

    def key_arrays(self) -> List[np.ndarray]:
        """Host-side per-key value-id column for each of the num_groups slots
        (null groups hold id == radix; see key_validities)."""
        out = []
        ids = np.arange(self.num_groups)
        for k, r, stride in zip(self.keys, self.radixes, self.strides):
            v = ((ids // stride) % r).astype(np.int64)
            if k.nullable:
                v = np.minimum(v, k.radix - 1)  # null slot: placeholder value
            base = int(k.bounds[0]) if k.bounds else 0
            if base:
                v = v + base  # range-mode id -> value (VectorHasher.h:118)
            out.append(v if base else v.astype(np.int32))
        return out

    def key_validities(self) -> List[Optional[np.ndarray]]:
        """Per-key host validity per group slot (False = the NULL group)."""
        out: List[Optional[np.ndarray]] = []
        ids = np.arange(self.num_groups)
        for k, r, stride in zip(self.keys, self.radixes, self.strides):
            if k.nullable:
                out.append(((ids // stride) % r) != k.radix)
            else:
                out.append(None)
        return out


class SortGrouping:
    """Per-tile sort + run-boundary grouping; not ported yet."""

    def __init__(self, keys: Sequence[KeyInfo], presorted: bool = False):
        raise NotImplementedError(
            "sort-mode grouping is not ported yet; it comes with the TPC-H Q13 slice"
        )
