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
* SortGrouping (replaces kHash): no static range — sort the tile by the key
  tuple, derive group ids from run boundaries, reduce each run
  (ops/segmented.py SortedRuns).  The reference's split-dispatch halves
  (``sort_inputs`` / ``sorted_boundary`` / ``group_from_sorted``) exist for its
  compiler and are not ported.
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
    # Synthetic null-flag key (unbounded-key fallback of sort mode): no real
    # column — its value is a bitmask of is-null flags over the named keys.
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
    """Per-tile sort + run-boundary grouping; group count is data-dependent but
    bounded by the tile capacity (static).

    ``presorted=True`` skips the sort: the input is already ordered by (at
    least) the first key — e.g. downstream of a sort-merge join — so equal key
    tuples are grouped by adjacent comparison alone.  Runs may then split a
    logical group (secondary keys interleave within a primary-key run); the
    carry merge collapses such duplicates, so the executor must always run the
    merge step in this mode (reference: exec/StreamingAggregation.h, which
    likewise relies on sorted inputs)."""

    def __init__(self, keys: Sequence[KeyInfo], presorted: bool = False):
        self.keys = list(keys)
        self.presorted = presorted

    def pack_plan(self, capacity: int):
        """PackPlan for (keys..., row-id) if every key has resolvable bounds
        and the total fits 63 bits; None -> several-key sort fallback
        (the kNormalizedKey -> kHash degradation, HashTable.cpp:1376).
        Nullable keys reserve a dedicated null code so NULL keys form one
        group (Presto GROUP BY semantics)."""
        from ..ops.sortkey import PackPlan, index_bits

        bounds = []
        for k in self.keys:
            if k.bounds is None:
                return None
            bounds.append(k.bounds)
        return PackPlan.fit(
            bounds,
            extra_bits=index_bits(capacity),
            sentinel_fields=(0,),
            null_fields=tuple(i for i, k in enumerate(self.keys) if k.nullable),
        )

    def _decode_keys(self, batch: Batch):
        """Per-key (values, validity) with synthetic null-bit keys computed
        and nullable key values canonicalized to 0 on NULL rows (so the
        several-key fallback sorts deterministic values; the packed path
        additionally maps NULL to the field's null code via ``validities``)."""
        cap = batch.capacity
        raw = {}
        for k in self.keys:
            if k.null_sources is None:
                raw[k.name] = batch.column(k.name).decode(cap)
        key_vals: List[torch.Tensor] = []
        key_valid: List[Optional[torch.Tensor]] = []
        for k in self.keys:
            if k.null_sources is not None:
                bits = torch.zeros((cap,), dtype=torch.int64, device=batch.device)
                for j, src in enumerate(k.null_sources):
                    v, val = raw.get(src) or batch.column(src).decode(cap)
                    if val is not None:
                        bits = bits | ((~val).to(torch.int64) << j)
                key_vals.append(bits)
                key_valid.append(None)
                continue
            v, val = raw[k.name]
            if k.nullable and val is not None:
                v = torch.where(val, v, torch.zeros_like(v))
                key_valid.append(val)
            else:
                key_valid.append(None)
            key_vals.append(v)
        return key_vals, key_valid

    def sort_and_group(self, batch: Batch, payload: Sequence[torch.Tensor], mask: torch.Tensor):
        """Returns (sorted key tensors, sorted payload tensors, sorted mask, runs).

        Rows are sorted with liveness as the primary key so dead rows sink to
        the end and cannot split runs of equal keys.  ``runs`` (ops/segmented
        SortedRuns) carries the run structure for the reductions.

        The reference carries payloads and the mask through its sort as extra
        operands; ``torch.sort`` sorts one tensor, so here they follow through
        the sort's permutation, one gather each.  The rows come out the same.
        """
        from ..ops.segmented import SortedRuns, run_boundaries
        from ..ops.sortkey import sort_operands

        cap = batch.capacity
        key_vals, key_valid = self._decode_keys(batch)
        if self.presorted:
            # already key-ordered (dead rows keep their key values, so runs
            # spanning dead rows stay intact); no sort at all
            sorted_keys, sorted_payload, sorted_mask = key_vals, list(payload), mask
            return sorted_keys, sorted_payload, sorted_mask, SortedRuns(
                run_boundaries(_key_change(sorted_keys, cap, mask.device), sorted_mask),
                sorted_mask,
            )
        carried = list(payload) + [mask]
        plan = self.pack_plan(cap)
        if plan is not None:
            # One packed key (ops/sortkey.py): liveness sentinel + every key +
            # the row-id ride in a single int64, so the words are unique.
            # Each temporary is freed as soon as it is spent: over a tile of
            # 2^24 rows every int64 one is 128 MiB of the query's peak.
            packed = plan.pack_with_sentinel(key_vals, ~mask, key_valid)
            packed |= torch.arange(cap, dtype=torch.int64, device=mask.device)
            dtypes = [kv.dtype for kv in key_vals]
            del key_vals, key_valid
            s, perm = torch.sort(packed, stable=True)
            del packed
            moved = [c.index_select(0, perm) for c in carried]
            del perm
            sorted_payload, sorted_mask = moved[:-1], moved[-1]
            sorted_keys = [plan.unpack(s, i).to(dt) for i, dt in enumerate(dtypes)]
            codes = s >> plan.low_bits
            del s
            # the key changed from the previous row (row 0: from the last)
            diff = torch.empty((cap,), dtype=torch.bool, device=mask.device)
            torch.ne(codes[1:], codes[:-1], out=diff[1:])
            torch.ne(codes[:1], codes[-1:], out=diff[:1])
            del codes
            runs = SortedRuns(run_boundaries(diff, sorted_mask), sorted_mask)
            return sorted_keys, sorted_payload, sorted_mask, runs
        # Several-key fallback: (liveness, keys) as sort keys, payloads carried.
        n_keys = len(key_vals)
        sorted_ops = sort_operands([~mask] + key_vals + carried, num_keys=1 + n_keys)
        sorted_keys = sorted_ops[1 : 1 + n_keys]
        sorted_payload = list(sorted_ops[1 + n_keys : -1])
        sorted_mask = sorted_ops[-1]
        diff = _key_change(sorted_keys, cap, mask.device)
        runs = SortedRuns(run_boundaries(diff, sorted_mask), sorted_mask)
        return sorted_keys, sorted_payload, sorted_mask, runs

    @staticmethod
    def group_keys(sorted_keys, runs):
        """Representative key value per run slot: the key at the run's last
        live row, since the live rows of a run hold equal keys (slots past
        the runs are garbage, as in ``SortedRuns.reduce``)."""
        return [kv.index_select(0, runs.end_positions) for kv in sorted_keys]


def _key_change(sorted_keys, n: int, device) -> torch.Tensor:
    """bool[n]: some key differs from the previous row's (row 0 compares with
    the last row; run_boundaries starts a run there regardless)."""
    diff = torch.zeros((n,), dtype=torch.bool, device=device)
    for kv in sorted_keys:
        diff = diff | (kv != torch.roll(kv, 1))
    return diff
