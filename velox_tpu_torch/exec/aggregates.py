"""Aggregate function API: accumulator layouts + update/merge/extract phases.

Counterpart of the JAX package's ``exec/aggregates.py``.  Reference:
velox/exec/Aggregate.h:43,125-165 (accumulator state + addRawInput /
addIntermediateResults / extractValues contract) and the function package under
velox/functions/prestosql/aggregates/.

Accumulators are *columnar*: a tuple of [num_groups] tensors (struct of
arrays).  Grouped updates are reductions over a static ``num_groups``;
ungrouped aggregation is the G=1 case.  Each accumulator declares its combine
op (sum/min/max), from which raw-input updates and partial merges both derive.

Ported so far: count, sum, avg, min, max (and the bounds-proven narrow sum and
avg), each in the direct modes (``update``) and in sort mode (``run_reduce``
over a tile's sorted runs, ``merge_runs`` in the carry merge,
``host_merge_sorted`` in the host merge).  Lexicographic pairs (min_by / max_by), statistical, bitwise, collect and
sketch aggregates come with later slices; binding one raises ``KeyError`` by
name.

Exactness: decimal/integer sums accumulate in int64 (fixed-point), so tiling and
merge order cannot change results; floating inputs accumulate in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..dtypes import BIGINT, DOUBLE, DataType, TypeKind, decimal
from ..ops.segmented import (
    SortedRuns,
    direct_group_reduce,
    identity_for as _identity,
    masked_reduce,
)

_COMBINE = {
    "sum": torch.add,
    "min": torch.minimum,
    "max": torch.maximum,
}


def _grouped_reduce(arr, mask, group_ids, num_groups, op):
    if num_groups == 1:
        return masked_reduce(arr, mask, op).reshape(1)
    return direct_group_reduce(arr, mask, group_ids, num_groups, op)


@dataclasses.dataclass
class BoundAggregate:
    """One aggregate call bound to its input columns and result type.

    ``raw_inputs(values, mask)`` maps the argument columns (a tuple, empty for
    count(*)) to one tensor per accumulator; combined with per-accumulator
    reduction ops this yields raw-input updates and merges uniformly.
    """

    name: str
    result_type: DataType
    acc_dtypes: Tuple
    acc_ops: Tuple[str, ...]
    raw_inputs: Callable  # (values_tuple, mask) -> tuple of tensors, one per acc
    extract_fn: Callable  # accs (host numpy) -> (values, validity|None)
    input_index: Optional[int]  # legacy single-arg index; None=count(*)
    # Optional renormalization applied after every combine (e.g. carry the
    # low-limb overflow of wide sums into the high limb).
    post_combine: Optional[Callable] = None
    # Lexicographic accumulator pairs (min_by / max_by); none are ported yet.
    pairs: Tuple[Tuple[int, int, str], ...] = ()
    # Per-argument roles for string handling: 'value' (output as-is, keep the
    # dictionary), 'order' (needs rank order), 'order+value' (both), 'plain'.
    arg_roles: Tuple[str, ...] = ()

    def acc_init(self, num_groups: int, device=None) -> Tuple[torch.Tensor, ...]:
        return tuple(
            torch.full((num_groups,), _identity(op, dt), dtype=dt, device=device)
            for dt, op in zip(self.acc_dtypes, self.acc_ops)
        )

    def _combine_states(self, accs, news):
        """Combine two aligned accumulator tuples."""
        result = tuple(
            _COMBINE[op](a, n) for op, a, n in zip(self.acc_ops, accs, news)
        )
        return self.post_combine(result) if self.post_combine else result

    def update(self, accs, values, mask, group_ids, num_groups):
        """Add raw input rows (reference: Aggregate::addRawInput)."""
        arrays = [
            arr.to(dt)
            for arr, dt in zip(self.raw_inputs(values, mask), self.acc_dtypes)
        ]
        news = tuple(
            _grouped_reduce(arr, mask, group_ids, num_groups, op)
            for arr, op in zip(arrays, self.acc_ops)
        )
        return self._combine_states(accs, news)

    def _masked(self, arrays, mask):
        """Raw inputs cast to the accumulator dtypes, dead rows at identity."""
        out = []
        for arr, dt, op in zip(arrays, self.acc_dtypes, self.acc_ops):
            arr = arr.to(dt)
            out.append(
                torch.where(mask, arr, torch.full_like(arr, _identity(op, dt)))
            )
        return out

    def run_reduce(self, values, mask, runs: SortedRuns):
        """Per-run reductions for sort-mode grouping: tuple of [capacity]
        tensors where slot r is run r's partial accumulator."""
        arrays = self._masked(self.raw_inputs(values, mask), mask)
        return tuple(
            runs.reduce(arr, mask, op) for arr, op in zip(arrays, self.acc_ops)
        )

    def merge_runs(self, acc_arrays, valid, runs: SortedRuns):
        """Merge already-partial accumulator rows grouped into runs (device
        sorted-carry merge path)."""
        result = tuple(
            runs.reduce(arr, valid, op) for arr, op in zip(acc_arrays, self.acc_ops)
        )
        return self.post_combine(result) if self.post_combine else result

    def merge(self, a, b):
        """Combine two aligned partial states (reference: spill/bridge merges)."""
        return self._combine_states(a, b)

    def host_merge_sorted(self, acc_arrays, starts):
        """Merge group-sorted host partial rows (numpy arrays) into per-group
        accumulators; ``starts`` marks each group's first row."""
        out = []
        for arr, op in zip(acc_arrays, self.acc_ops):
            if len(starts) == 0:
                out.append(arr[:0])
            elif op == "sum":
                if self.post_combine is not None:
                    # wide-limb sums: merge in python-int space so the lo
                    # limb cannot wrap across many tiles
                    arr = arr.astype(object)
                out.append(np.add.reduceat(arr, starts))
            elif op == "min":
                out.append(np.minimum.reduceat(arr, starts))
            else:
                out.append(np.maximum.reduceat(arr, starts))
        return tuple(out)

    def extract(self, accs):
        return self.extract_fn(accs)

    @property
    def intermediate_types(self) -> Tuple[DataType, ...]:
        """Logical types of intermediate columns (for partial-agg output batches)."""
        return tuple(
            DOUBLE if dt.is_floating_point else BIGINT for dt in self.acc_dtypes
        )

    @property
    def num_args(self) -> int:
        return len(self.arg_roles)


def _sum_result_type(t: DataType) -> DataType:
    if t.kind == TypeKind.DECIMAL:
        return decimal(38 if t.is_long_decimal else 18, t.scale)
    if t.is_floating:
        return DOUBLE
    return BIGINT


def _acc_dtype(t: DataType):
    return torch.float64 if t.is_floating else torch.int64


def _ones_like(t: torch.Tensor) -> torch.Tensor:
    return torch.ones(t.shape, dtype=torch.int64, device=t.device)


# ---- exact wide (96-bit) integer sums --------------------------------------
#
# A scale-6 decimal sum over 1.5e9 rows exceeds int64; the reference uses
# software int128 (velox/type/DecimalUtil.h).  Here the accumulator is split
# into 32-bit limbs: lo accumulates v & 0xffffffff, hi accumulates v >> 32
# (arithmetic shift — exact for negatives too since v == (v>>32)*2^32 + lo).
# After every combine the lo overflow is carried into hi, keeping lo < 2^32 +
# tile_rows * 2^32 — far from wrapping.  Extraction reconstructs with python
# ints (exact arbitrary precision) on the host.


def _wide_raw_inputs(values, mask):
    v = values[0].to(torch.int64)
    return (v >> 32, v & 0xFFFFFFFF, _ones_like(v))


def _wide_normalize(accs):
    hi, lo, count = accs
    return (hi + (lo >> 32), lo & 0xFFFFFFFF, count)


def _wide_exact(hi, lo):
    return np.asarray(hi).astype(object) * (1 << 32) + np.asarray(lo).astype(object)


def _wide_sum_extract(accs):
    exact = _wide_exact(accs[0], accs[1])
    count = np.asarray(accs[2])
    int64_max = (1 << 63) - 1
    if len(exact) and max((abs(int(x)) for x in exact), default=0) > int64_max:
        values = exact.astype(np.float64)  # beyond 64 bits: lossless order, lossy tail
    else:
        values = exact.astype(np.int64)
    return values, count > 0


def narrow_int_sum(result_type: DataType, input_index=None) -> BoundAggregate:
    """Single-accumulator exact integer sum, valid when the planner proves
    |sum| < 2^62 from column bounds x capacity (runner.AggExecutor).  Same
    accumulator shape as the float sum: (value, nonnull count)."""
    return BoundAggregate(
        "sum", result_type, (torch.int64, torch.int64), ("sum", "sum"),
        lambda values, mask: (values[0].to(torch.int64), _ones_like(values[0])),
        lambda accs: (accs[0], accs[1] > 0),
        input_index, arg_roles=("plain",),
    )


def narrow_int_avg(scale: int, input_index=None) -> BoundAggregate:
    """avg over a bounds-proven integer column: (sum, count) instead of the
    wide (hi, lo, count) limbs — same gating as narrow_int_sum."""

    def extract(accs):
        total, count = np.asarray(accs[0]), np.asarray(accs[1])
        safe = np.maximum(count, 1)
        value = (total / safe).astype(np.float64) / (10.0**scale)
        return value, count > 0

    return BoundAggregate(
        "avg", DOUBLE, (torch.int64, torch.int64), ("sum", "sum"),
        lambda values, mask: (values[0].to(torch.int64), _ones_like(values[0])),
        extract, input_index, arg_roles=("plain",),
    )


def bind_aggregate(
    name: str,
    input_types: Union[None, DataType, Sequence[DataType]],
    input_index=None,
) -> BoundAggregate:
    """Bind an aggregate by name (reference: exec::Aggregate::create)."""
    name = name.lower()
    if input_types is None:
        types: Tuple[DataType, ...] = ()
    elif isinstance(input_types, DataType):
        types = (input_types,)
    else:
        types = tuple(input_types)

    if name == "count":
        return BoundAggregate(
            "count", BIGINT, (torch.int64,), ("sum",),
            lambda values, mask: (_ones_like(mask),),
            lambda accs: (accs[0], None),
            input_index,
            arg_roles=("plain",) * len(types),
        )

    if name not in AGGREGATE_NAMES:
        raise KeyError(f"no aggregate function named {name!r} (not ported yet?)")
    assert types, f"{name} requires an argument"
    t0 = types[0]
    at = _acc_dtype(t0)

    if name == "sum":
        if at == torch.float64:
            return BoundAggregate(
                "sum", _sum_result_type(t0), (at, torch.int64), ("sum", "sum"),
                lambda values, mask: (values[0], _ones_like(values[0])),
                lambda accs: (accs[0], accs[1] > 0),  # sum of zero rows is NULL
                input_index, arg_roles=("plain",),
            )
        return BoundAggregate(
            "sum", _sum_result_type(t0),
            (torch.int64, torch.int64, torch.int64), ("sum", "sum", "sum"),
            _wide_raw_inputs,
            _wide_sum_extract,
            input_index,
            post_combine=_wide_normalize,
            arg_roles=("plain",),
        )

    if name in ("min", "max"):
        return BoundAggregate(
            name, t0, (at, torch.int64), (name, "sum"),
            lambda values, mask: (values[0], _ones_like(values[0])),
            lambda accs: (accs[0], accs[1] > 0),
            input_index, arg_roles=("order+value",),
        )

    # avg
    scale = t0.scale if t0.kind == TypeKind.DECIMAL else 0

    if at == torch.float64:
        def extract(accs):
            total, count = accs
            value = total.astype(np.float64) / np.maximum(count, 1)
            return value, count > 0

        return BoundAggregate(
            "avg", DOUBLE, (at, torch.int64), ("sum", "sum"),
            lambda values, mask: (values[0], _ones_like(values[0])),
            extract, input_index, arg_roles=("plain",),
        )

    def extract_int(accs):
        exact = _wide_exact(accs[0], accs[1])
        count = np.asarray(accs[2])
        safe = np.maximum(count, 1)
        value = (exact / safe).astype(np.float64) / (10.0**scale)
        return value, count > 0

    return BoundAggregate(
        "avg", DOUBLE, (torch.int64, torch.int64, torch.int64), ("sum", "sum", "sum"),
        _wide_raw_inputs,
        extract_int, input_index,
        post_combine=_wide_normalize,
        arg_roles=("plain",),
    )


AGGREGATE_NAMES = ("count", "sum", "min", "max", "avg")
