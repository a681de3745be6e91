"""Aggregate function API: accumulator layouts + update/merge/extract phases.

Counterpart of the JAX package's ``exec/aggregates.py``.  Reference:
velox/exec/Aggregate.h:43,125-165 (accumulator state + addRawInput /
addIntermediateResults / extractValues contract) and the function package under
velox/functions/prestosql/aggregates/.

Accumulators are *columnar*: a tuple of [num_groups] tensors (struct of
arrays).  Grouped updates are reductions over a static ``num_groups``;
ungrouped aggregation is the G=1 case.  Each accumulator declares its combine
op (sum/min/max), from which raw-input updates and partial merges both derive.

Every aggregate of the JAX package's ``bind_aggregate`` is here, with the
Spark package's aliases (``first`` / ``last`` -> ``arbitrary``,
``collect_list`` -> ``array_agg``, ``collect_set`` -> ``set_agg``).  The
sketches ``approx_distinct`` and ``bloom_filter_agg`` bind only to give the
plan node its result type: ``exec/sketch.py`` lowers them before a plan runs,
and their update raises.  The collect aggregates (``array_agg`` and its
family, ``approx_percentile``) bind to ``exec/collect_agg.py``.
Each works in the direct modes (``update``), in sort mode (``run_reduce``
over a tile's sorted runs, ``merge_runs`` in the carry merge) and in the host
merge (``host_merge_sorted``).  min_by / max_by keep (ordering, payload)
accumulator *pairs* combined lexicographically (``pairs``), ties broken
toward the smaller payload; rows where any argument is NULL are skipped, as
in the JAX package.

Exactness: decimal/integer sums accumulate in int64 (fixed-point), so tiling and
merge order cannot change results; floating inputs accumulate in float64.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..dtypes import BIGINT, BOOLEAN, DOUBLE, DataType, TypeKind, decimal
from ..ops.segmented import (
    SortedRuns,
    direct_group_reduce,
    direct_group_reduce_pair,
    identity_for as _identity,
    masked_reduce,
    masked_reduce_pair,
    pair_wins,
)
from ..ops.u64 import GOLDEN_GAMMA, signed64, splitmix64_mix

_COMBINE = {
    "sum": torch.add,
    "min": torch.minimum,
    "max": torch.maximum,
    "band": torch.bitwise_and,
    "bor": torch.bitwise_or,
}

_HOST_REDUCEAT = {
    "min": np.minimum,
    "max": np.maximum,
    "band": np.bitwise_and,
    "bor": np.bitwise_or,
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
    ``pairs`` marks (ordering_idx, payload_idx, op) accumulator pairs that
    combine lexicographically instead of element-wise.
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
    # Lexicographic accumulator pairs: (ordering acc idx, payload acc idx, op).
    pairs: Tuple[Tuple[int, int, str], ...] = ()
    # Per-argument roles for string handling: 'value' (output as-is, keep the
    # dictionary), 'order' (needs rank order), 'order+value' (both), 'plain'.
    arg_roles: Tuple[str, ...] = ()

    def _paired_payloads(self):
        return {j for _, j, _ in self.pairs}

    def _pair_of(self, i):
        for y, x, op in self.pairs:
            if y == i:
                return (y, x, op)
        return None

    def _per_acc(self, plain, paired):
        """Apply ``plain(i, op)`` to every element-wise accumulator and
        ``paired(y, x, op)`` (returning two) to every lexicographic pair;
        returns the accumulator tuple in order."""
        out = [None] * len(self.acc_ops)
        payloads = self._paired_payloads()
        for i, op in enumerate(self.acc_ops):
            pair = self._pair_of(i)
            if pair is not None:
                y, x, pop = pair
                out[y], out[x] = paired(y, x, pop)
            elif i not in payloads:
                out[i] = plain(i, op)
        return tuple(out)

    def acc_init(self, num_groups: int, device=None) -> Tuple[torch.Tensor, ...]:
        return tuple(
            torch.full((num_groups,), _identity(op, dt), dtype=dt, device=device)
            for dt, op in zip(self.acc_dtypes, self.acc_ops)
        )

    def _combine_states(self, accs, news):
        """Combine two aligned accumulator tuples respecting pairs."""

        def paired(y, x, op):
            take = pair_wins(op, accs[y], accs[x], news[y], news[x])
            return torch.where(take, news[y], accs[y]), torch.where(take, news[x], accs[x])

        result = self._per_acc(lambda i, op: _COMBINE[op](accs[i], news[i]), paired)
        return self.post_combine(result) if self.post_combine else result

    def _masked(self, arrays, mask):
        """Raw inputs cast to the accumulator dtypes, dead rows at identity."""
        out = []
        for arr, dt, op in zip(arrays, self.acc_dtypes, self.acc_ops):
            arr = arr.to(dt)
            ident = torch.full((), _identity(op, dt), dtype=dt, device=arr.device)
            out.append(torch.where(mask, arr, ident))
        return out

    def update(self, accs, values, mask, group_ids, num_groups):
        """Add raw input rows (reference: Aggregate::addRawInput)."""
        arrays = self._masked(self.raw_inputs(values, mask), mask)

        def paired(y, x, op):
            if num_groups == 1:
                ry, rx = masked_reduce_pair(arrays[y], arrays[x], mask, op)
                return ry.reshape(1), rx.reshape(1)
            return direct_group_reduce_pair(
                arrays[y], arrays[x], mask, group_ids, num_groups, op
            )

        news = self._per_acc(
            lambda i, op: _grouped_reduce(arrays[i], mask, group_ids, num_groups, op),
            paired,
        )
        return self._combine_states(accs, news)

    def run_reduce(self, values, mask, runs: SortedRuns):
        """Per-run reductions for sort-mode grouping: tuple of [capacity]
        tensors where slot r is run r's partial accumulator."""
        arrays = self._masked(self.raw_inputs(values, mask), mask)
        return self._per_acc(
            lambda i, op: runs.reduce(arrays[i], mask, op),
            lambda y, x, op: runs.reduce_pair(arrays[y], arrays[x], mask, op),
        )

    def merge_runs(self, acc_arrays, valid, runs: SortedRuns):
        """Merge already-partial accumulator rows grouped into runs (device
        sorted-carry merge path)."""
        result = self._per_acc(
            lambda i, op: runs.reduce(acc_arrays[i], valid, op),
            lambda y, x, op: runs.reduce_pair(acc_arrays[y], acc_arrays[x], valid, op),
        )
        return self.post_combine(result) if self.post_combine else result

    def merge(self, a, b):
        """Combine two aligned partial states (reference: spill/bridge merges)."""
        return self._combine_states(a, b)

    def host_merge_sorted(self, acc_arrays, starts):
        """Merge group-sorted host partial rows (numpy arrays) into per-group
        accumulators; ``starts`` marks each group's first row."""
        n = len(acc_arrays[0])
        lengths = np.diff(np.append(starts, n))
        gids = np.repeat(np.arange(len(starts)), lengths)

        def paired(y, x, op):
            ya, xa = acc_arrays[y], acc_arrays[x]
            yk = -ya if op == "max" else ya
            perm = np.lexsort((xa, yk, gids))
            return ya[perm][starts], xa[perm][starts]

        def plain(i, op):
            arr = acc_arrays[i]
            if len(starts) == 0:
                return arr[:0]
            if op == "sum":
                if self.post_combine is not None:
                    # wide-limb sums: merge in python-int space so the lo
                    # limb cannot wrap across many tiles
                    arr = arr.astype(object)
                return np.add.reduceat(arr, starts)
            return _HOST_REDUCEAT[op].reduceat(arr, starts)

        return self._per_acc(plain, paired)

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


@dataclasses.dataclass
class MomentAggregate(BoundAggregate):
    """A statistical aggregate kept as (count, sum of each variable, central
    moments about the group's own mean) — the variance family, covariance,
    correlation, skewness and kurtosis.

    The JAX package keeps raw power sums (x, x^2, ...) and subtracts at the
    end, which cancels where a group's spread is small beside its mean (two
    line items of nearly the same price: the variance comes out with most
    of its digits lost, or not zero for equal values).  Here every merge —
    rows into a group, partial groups into a run, two states into one — is
    the exact combination of central moments (Chan et al., Pebay): with
    ``d`` the distance of a part's mean from the merged mean,

        M_e = sum over parts of  sum over f <= e  C(e, f) * M_f(part) * d^(e - f)

    (``M_0`` = the part's count, ``M_1`` = 0), two passes of segment sums:
    the merged means first, then every moment.  Real values are the
    reference's where it is accurate.

    A DECIMAL variable enters unscaled (its integer as float64; the
    extraction divides the scale out), so its sums are exact whatever order
    a device adds them in, and a group of equal values has mean equal to
    them and moments of exactly 0 (the correlation of a constant column is
    then NULL, not rounding noise).

    Accumulators: count (int64), one sum per variable, then one central
    moment per exponent tuple of ``orders`` (each tuple names one power per
    variable; every tuple of order 2 or more that a merge needs is itself in
    ``orders``).  ``raw_inputs`` returns the variables as float64."""

    orders: Tuple[Tuple[int, ...], ...] = ()

    def _rows(self, values, mask):
        """The per-row partial state: count 1, the values, moments 0."""
        variables = self.raw_inputs(values, mask)
        zero = torch.zeros_like(variables[0])
        sums = tuple(torch.where(mask, v, zero) for v in variables)
        return (mask.to(torch.int64),) + sums + (zero,) * len(self.orders)

    def _merge(self, parts, total, spread, as_float, at_least_one):
        """Merge parts into segments: ``total`` sums items into segments,
        ``spread`` maps a segment's value back to its items."""
        k = len(parts) - 1 - len(self.orders)
        n, sums = parts[0], parts[1 : 1 + k]
        moments = dict(zip(self.orders, parts[1 + k :]))
        count = total(n)
        seg_sums = [total(v) for v in sums]
        nf = as_float(n)
        own = at_least_one(nf)
        merged = at_least_one(as_float(count))
        deltas = [v / own - spread(t / merged) for v, t in zip(sums, seg_sums)]
        out = [count, *seg_sums]
        for e in self.orders:
            acc = 0.0
            for f in itertools.product(*(range(ev + 1) for ev in e)):
                order = sum(f)
                if order == 1:
                    continue
                term = nf if order == 0 else moments[f]
                for ev, fv, d in zip(e, f, deltas):
                    term = term * (math.comb(ev, fv) * d ** (ev - fv))
                acc = acc + term
            out.append(total(acc))
        return tuple(out)

    def _merge_torch(self, parts, total, spread):
        return self._merge(
            parts, total, spread, lambda t: t.to(torch.float64), lambda t: t.clamp(min=1.0)
        )

    def _combine_states(self, accs, news):
        pairs = tuple(torch.stack([a, b]) for a, b in zip(accs, news))
        return self._merge_torch(pairs, lambda t: t[0] + t[1], lambda t: t.unsqueeze(0))

    def update(self, accs, values, mask, group_ids, num_groups):
        rows = self._rows(values, mask)
        gid = group_ids.to(torch.int64).clamp(0, num_groups - 1)
        news = self._merge_torch(
            rows,
            lambda t: _grouped_reduce(t, mask, group_ids, num_groups, "sum"),
            lambda t: t.index_select(0, gid),
        )
        return self._combine_states(accs, news)

    def _merge_runs(self, parts, mask, runs: SortedRuns):
        slot = runs.run_index.clamp(0, max(runs.capacity - 1, 0))
        return self._merge_torch(
            parts, lambda t: runs.reduce(t, mask, "sum"), lambda t: t.index_select(0, slot)
        )

    def run_reduce(self, values, mask, runs: SortedRuns):
        return self._merge_runs(self._rows(values, mask), mask, runs)

    def merge_runs(self, acc_arrays, valid, runs: SortedRuns):
        return self._merge_runs(tuple(acc_arrays), valid, runs)

    def host_merge_sorted(self, acc_arrays, starts):
        n = len(acc_arrays[0])
        if len(starts) == 0:
            return tuple(a[:0] for a in acc_arrays)
        lengths = np.diff(np.append(starts, n))
        return self._merge(
            tuple(np.asarray(a) for a in acc_arrays),
            lambda t: np.add.reduceat(np.broadcast_to(t, (n,)), starts),
            lambda t: np.repeat(t, lengths),
            lambda t: t.astype(np.float64),
            lambda t: np.maximum(t, 1.0),
        )


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
    """The exact sums as int64.  The result type (BIGINT or DECIMAL(18, s))
    is int64-backed, so a sum outside int64 is Presto's overflow error
    (NUMERIC_VALUE_OUT_OF_RANGE), checked here once, where the sum is
    finalised; the JAX package returns the wrapped value instead."""
    exact = _wide_exact(accs[0], accs[1])
    try:
        values = exact.astype(np.int64)
    except OverflowError:
        from .runner import QueryError

        raise QueryError("NUMERIC_VALUE_OUT_OF_RANGE: sum overflows int64") from None
    return values, np.asarray(accs[2]) > 0


def check_wide_sums_in_range(accs, count: int) -> None:
    """``_wide_sum_extract``'s overflow check on the device, over the first
    ``count`` groups' (hi, lo, count) limbs: with lo carried into hi (lo is
    a sum of non-negative 32-bit chunks), the exact sum hi * 2^32 + lo fits
    int64 exactly when hi lies in [-2^31, 2^31)."""
    hi = accs[0][:count] + (accs[1][:count] >> 32)
    if not bool(((hi >= -(1 << 31)) & (hi < (1 << 31))).all()):
        from .runner import QueryError

        raise QueryError("NUMERIC_VALUE_OUT_OF_RANGE: sum overflows int64")


def _scale(t: DataType) -> int:
    return t.scale if t.kind == TypeKind.DECIMAL else 0


def _to_float(values: torch.Tensor, t: DataType) -> torch.Tensor:
    v = values.to(torch.float64)
    if t.kind == TypeKind.DECIMAL and t.scale:
        v = v / (10.0 ** t.scale)
    return v


# ---- hash mixing for checksum ------------------------------------------------


def _splitmix64(v: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over int64 lanes (wrapping arithmetic): the same
    bits as the JAX package's uint64 version, since two's-complement adds and
    multiplies wrap alike."""
    return splitmix64_mix(v.to(torch.int64) + signed64(GOLDEN_GAMMA))


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


def _value_and_count(values, mask):
    return (values[0], _ones_like(values[0]))


def _int_and_count(values, mask):
    return (values[0].to(torch.int64), _ones_like(mask))


def _value_if_counted(accs):
    return (accs[0], accs[1] > 0)


def _variance_extract(pop: bool, sqrt: bool, scale: int):
    def extract(accs):
        n, _, m2 = (np.asarray(a) for a in accs)
        nf = np.maximum(n, 1).astype(np.float64)
        denom = nf if pop else np.maximum(nf - 1.0, 1.0)
        out = np.maximum(m2, 0.0) / denom / 10.0 ** (2 * scale)
        if sqrt:
            out = np.sqrt(out)
        valid = (n >= 1) if pop else (n >= 2)
        return out, valid

    return extract


def _moments_extract(name: str):
    def extract(accs):
        n, _, m2, m3, m4 = (np.asarray(a) for a in accs)
        nf = np.maximum(n, 1).astype(np.float64)
        valid = (n >= 2) & (m2 > 0)
        if name == "skewness":
            denom = np.where(m2 > 0, np.sqrt(np.maximum(m2, 1e-300)) ** 3, 1.0)
            return np.sqrt(nf) * m3 / denom, valid
        denom = np.where(m2 > 0, m2 * m2, 1.0)
        return nf * m4 / denom - 3.0, valid

    return extract


def _covariance_extract(name: str, scale: int):
    def extract(accs):
        n, _, _, cxy, vx, vy = (np.asarray(a) for a in accs)
        nf = np.maximum(n, 1).astype(np.float64)
        if name == "corr":
            denom = np.sqrt(np.maximum(vx, 0.0) * np.maximum(vy, 0.0))
            out = np.where(denom > 0, cxy / np.where(denom > 0, denom, 1.0), np.nan)
            return out, (n >= 2) & (denom > 0)
        if name == "covar_pop":
            return cxy / nf / 10.0**scale, n >= 1
        return cxy / np.maximum(nf - 1.0, 1.0) / 10.0**scale, n >= 2

    return extract


def bind_aggregate(
    name: str,
    input_types: Union[None, DataType, Sequence[DataType]],
    input_index=None,
) -> BoundAggregate:
    """Bind an aggregate by name (reference: exec::Aggregate::create)."""
    name = name.lower()
    # Spark-package aliases (reference: velox/functions/sparksql/aggregates):
    # first/last reduce to arbitrary (deterministic here), collect_* to the
    # Presto collect aggregates
    name = {
        "first": "arbitrary",
        "last": "arbitrary",
        "collect_list": "array_agg",
        "collect_set": "set_agg",
    }.get(name, name)
    if input_types is None:
        types: Tuple[DataType, ...] = ()
    elif isinstance(input_types, DataType):
        types = (input_types,)
    else:
        types = tuple(input_types)

    from .collect_agg import COLLECT_AGG_NAMES, bind_collect

    if name in COLLECT_AGG_NAMES:
        # list-valued state, assembled on the host (exec/collect_agg.py)
        return bind_collect(name, types)

    if name == "count":
        return BoundAggregate(
            "count", BIGINT, (torch.int64,), ("sum",),
            lambda values, mask: (_ones_like(mask),),
            lambda accs: (accs[0], None),
            input_index,
            arg_roles=("plain",) * len(types),
        )

    if name in ("approx_distinct", "bloom_filter_agg"):
        # lowered by the sketch rewrite before execution (exec/sketch.py;
        # reference: common/hyperloglog/DenseHll.h, sparksql
        # BloomFilterAggAggregate.cpp): this binding only types the node
        from ..dtypes import VARBINARY

        def _unlowered(values, mask):
            raise NotImplementedError(
                f"{name} must be lowered by "
                "exec.sketch.rewrite_sketch_aggregates (LocalExecutor applies "
                "it; bloom_filter_agg's size arguments must be literals)"
            )

        return BoundAggregate(
            name, BIGINT if name == "approx_distinct" else VARBINARY,
            (torch.int64,), ("max",) if name == "approx_distinct" else ("bor",),
            _unlowered,
            lambda accs: (accs[0], None),
            input_index,
            arg_roles=("plain",) * len(types),
        )

    if name not in AGGREGATE_NAMES:
        raise KeyError(f"no aggregate function named {name!r} (not ported yet?)")
    assert types, f"{name} requires an argument"
    t0 = types[0]
    at = _acc_dtype(t0)

    if name == "count_if":
        return BoundAggregate(
            "count_if", BIGINT, (torch.int64,), ("sum",),
            lambda values, mask: (values[0].to(torch.int64),),
            lambda accs: (accs[0], None),
            input_index, arg_roles=("plain",),
        )

    if name in ("bool_and", "every", "bool_or"):
        op = "min" if name in ("bool_and", "every") else "max"
        return BoundAggregate(
            name, BOOLEAN, (torch.int64, torch.int64), (op, "sum"),
            _int_and_count,
            lambda accs: (accs[0].astype(np.bool_), accs[1] > 0),
            input_index, arg_roles=("plain",),
        )

    if name == "sum":
        if at == torch.float64:
            return BoundAggregate(
                "sum", _sum_result_type(t0), (at, torch.int64), ("sum", "sum"),
                _value_and_count,
                _value_if_counted,  # sum of zero rows is NULL
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
            _value_and_count, _value_if_counted,
            input_index, arg_roles=("order+value",),
        )

    if name == "arbitrary":
        # deterministic "any value": the smallest (reference returns the first
        # seen, which is thread-schedule-dependent; smallest is reproducible)
        return BoundAggregate(
            "arbitrary", t0, (at, torch.int64), ("min", "sum"),
            _value_and_count, _value_if_counted,
            input_index, arg_roles=("value",),
        )

    if name in ("min_by", "max_by"):
        assert len(types) == 2, f"{name} takes (value, ordering)"
        op = "min" if name == "min_by" else "max"

        def raw(values, mask):
            # ordering first (the pair's primary)
            return (values[1], values[0], _ones_like(mask))

        return BoundAggregate(
            name, t0, (_acc_dtype(types[1]), at, torch.int64), (op, op, "sum"),
            raw,
            lambda accs: (accs[1], accs[2] > 0),
            input_index,
            pairs=((0, 1, op),),
            arg_roles=("value", "order"),
        )

    if name == "avg":
        if at == torch.float64:
            def extract(accs):
                total, count = accs
                value = total.astype(np.float64) / np.maximum(count, 1)
                return value, count > 0

            return BoundAggregate(
                "avg", DOUBLE, (at, torch.int64), ("sum", "sum"),
                _value_and_count, extract, input_index, arg_roles=("plain",),
            )

        scale = t0.scale if t0.kind == TypeKind.DECIMAL else 0

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

    if name in _VARIANCE:
        return MomentAggregate(
            name, DOUBLE, (torch.int64, torch.float64, torch.float64),
            ("sum", "sum", "sum"),
            lambda values, mask: (values[0].to(torch.float64),),
            _variance_extract(name.endswith("_pop"), name.startswith("stddev"), _scale(t0)),
            input_index, arg_roles=("plain",), orders=((2,),),
        )

    if name == "geometric_mean":
        def raw(values, mask, _t=t0):
            v = _to_float(values[0], _t)
            return (torch.log(v), _ones_like(v))

        def extract(accs):
            s, n = (np.asarray(a) for a in accs)
            return np.exp(s / np.maximum(n, 1)), n > 0

        return BoundAggregate(
            "geometric_mean", DOUBLE, (torch.float64, torch.int64), ("sum", "sum"),
            raw, extract, input_index, arg_roles=("plain",),
        )

    if name in ("bitwise_and_agg", "bitwise_or_agg"):
        # reference: prestosql/aggregates/BitwiseAggregates.cpp
        op = "band" if name == "bitwise_and_agg" else "bor"
        return BoundAggregate(
            name, t0, (torch.int64, torch.int64), (op, "sum"),
            _int_and_count, _value_if_counted,
            input_index, arg_roles=("plain",),
        )

    if name == "checksum":
        # order-independent content hash: wrapping int64 sum of per-row
        # splitmix64 hashes (reference: ChecksumAggregate.h uses xxhash64 the
        # same way; null rows are excluded here rather than hashed)
        return BoundAggregate(
            "checksum", BIGINT, (torch.int64,), ("sum",),
            lambda values, mask: (_splitmix64(values[0]),),
            lambda accs: (accs[0], None),
            input_index, arg_roles=("plain",),
        )

    if name in ("skewness", "kurtosis"):
        # reference: velox/functions/prestosql/aggregates/
        # CentralMomentsAggregates.cpp; Presto semantics
        return MomentAggregate(
            name, DOUBLE,
            (torch.int64,) + (torch.float64,) * 4,
            ("sum",) * 5,
            lambda values, mask: (values[0].to(torch.float64),),
            _moments_extract(name), input_index, arg_roles=("plain",),
            orders=((2,), (3,), (4,)),
        )

    # covar_pop / covar_samp / corr
    assert len(types) == 2, f"{name} takes two arguments"
    return MomentAggregate(
        name, DOUBLE,
        (torch.int64,) + (torch.float64,) * 5,
        ("sum",) * 6,
        lambda values, mask: (values[0].to(torch.float64), values[1].to(torch.float64)),
        _covariance_extract(name, _scale(types[0]) + _scale(types[1])),
        input_index, arg_roles=("plain", "plain"),
        orders=((1, 1), (2, 0), (0, 2)),
    )


_VARIANCE = (
    "variance", "var_samp", "var_pop", "stddev", "stddev_samp", "stddev_pop",
)

# The JAX package's names (velox_tpu/exec/aggregates.py AGGREGATE_NAMES);
# the collect aggregates are exec/collect_agg.py COLLECT_AGG_NAMES.
AGGREGATE_NAMES = (
    "count", "count_if", "sum", "min", "max", "avg", "arbitrary",
    "bool_and", "bool_or", "every", "min_by", "max_by",
) + _VARIANCE + (
    "geometric_mean", "checksum", "covar_pop", "covar_samp", "corr",
    "skewness", "kurtosis", "bitwise_and_agg", "bitwise_or_agg",
    "approx_distinct", "bloom_filter_agg",
)
