"""Plan execution: plan tree -> per-tile eager torch programs -> results.

Counterpart of the JAX package's ``exec/runner.py`` (direct-aggregation part).
Reference: velox/exec/Task.h:34 + LocalPlanner.cpp:259.  The reference runs
a dynamic pull loop of operators on CPU threads.  Here the host iterates
fixed-capacity tiles from the connector and applies the pipeline's whole
operator chain (scan filter -> filters/projects -> aggregation update) to each
tile on the device, carrying the accumulator state between tiles.  Execution
is eager: every expression node issues its torch op on the tile's device.

Aggregation modes (see exec/grouping.py): ungrouped (G=1) and array (static
key ranges) run here.  Sort-mode grouping, joins, collect pipelines and device
sorts are not ported yet: a plan that needs one raises ``NotImplementedError``.

Transfer discipline: nothing is fetched per tile; the final accumulator state
and the error count are read back once (utils/transfer.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import DataType, RowType, TypeKind
from ..expr.compiler import ExprSet
from ..expr.ir import Expr, FieldAccess
from ..io.table import Table
from ..plan.nodes import (
    AggregationNode,
    FilterNode,
    LimitNode,
    OrderByNode,
    PlanNode,
    ProjectNode,
    SortKey,
    TableScanNode,
    TopNNode,
    ValuesNode,
)
from ..utils.transfer import fetch_tree
from ..vector.column import Batch, Encoding, _take_clamped
from ..vector.string_table import StringTable
from .aggregates import (
    BoundAggregate,
    _wide_normalize,
    bind_aggregate,
    narrow_int_avg,
    narrow_int_sum,
)
from .grouping import MAX_ARRAY_GROUPS, ArrayGrouping, KeyInfo, SortGrouping, key_info


class QueryError(RuntimeError):
    """Raised when any live row produced an evaluation error (division by zero,
    cast failure, ...).  Reference: VeloxUserError via EvalCtx error vectors."""


# ---------------------------------------------------------------------------
# Plan analysis


def resolve_column_strings(node: PlanNode, name: str) -> Optional[StringTable]:
    """Walk provenance of a column down to its scan to find its StringTable."""
    from ..expr.ir import DictLookup

    if isinstance(node, (TableScanNode, ValuesNode)):
        return node.table.string_tables.get(name)
    if isinstance(node, ProjectNode):
        expr = node.exprs[node.names.index(name)]
        if isinstance(expr, FieldAccess):
            return resolve_column_strings(node.source, expr.name)
        if isinstance(expr, DictLookup) and expr.strings is not None:
            # string function bound to a new result dictionary (e.g. substr)
            return expr.strings
        if expr.dtype.is_string:
            # result reuses an input column's dictionary (see ExprSet string prop)
            hit = _first_string_field(expr)
            if hit is not None:
                return resolve_column_strings(node.source, hit)
        return None
    if node.sources:
        for s in node.sources:
            if name in s.output_schema:
                return resolve_column_strings(s, name)
    return None


def resolve_column_bounds(node: PlanNode, name: str):
    """Walk provenance of a column down to its scan for (lo, hi) value bounds.

    Feeds the array-mode range keys — the analog of the reference's
    VectorHasher range mode computed from column stats
    (velox/exec/VectorHasher.h:118) — and the narrow-sum decision
    (AggExecutor: a sum whose bound x row count provably fits int64 drops the
    wide 96-bit limb accumulators).  Conservative: any step that can produce
    values outside the source column's range returns None."""
    if isinstance(node, (TableScanNode, ValuesNode)):
        return node.table.column_bounds(name)
    if isinstance(node, ProjectNode):
        expr = node.exprs[node.names.index(name)]
        return _expr_bounds(expr, node.source)
    if isinstance(node, (FilterNode, LimitNode, TopNNode, OrderByNode)):
        return resolve_column_bounds(node.sources[0], name)
    return None


_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _expr_bounds(e: Expr, src: PlanNode):
    """Interval arithmetic over integer-backed expressions (ints, dates,
    short decimals): (lo, hi) of the DEVICE representation, or None.

    Handles field provenance, integer/decimal literals, the implicit CASTs
    the registry inserts (decimal rescale = x10^ds; integer widening), and
    plus/minus/multiply/negate whose semantics are plain representation
    arithmetic (functions/presto/scalar.py: after coercion plus/minus share
    a scale, and multiply is va*vb with scale s1+s2).  Any overflow past
    int64 returns None."""
    from ..expr.ir import Call, Constant, Special, SpecialForm

    def _int_backed(t: DataType) -> bool:
        if t.kind == TypeKind.DECIMAL:
            return not t.is_long_decimal
        return t.is_integer or t.kind in (TypeKind.DATE, TypeKind.BOOLEAN)

    if isinstance(e, FieldAccess):
        return resolve_column_bounds(src, e.name)
    if isinstance(e, Constant):
        v = e.value
        if v is None or not _int_backed(e.dtype):
            return None
        if isinstance(v, (bool, np.bool_, int, np.integer)):
            return (int(v), int(v))
        return None
    if (
        isinstance(e, Special)
        and e.form in (SpecialForm.CAST, SpecialForm.TRY_CAST)
        and len(e.args) == 1
    ):
        st, dt = e.args[0].dtype, e.dtype
        if not (_int_backed(st) and _int_backed(dt)):
            return None
        inner = _expr_bounds(e.args[0], src)
        if inner is None:
            return None
        s_in = st.scale if st.kind == TypeKind.DECIMAL else 0
        s_out = dt.scale if dt.kind == TypeKind.DECIMAL else 0
        d = s_out - s_in
        if d < 0:
            return None  # representation shrinks with rounding: bail
        lo, hi = inner[0] * 10**d, inner[1] * 10**d
        if lo < _I64_MIN or hi > _I64_MAX:
            return None
        return (lo, hi)
    if isinstance(e, Call) and e.name in ("plus", "minus", "multiply", "negate"):
        if not _int_backed(e.dtype):
            return None
        bs = [_expr_bounds(a, src) for a in e.args]
        if any(b is None for b in bs):
            return None
        if e.name == "negate":
            lo, hi = -bs[0][1], -bs[0][0]
        elif e.name == "plus":
            if e.args[0].dtype != e.args[1].dtype:
                return None  # un-aligned scales: representation math invalid
            lo, hi = bs[0][0] + bs[1][0], bs[0][1] + bs[1][1]
        elif e.name == "minus":
            if e.args[0].dtype != e.args[1].dtype:
                return None
            lo, hi = bs[0][0] - bs[1][1], bs[0][1] - bs[1][0]
        else:  # multiply: representation product (scale s1+s2)
            corners = [a * b for a in bs[0] for b in bs[1]]
            lo, hi = min(corners), max(corners)
        if lo < _I64_MIN or hi > _I64_MAX:
            return None
        return (lo, hi)
    return None


def resolve_affine_product(src: PlanNode, name: str):
    """Resolve a named aggregation input to ``const * prod(scale*col + off)``
    over SCAN columns, or None.

    Feeds the grouped piece-sum lowering (ops/group_piece.py): a sum input
    that is a product of affine transforms of scan columns can be computed
    in-kernel from the raw bounds-narrowed device columns, so the whole
    grouped aggregation reads each scanned byte exactly once.  Returns
    (const, [(scan_node, col_name, scale, offset), ...]) with all literals
    folded.  Mirrors resolve_column_bounds' provenance walk; conservative —
    anything unrecognized returns None."""
    from ..expr.ir import Call, Special, SpecialForm

    def field(nm, node):
        if isinstance(node, TableScanNode):
            return ("scan", node, nm) if nm in node.output_schema.names else None
        if isinstance(node, ProjectNode):
            if nm in node.names:
                return ("expr", node.exprs[node.names.index(nm)], node.source)
            return None
        if isinstance(node, FilterNode):
            return field(nm, node.sources[0])
        return None

    def go(e, node):
        """-> (const, factors) with value == const * prod(s*col + o), or None."""
        if isinstance(e, FieldAccess):
            r = field(e.name, node)
            if r is None:
                return None
            if r[0] == "scan":
                return (1, [(r[1], r[2], 1, 0)])
            return go(r[1], r[2])
        b = _expr_bounds(e, node)
        if b is not None and b[0] == b[1]:
            return (b[0], [])
        if (
            isinstance(e, Special)
            and e.form in (SpecialForm.CAST, SpecialForm.TRY_CAST)
            and len(e.args) == 1
        ):
            st, dt = e.args[0].dtype, e.dtype
            s_in = st.scale if st.kind == TypeKind.DECIMAL else 0
            s_out = dt.scale if dt.kind == TypeKind.DECIMAL else 0
            d = s_out - s_in
            if d < 0:
                return None
            inner = go(e.args[0], node)
            if inner is None:
                return None
            return (inner[0] * 10**d, inner[1])
        if isinstance(e, Call):
            if e.name == "multiply" and len(e.args) == 2:
                a = go(e.args[0], node)
                b2 = go(e.args[1], node)
                if a is None or b2 is None:
                    return None
                return (a[0] * b2[0], a[1] + b2[1])
            if e.name == "negate" and len(e.args) == 1:
                a = go(e.args[0], node)
                if a is None:
                    return None
                return (-a[0], a[1])
            if e.name in ("plus", "minus") and len(e.args) == 2:
                if e.args[0].dtype != e.args[1].dtype:
                    return None  # un-aligned decimal scales
                a = go(e.args[0], node)
                b2 = go(e.args[1], node)
                if a is None or b2 is None:
                    return None
                sgn = -1 if e.name == "minus" else 1
                # affine fold: const +- (c * single factor)
                if not a[1] and len(b2[1]) == 1 and b2[0] != 0:
                    sn, cn, s, o = b2[1][0]
                    c = sgn * b2[0]
                    return (1, [(sn, cn, c * s, c * o + a[0])])
                if not b2[1] and len(a[1]) == 1 and a[0] != 0:
                    sn, cn, s, o = a[1][0]
                    return (1, [(sn, cn, a[0] * s, a[0] * o + sgn * b2[0])])
                if not a[1] and not b2[1]:
                    return (a[0] + sgn * b2[0], [])
                return None
        return None

    r = field(name, src)
    if r is None:
        return None
    if r[0] == "scan":
        return (1, [(r[1], r[2], 1, 0)])
    return go(r[1], r[2])


def resolve_column_nullable(node: PlanNode, name: str) -> bool:
    """May this column hold NULLs?  Conservative (True when unsure) — feeds
    null-aware grouping (SQL: NULL keys form ONE group; reference:
    velox/exec/VectorHasher.h null value-id handling).  Precision matters
    mainly for array-mode radix budgets."""
    if isinstance(node, (TableScanNode, ValuesNode)):
        v = node.table.validities.get(name)
        return v is not None and not bool(np.asarray(v).all())
    if isinstance(node, ProjectNode):
        expr = node.exprs[node.names.index(name)]
        if isinstance(expr, FieldAccess):
            return resolve_column_nullable(node.source, expr.name)
        from ..expr.ir import Constant

        if isinstance(expr, Constant):
            return expr.value is None
        return True
    if isinstance(node, (FilterNode, LimitNode, TopNNode, OrderByNode)):
        return resolve_column_nullable(node.sources[0], name)
    if isinstance(node, AggregationNode):
        if name in node.grouping_keys:
            return resolve_column_nullable(node.sources[0], name)
        return True  # aggregate results (e.g. sum over zero rows) can be null
    if node.sources:
        for s in node.sources:
            if name in s.output_schema:
                return resolve_column_nullable(s, name)
    return True


def _first_string_field(expr: Expr) -> Optional[str]:
    if isinstance(expr, FieldAccess) and expr.dtype.is_string:
        return expr.name
    for c in expr.children:
        hit = _first_string_field(c)
        if hit is not None:
            return hit
    return None


@dataclasses.dataclass
class _Linear:
    """A linearized single-pipeline plan (scan .. optional agg .. finishers)."""

    source: PlanNode  # TableScanNode or ValuesNode
    steps: List[Tuple]  # ('filter', Expr) | ('project', names, exprs, schema)
    agg: Optional[AggregationNode]
    finishers: List[PlanNode]  # OrderBy/TopN/Limit from bottom to top


def _linearize(root: PlanNode) -> _Linear:
    finishers: List[PlanNode] = []
    node = root
    while isinstance(node, (OrderByNode, TopNNode, LimitNode)):
        finishers.append(node)
        node = node.sources[0]
    agg = None
    if isinstance(node, AggregationNode):
        agg = node
        node = node.sources[0]
    steps_rev: List[Tuple] = []
    while isinstance(node, (FilterNode, ProjectNode)):
        if isinstance(node, FilterNode):
            steps_rev.append(("filter", node.predicate))
        else:
            steps_rev.append(("project", node.names, node.exprs, node.output_schema))
        node = node.sources[0]
    if isinstance(node, TableScanNode) and node.subfield_filter is not None:
        steps_rev.append(("filter", node.subfield_filter))
    steps = list(reversed(steps_rev))
    finishers.reverse()
    return _Linear(node, steps, agg, finishers)


# ---------------------------------------------------------------------------
# Streaming operator application


def apply_streaming(batch: Batch, steps: Sequence[Tuple]):
    """Apply filter/project steps; returns (batch, error_count_on_live_rows)
    with the count a 0-d int64 tensor on the batch's device."""
    err = torch.zeros((), dtype=torch.int64, device=batch.device)
    for step in steps:
        active = batch.active_mask()
        if step[0] == "filter":
            [r] = ExprSet([step[1]]).eval(batch)
            if r.errors is not None:
                err = err + (r.errors & active).sum()
            keep = r.values.to(torch.bool)
            if r.validity is not None:
                keep = keep & r.validity
            batch = batch.with_selection(keep)
        elif step[0] == "project":
            _, names, exprs, schema = step
            cols, errors = ExprSet(list(exprs)).eval_to_columns(batch)
            if errors is not None:
                err = err + (errors & active).sum()
            batch = batch.with_columns(schema, cols)
        else:
            raise NotImplementedError(f"pipeline step {step[0]!r} is not ported yet")
    return batch, err


# ---------------------------------------------------------------------------
# Aggregation executor


class AggExecutor:
    """Executes one AggregationNode over a stream of tiles."""

    def __init__(
        self,
        node: AggregationNode,
        capacity: int,
        presorted: bool = False,
        max_rows: Optional[int] = None,
    ):
        """``max_rows``: a proven upper bound on TOTAL input rows across all
        tiles (None = unbounded) — gates the narrow-sum rebinding below."""
        self.node = node
        self.capacity = capacity
        self.presorted = presorted
        self._piece_plan = None
        self._piece_wide: List[bool] = []
        in_schema = node.source.output_schema
        self.aggs: List[BoundAggregate] = []
        self.arg_names: List[List[str]] = []
        # per agg, per arg: optional code->rank gather (string ordering); plus
        # per agg: the output StringTable and the rank->code inverse, if any
        self.arg_transforms: List[List[Optional[np.ndarray]]] = []
        self.out_strings: List[Optional[StringTable]] = []
        self.out_inverse: List[Optional[np.ndarray]] = []
        for call in node.aggregates:
            names: List[str] = []
            dtypes = []
            for arg in call.args:
                assert isinstance(arg, FieldAccess), "agg args must be fields"
                names.append(arg.name)
                dtypes.append(arg.dtype)
            bound = bind_aggregate(call.name, tuple(dtypes) or None, None)
            transforms: List[Optional[np.ndarray]] = [None] * len(names)
            out_tab = out_inv = None
            for j, (dt, role) in enumerate(zip(dtypes, bound.arg_roles)):
                if not dt.is_string:
                    continue
                tab = resolve_column_strings(node.source, names[j])
                if tab is None:
                    raise TypeError(
                        f"{call.name}({names[j]}): VARCHAR argument has no "
                        "resolvable dictionary"
                    )
                if role == "plain":
                    raise TypeError(f"{call.name} does not accept VARCHAR")
                if "order" in role:
                    # accumulate lexicographic ranks, not insertion codes
                    ranks = np.asarray(tab.sort_permutation(), np.int32)
                    transforms[j] = ranks
                    if "value" in role:
                        inv = np.empty(len(ranks), dtype=np.int64)
                        inv[ranks] = np.arange(len(ranks), dtype=np.int64)
                        out_tab, out_inv = tab, inv
                elif j == 0:  # pure 'value': codes pass through untouched
                    out_tab = tab
            self.aggs.append(bound)
            self.arg_names.append(names)
            self.arg_transforms.append(transforms)
            self.out_strings.append(out_tab)
            self.out_inverse.append(out_inv)

        # Narrow-sum rebinding: a wide (96-bit limb) integer sum whose input
        # bounds prove |sum| < 2^62 over max_rows drops to a single int64
        # accumulator — one accumulator array instead of three per sum.
        # Reference analog: DecimalAggregate's overflow-tracking is likewise
        # skipped when the type's range proves it dead
        # (velox/functions/prestosql/aggregates/DecimalAggregate.h).
        for i, (agg, names) in enumerate(zip(self.aggs, self.arg_names)):
            if (
                max_rows is not None
                and agg.name in ("sum", "avg")
                and len(agg.acc_dtypes) == 3
                and names
            ):
                b = resolve_column_bounds(node.source, names[0])
                if b is not None:
                    bound_mag = max(abs(b[0]), abs(b[1]))
                    if bound_mag * max(max_rows, 1) <= (1 << 62):
                        if agg.name == "sum":
                            self.aggs[i] = narrow_int_sum(
                                agg.result_type, agg.input_index
                            )
                        else:
                            t0 = in_schema.type_of(names[0])
                            scale = t0.scale if t0.kind == TypeKind.DECIMAL else 0
                            self.aggs[i] = narrow_int_avg(scale, agg.input_index)

        self.key_infos: List[KeyInfo] = [
            key_info(
                k,
                in_schema.type_of(k),
                resolve_column_strings(node.source, k),
                resolve_column_bounds(node.source, k),
                nullable=resolve_column_nullable(node.source, k),
            )
            for k in node.grouping_keys
        ]
        self.n_output_keys = len(self.key_infos)
        if not self.key_infos:
            self.mode = "ungrouped"
            self.num_groups = 1
            self.grouping = None
        elif all(k.radix is not None for k in self.key_infos) and _radix_product(
            self.key_infos
        ) <= MAX_ARRAY_GROUPS:
            self.mode = "array"
            self.grouping = ArrayGrouping(self.key_infos)
            self.num_groups = self.grouping.num_groups
        else:
            self.mode = "sort"
            self.grouping = SortGrouping(self.key_infos, presorted)  # raises
            self.num_groups = capacity

    # ---- direct modes (ungrouped / array): carried accumulators ----------
    def init_carry(self, device=None):
        accs = tuple(agg.acc_init(self.num_groups, device) for agg in self.aggs)
        rowcounts = torch.zeros((self.num_groups,), dtype=torch.int64, device=device)
        return (accs, rowcounts)

    def _decode_args(self, batch: Batch, i: int):
        """Decode + transform aggregate i's argument columns.

        Returns (values tuple, per-row validity mask or None)."""
        values: List[torch.Tensor] = []
        validity = None
        for j, name in enumerate(self.arg_names[i]):
            v, val = batch.column(name).decode(batch.capacity)
            tr = self.arg_transforms[i][j]
            if tr is not None:
                v = _take_clamped(torch.as_tensor(tr, device=v.device), v)
            values.append(v)
            if val is not None:
                validity = val if validity is None else (validity & val)
        return tuple(values), validity

    # ---- grouped piece-sum path (ops/group_piece.py) -----------------------
    def try_enable_piece_path(self) -> bool:
        """Lower ALL accumulator updates onto the exact grouped piece-sum
        kernel when every aggregate is a (narrow) sum/avg/count over a
        product of affine transforms of non-nullable scan columns with
        int32-provable bounds (resolve_affine_product).

        The default update decodes and widens every argument column to int64
        and reduces it once per accumulator; the piece path reads the raw
        bounds-narrowed device columns once for the whole aggregation.
        Reference analog: single-pass accumulator updates over group
        pointers, velox/exec/GroupingSet.cpp:294.

        One gate is wider than the JAX package's: a sum or avg that kept its
        wide (hi, lo, count) limb accumulators, because its bound times the
        TOTAL row count passes 2^62, still takes this path when its bound
        times ONE TILE's rows does not.  The kernel's per-tile sum is then an
        exact int64 and is split into the limbs on the way into the carry
        (TPC-H Q1's sum_charge from about SF 7 up)."""
        if self.mode not in ("array", "ungrouped"):
            return False
        if self.num_groups > 64 or self.capacity % 512:
            return False
        from ..ops.group_piece import Factor, plan_spec

        node = self.node
        col_names: List[str] = []
        scan_id = [None]

        def col_index(scan_node, cn) -> Optional[int]:
            if scan_id[0] is None:
                scan_id[0] = id(scan_node)
            elif scan_id[0] != id(scan_node):
                return None  # factors must share one scan
            v = scan_node.table.validities.get(cn)
            if v is not None and not bool(np.asarray(v).all()):
                return None  # nullable input: counts would diverge
            if cn not in col_names:
                col_names.append(cn)
            return col_names.index(cn)

        spec_keys: List[tuple] = []
        spec_factors: List[list] = []

        def spec_of(factors) -> int:
            key = tuple((f.col, f.scale, f.offset) for f in factors)
            if key in spec_keys:
                return spec_keys.index(key)
            spec_keys.append(key)
            spec_factors.append(list(factors))
            return len(spec_keys) - 1

        count_idx = spec_of(())  # live-row count rides spec 0
        slot_map: List[List[int]] = []
        wide_aggs: List[bool] = []
        for i, agg in enumerate(self.aggs):
            wide = (
                agg.post_combine is _wide_normalize
                and tuple(agg.acc_ops) == ("sum", "sum", "sum")
            )
            wide_aggs.append(wide)
            if agg.pairs or (agg.post_combine and not wide):
                return False
            if any(t is not None for t in self.arg_transforms[i]):
                return False
            if agg.name == "count" and not self.arg_names[i]:
                slot_map.append([count_idx])
                continue
            if (
                agg.name in ("sum", "avg", "count")
                and (wide or tuple(agg.acc_ops) in (("sum", "sum"), ("sum",)))
                and all(dt == torch.int64 for dt in agg.acc_dtypes)
                and len(self.arg_names[i]) == 1
            ):
                ap = resolve_affine_product(node.source, self.arg_names[i][0])
                if ap is None:
                    return False
                const, raw_factors = ap
                if not raw_factors or const == 0:
                    return False
                factors = []
                for j, (sn, cn, s, o) in enumerate(raw_factors):
                    if j == 0:
                        s, o = s * const, o * const
                    b = sn.table.column_bounds(cn)
                    if b is None or b[0] < -(1 << 31) or b[1] >= 1 << 31:
                        return False
                    ci = col_index(sn, cn)
                    if ci is None:
                        return False
                    lo = min(s * b[0] + o, s * b[1] + o)
                    hi = max(s * b[0] + o, s * b[1] + o)
                    factors.append(Factor(ci, s, o, lo, hi))
                if agg.name == "count":
                    # count(x) over proven non-null x == live-row count
                    slot_map.append([count_idx])
                    continue
                if wide:
                    # the kernel sums one tile in int64: prove that it fits
                    tile_bound = self.capacity
                    for f in factors:
                        tile_bound *= max(abs(f.lo), abs(f.hi))
                    if tile_bound > (1 << 62):
                        return False
                vi = spec_of(factors)
                slot_map.append([vi, count_idx])
                continue
            return False
        plans = tuple(plan_spec(f) for f in spec_factors)
        if any(p is None for p in plans):
            return False
        # cost gate: with few groups x accumulators the per-accumulator
        # masked reductions already read little more than the scan itself;
        # one pass over the raw columns only pays off when that product grows
        total_slots = 1 + sum(len(s) for s in slot_map)
        if self.num_groups * total_slots < 16:
            return False
        self._piece_plan = (tuple(col_names), plans, slot_map, count_idx)
        self._piece_wide = wide_aggs
        return True

    def piece_inputs(self, scan_batch: Batch, mask, gids):
        """(columns, gid_live) for grouped_piece_sums: the raw scan columns of
        the piece plan and the group id per row with dead rows at -1; None
        when a scan column is not a flat, non-null integer tensor."""
        cols = []
        for nm in self._piece_plan[0]:
            c = scan_batch.column(nm)
            if c.encoding != Encoding.FLAT or c.validity is not None:
                return None
            if c.data.dtype.is_floating_point or c.data.dtype == torch.bool:
                return None
            cols.append(c.data)
        small = self.num_groups <= 127
        gid_live = torch.where(mask, gids, torch.full_like(gids, -1)).to(
            torch.int8 if small else torch.int32
        )
        return tuple(cols), gid_live

    def _piece_update(self, carry, scan_batch: Batch, mask, gids):
        """The whole tile update as one grouped piece-sum over the raw scan
        columns; None (-> the general path) when piece_inputs refuses."""
        from ..ops.group_piece import grouped_piece_sums

        _, plans, slot_map, count_idx = self._piece_plan
        inputs = self.piece_inputs(scan_batch, mask, gids)
        if inputs is None:
            return None
        cols, gid_live = inputs
        accs, rowcounts = carry
        outs = grouped_piece_sums(cols, gid_live, plans, self.num_groups)
        rowcounts = rowcounts + outs[count_idx]
        new_accs = []
        for agg, acc, slots, wide in zip(self.aggs, accs, slot_map, self._piece_wide):
            news = tuple(outs[s] for s in slots)
            if wide:  # exact int64 tile sum -> (hi, lo, count) limbs
                total, count = news
                news = (total >> 32, total & 0xFFFFFFFF, count)
            new_accs.append(agg._combine_states(acc, news))
        return (tuple(new_accs), rowcounts)

    def update_carry(self, carry, batch: Batch, scan_batch: Optional[Batch] = None):
        """One tile's update of the direct-mode accumulators.

        When the scan tile rides along row-aligned (filter/project-only
        pipelines) and try_enable_piece_path() proved an exact lowering, the
        whole update runs as one grouped piece-sum over the raw narrow
        columns; otherwise every aggregate reduces its own accumulators."""
        accs, rowcounts = carry
        mask = batch.active_mask()
        if self.mode == "array":
            gids = self.grouping.group_ids(batch)
        else:
            gids = torch.zeros((batch.capacity,), dtype=torch.int32, device=batch.device)
        if self._piece_plan is not None and scan_batch is not None:
            res = self._piece_update(carry, scan_batch, mask, gids)
            if res is not None:
                return res
        return self._update_carry_per_acc(accs, rowcounts, batch, mask, gids)

    def _update_carry_per_acc(self, accs, rowcounts, batch, mask, gids):
        """Per-aggregate update: each accumulator is one masked reduction."""
        from ..ops.segmented import direct_group_reduce, masked_reduce

        out = []
        for i, (agg, acc) in enumerate(zip(self.aggs, accs)):
            values, validity = self._decode_args(batch, i)
            m = mask if validity is None else (mask & validity)
            out.append(agg.update(acc, values, m, gids, self.num_groups))
        ones = mask.to(torch.int64)
        if self.num_groups == 1:
            rowcounts = rowcounts + masked_reduce(ones, mask, "sum").reshape(1)
        else:
            rowcounts = rowcounts + direct_group_reduce(
                ones, mask, gids, self.num_groups, "sum"
            )
        return (tuple(out), rowcounts)

    def extract(self, key_arrays, accs, rowcounts=None) -> Table:
        """Final host-side result from fetched (numpy) accumulators."""
        node = self.node
        names = list(node.output_schema.names)
        types = list(node.output_schema.types)
        cols: Dict[str, np.ndarray] = {}
        tables: Dict[str, StringTable] = {}
        validities: Dict[str, np.ndarray] = {}
        nkeys = len(node.grouping_keys)
        live = None
        if self.mode == "array":
            # keep only groups that actually received rows
            live = np.asarray(rowcounts) > 0
            host_keys = self.grouping.key_arrays()
            key_valids = self.grouping.key_validities()
            for info, name, arr, kv in zip(
                self.key_infos, names[:nkeys], host_keys, key_valids
            ):
                cols[name] = arr[live]
                if info.strings is not None:
                    tables[name] = info.strings
                if kv is not None:
                    v = kv[live]
                    if not v.all():
                        validities[name] = v
        for i, (agg, acc, name) in enumerate(zip(self.aggs, accs, names[nkeys:])):
            acc_np = tuple(np.asarray(a) for a in acc)
            if live is not None:
                acc_np = tuple(a[live] for a in acc_np)
            values, validity = agg.extract(acc_np)
            values = np.asarray(values)
            inv = self.out_inverse[i]
            if inv is not None:
                # min/max over VARCHAR accumulated lexicographic ranks
                values = inv[np.clip(values.astype(np.int64), 0, len(inv) - 1)]
            if self.out_strings[i] is not None:
                tables[name] = self.out_strings[i]
            cols[name] = values
            if validity is not None:
                validity = np.asarray(validity)
                if not validity.all():
                    validities[name] = validity
        return Table(RowType(names, types), cols, tables, validities)


def _radix_product(infos: Sequence[KeyInfo]) -> int:
    p = 1
    for k in infos:
        p *= k.radix + (1 if k.nullable else 0)  # +1 id for the NULL group
    return p


# ---------------------------------------------------------------------------
# Finishers (OrderBy / TopN / Limit) — applied to small host-side results


def _sort_indices(table: Table, keys: Sequence[SortKey]) -> np.ndarray:
    arrays = []
    for key in reversed(keys):
        arr = table.columns[key.name]
        if key.name in table.string_tables:
            ranks = table.string_tables[key.name].sort_permutation()
            arr = ranks[arr]
        arr = np.asarray(arr)
        if not key.ascending:
            if arr.dtype.kind in "iu":
                arr = -arr.astype(np.int64)
            else:
                arr = -arr
        validity = table.validities.get(key.name)
        if validity is not None and not validity.all():
            # NULL ordering: a flag more significant than the value
            arrays.append(np.where(validity, arr, np.zeros_like(arr)))
            arrays.append(
                np.where(validity, 1, 0)
                if key.nulls_first
                else np.where(validity, 0, 1)
            )
        else:
            arrays.append(arr)
    return np.lexsort(tuple(arrays))


def _table_slice(table: Table, index) -> Table:
    return Table(
        table.schema,
        {n: v[index] for n, v in table.columns.items()},
        table.string_tables,
        {n: v[index] for n, v in table.validities.items()},
    )


def apply_finishers(table: Table, finishers: Sequence[PlanNode]) -> Table:
    for node in finishers:
        if isinstance(node, (OrderByNode, TopNNode)):
            order = _sort_indices(table, node.keys)
            if isinstance(node, TopNNode):
                order = order[: node.count]
            table = _table_slice(table, order)
        elif isinstance(node, LimitNode):
            table = _table_slice(table, slice(node.offset, node.offset + node.count))
    return table


# ---------------------------------------------------------------------------
# The single-device runner


def _pick_capacity(num_rows: int, tile_rows: int) -> int:
    cap = 1024
    while cap < min(num_rows, tile_rows):
        cap *= 2
    return cap


@dataclasses.dataclass
class RunStats:
    """Per-run counters (reference: TaskStats, velox/exec/TaskStats.h:30).

    ``device_seconds`` is the host clock around the tile loop and the final
    fetch (which waits for the device); ``total_seconds`` adds extraction and
    the finishers."""

    tiles: int = 0
    rows_in: int = 0
    device_seconds: float = 0.0
    total_seconds: float = 0.0


class LocalExecutor:
    """A reusable executor for one plan (the Task analog).

    Construction does the planning once: linearization, the aggregation mode
    and piece-path decisions.  ``device`` None means the CUDA device and
    raises when there is none.  Error counts are carried on the device and
    checked once at the end (no per-tile host sync).
    """

    def __init__(
        self,
        root: PlanNode,
        tile_rows: int = 1 << 20,
        config=None,
        pool=None,
        device=None,
    ):
        from ..config import DEFAULT_CONFIG
        from .memory import ROOT_POOL

        self.device = resolve_device(device)
        self.config = config or DEFAULT_CONFIG
        # Device-memory accounting: the executor reserves its device-resident
        # state (scan tiles) against a per-query pool.  Reference:
        # velox/common/memory/MemoryPool.h:109 + MemoryArbitrator.h:43.
        self._own_pool = pool is None
        if pool is None:
            pool = ROOT_POOL.add_child(
                f"query.{getattr(root, 'id', 'plan')}",
                limit=self.config.query_memory_limit_bytes,
            )
        self.pool = pool
        self.root = root
        self.tile_rows = tile_rows
        lin = _linearize(root)
        if not isinstance(lin.source, (TableScanNode, ValuesNode)):
            raise NotImplementedError(
                f"{lin.source.name} below the pipeline is not ported yet: only "
                "scan -> filter/project -> aggregation -> orderby/topn/limit runs"
            )
        self.lin = lin
        self.source_table = lin.source.table.select(
            list(lin.source.output_schema.names)
        )
        self.capacity = _pick_capacity(max(self.source_table.num_rows, 1), tile_rows)
        self.agg_exec: Optional[AggExecutor] = None
        if lin.agg is None:
            raise NotImplementedError(
                "pipelines without an aggregation (collect kind) are not ported "
                "yet; they come with the joins slice"
            )
        # filters and projects cannot grow the row count: the table's row
        # count bounds the aggregation input (narrow-sum rebinding)
        ex = AggExecutor(
            lin.agg, self.capacity, max_rows=self.source_table.num_rows
        )
        self.agg_exec = ex
        self.kind = "direct_agg"
        # filter/project steps never compact, so the scan tile stays
        # row-aligned with the aggregation input — the precondition for the
        # piece-sum path (raw narrow columns in, one pass over every scanned
        # byte)
        self.use_piece = ex.try_enable_piece_path()

    def _tile_step(self, carry, batch: Batch):
        accs_rc, errs = carry
        batch2, err = apply_streaming(batch, self.lin.steps)
        accs_rc = self.agg_exec.update_carry(
            accs_rc, batch2, scan_batch=batch if self.use_piece else None
        )
        return (accs_rc, errs + err)

    def run(
        self,
        prefetched_tiles: Optional[List[Batch]] = None,
        stats: Optional[RunStats] = None,
    ) -> Table:
        t_start = time.perf_counter()
        if prefetched_tiles is not None:
            if any(t.capacity != self.capacity for t in prefetched_tiles):
                raise ValueError(
                    f"prefetched tiles must have capacity {self.capacity}"
                )
            tiles = iter(prefetched_tiles)
            n_tiles = len(prefetched_tiles)
        else:
            tiles = self.source_table.tiles(self.capacity, self.device)
            n_tiles = self.source_table.num_tiles(self.capacity)
        if stats is not None:
            stats.tiles = n_tiles
            stats.rows_in = self.source_table.num_rows

        ex = self.agg_exec
        carry = (
            ex.init_carry(self.device),
            torch.zeros((), dtype=torch.int64, device=self.device),
        )
        t0 = time.perf_counter()
        for tile in tiles:
            carry = self._tile_step(carry, tile)
        # one fetch for the whole final state
        (accs_np, rowcounts_np), errs = fetch_tree(carry)
        if stats is not None:
            stats.device_seconds = time.perf_counter() - t0
        _raise_on_errors(int(errs))
        result = ex.extract(None, accs_np, rowcounts_np)
        result = apply_finishers(result, self.lin.finishers)
        if stats is not None:
            stats.total_seconds = time.perf_counter() - t_start
        return result

    def device_tiles(self) -> List[Batch]:
        """Upload the source scan device-resident (steady-state benchmarking)."""
        from .memory import batch_bytes

        tiles = self.source_table.device_tiles(self.capacity, self.device)
        self.pool.reserve(batch_bytes(tiles))
        return tiles

    def __del__(self):
        pool = getattr(self, "pool", None)
        if pool is not None and getattr(self, "_own_pool", False):
            pool.detach()


def run_plan(
    root: PlanNode,
    tile_rows: int = 1 << 20,
    stats: Optional[RunStats] = None,
    prefetched_tiles: Optional[List[Batch]] = None,
    device=None,
) -> Table:
    """One-shot convenience around LocalExecutor (tests, small queries)."""
    return LocalExecutor(root, tile_rows, device=device).run(prefetched_tiles, stats)


def _raise_on_errors(count: int):
    if count:
        raise QueryError(
            f"{count} row(s) raised during evaluation (division by zero / bad cast); "
            "wrap the expression in try(...) to null them instead"
        )
