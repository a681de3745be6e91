"""Plan execution: plan tree -> per-tile eager torch programs -> results.

Counterpart of the JAX package's ``exec/runner.py``.  Reference:
velox/exec/Task.h:34 + LocalPlanner.cpp:259.  The reference runs a dynamic
pull loop of operators on CPU threads.  Here the host iterates fixed-capacity
tiles from the connector and applies the pipeline's whole operator chain (scan
filter -> filters/projects/join probes -> aggregation update) to each tile on
the device, carrying the accumulator state between tiles.  Execution is eager:
every expression node issues its torch op on the tile's device.

Aggregation modes (see exec/grouping.py): ungrouped (G=1), array (static key
ranges) and sort (per-tile partial groups merged into a device-resident sorted
carry, ``sort_agg_device``, or on the host, ``sort_agg``).  Pipelines without
an aggregation collect their rows (``collect``), with a leading OrderBy / TopN
run on the device (exec/sort.py).  Join build sides and every other non-scan
source run as sub-executors when the executor is constructed.

An expansion (N:M) join splits the pipeline into phases: the steps up to
it, its spans (one scalar read a tile sizes the power-of-two output bucket),
its expansion, then the next phase (``_expand_tile``).  A FULL join is always
an expansion join: every tile ORs its build rows' matched flags, and after
the last tile the unmatched build rows enter the pipeline as one more tile
just above the join (``full_tail``).

Window, UNION ALL and MergeExchange sources are barriers: their inputs run
into host Tables first, before anything else of the executor, and the plan
above is rebuilt over the result (so string dictionaries, value bounds and
nullability are those of the rows the pipeline sees).  A window runs one
device pass over a tile of whole partitions (``_materialize_window``); UNION
ALL concatenates its inputs by position (``exec/grouped.py concat_tables``);
MergeExchange concatenates and sorts again on the device.  A collect over
tiles whose columns differ in carrying a validity (a FULL join's tail tile)
gives them one layout first (``_align_layouts``).

Not ported yet, each raising ``NotImplementedError`` by name: the unnest and
group-id steps, the collect aggregates, spilling (of windows, sorts and
aggregation partials) and the Grace join fallback.  The JAX package's
split-dispatch programs, ``tjit`` and buffer donation exist for its compiler
and have no counterpart here.

Transfer discipline: nothing is fetched per tile on the device paths but the
output count of each expansion join.  The sorted-carry path reads tile 0's
run count once (to size the carry), then the count / overflow / error scalars
and the live prefix at the end (utils/transfer.py).
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
    AssignUniqueIdNode,
    EnforceSingleRowNode,
    FilterNode,
    HashJoinNode,
    JoinType,
    LimitNode,
    MergeExchangeNode,
    OrderByNode,
    PlanNode,
    ProjectNode,
    SortKey,
    TableScanNode,
    TopNNode,
    UnionAllNode,
    ValuesNode,
)
from ..ops.compact import compact
from ..utils.transfer import bucket_of, fetch_prefix, fetch_tree
from ..vector.column import Batch, Column, Encoding, _take_clamped
from ..vector.string_table import StringTable
from .aggregates import (
    BoundAggregate,
    _wide_normalize,
    bind_aggregate,
    narrow_int_avg,
    narrow_int_sum,
)
from .grouping import MAX_ARRAY_GROUPS, ArrayGrouping, KeyInfo, SortGrouping, key_info
from .window import WindowNode


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
    if isinstance(node, (UnionAllNode, MergeExchangeNode)):
        # the inputs' rows are concatenated into one merged dictionary: only
        # a dictionary every input shares keeps its codes there
        i = list(node.output_schema.names).index(name)
        tabs = [resolve_column_strings(s, s.output_schema.names[i]) for s in node.inputs]
        return tabs[0] if all(t is tabs[0] for t in tabs) else None
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
    if isinstance(node, HashJoinNode):
        # join output columns pass through from one side unchanged
        for s in (node.left, node.right):
            if name in s.output_schema:
                return resolve_column_bounds(s, name)
        return None
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
    if isinstance(node, HashJoinNode):
        jt = node.join_type
        if name in node.right.output_schema and name not in node.left.output_schema:
            # build-side column: LEFT/FULL null-extend unmatched probe rows
            if jt in (JoinType.LEFT, JoinType.FULL):
                return True
            return resolve_column_nullable(node.right, name)
        if name in node.left.output_schema:
            if jt == JoinType.FULL:
                return True  # unmatched-build epilogue nulls the probe side
            return resolve_column_nullable(node.left, name)
        return True
    if isinstance(node, AggregationNode):
        if name in node.grouping_keys:
            return resolve_column_nullable(node.sources[0], name)
        return True  # aggregate results (e.g. sum over zero rows) can be null
    if isinstance(node, (UnionAllNode, MergeExchangeNode)):
        # inputs align by position: the column may be NULL where any input's
        # column at that position may be (the JAX package asks the first
        # input only, and so misses NULLs that a later input brings)
        i = list(node.output_schema.names).index(name)
        return any(
            resolve_column_nullable(s, s.output_schema.names[i]) for s in node.inputs
        )
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

    source: PlanNode  # a scan, or any node the executor materializes first
    # ('filter', Expr) | ('project', names, exprs, schema) | ('join', node,
    # replaced by the built HashJoinExec when the executor is constructed;
    # ('xjoin', exec) for an expansion join) | ('left_join_filter', Expr,
    # build column names, node) | ('expand', AssignUniqueIdNode)
    steps: List[Tuple]
    agg: Optional[AggregationNode]
    finishers: List[PlanNode]  # OrderBy/TopN/Limit from bottom to top


def _linearize(root: PlanNode) -> _Linear:
    finishers: List[PlanNode] = []
    node = root
    while isinstance(node, (OrderByNode, TopNNode, LimitNode, EnforceSingleRowNode)):
        finishers.append(node)
        node = node.sources[0]
    agg = None
    if isinstance(node, AggregationNode):
        agg = node
        node = node.sources[0]
    steps_rev: List[Tuple] = []
    while isinstance(node, (FilterNode, ProjectNode, HashJoinNode, AssignUniqueIdNode)):
        if isinstance(node, FilterNode):
            steps_rev.append(("filter", node.predicate))
            node = node.sources[0]
        elif isinstance(node, ProjectNode):
            steps_rev.append(("project", node.names, node.exprs, node.output_schema))
            node = node.sources[0]
        elif isinstance(node, AssignUniqueIdNode):
            steps_rev.append(("expand", node))
            node = node.sources[0]
        else:
            if node.join_type in (JoinType.RIGHT, JoinType.RIGHT_SEMI):
                # lower by swapping sides (reference: the planner flips
                # RIGHT to LEFT with probe/build exchanged)
                flipped = {
                    JoinType.RIGHT: JoinType.LEFT,
                    JoinType.RIGHT_SEMI: JoinType.LEFT_SEMI,
                }[node.join_type]
                node = HashJoinNode(
                    node.right,
                    node.left,
                    flipped,
                    node.right_keys,
                    node.left_keys,
                    node.output_columns,
                    node.filter,
                    id=node.id,
                )
            if node.filter is not None and node.join_type in (JoinType.INNER, JoinType.LEFT):
                # an INNER join's non-equi filter is semantically a filter
                # above the join (the reference fuses it in HashProbe; same
                # rows survive either way); a LEFT join's filter nulls the
                # build side of failing matches instead of dropping rows —
                # requires the referenced columns in the join output.  A
                # filter on any other join type stays on the node, and
                # building that join raises.
                if node.join_type == JoinType.INNER:
                    steps_rev.append(("filter", node.filter))
                else:
                    ls, rs = node.left.output_schema, node.right.output_schema
                    build_cols = frozenset(
                        c for c in node.output_columns if c in rs and c not in ls
                    )
                    steps_rev.append(("left_join_filter", node.filter, build_cols, node))
                node = dataclasses.replace(node, filter=None)
            # probe continues down the left (probe) side; the right (build)
            # side is executed when the pipeline is instantiated.
            steps_rev.append(("join", node))
            node = node.left
    # Any other node (Aggregation mid-plan, OrderBy under a join, a second
    # join stage, ...) becomes a pipeline *source*: LocalExecutor
    # materializes it recursively (a pipeline barrier — the reference's
    # equivalent is the LocalPlanner splitting the plan into pipelines at
    # multi-source/blocking nodes, velox/exec/LocalPlanner.cpp:139).
    if isinstance(node, TableScanNode) and node.subfield_filter is not None:
        steps_rev.append(("filter", node.subfield_filter))
    steps = list(reversed(steps_rev))
    finishers.reverse()
    return _Linear(node, steps, agg, finishers)


def _pipeline_sort_keys(steps) -> Tuple[str, ...]:
    """Static walk of resolved pipeline steps: column names the final batch is
    key-ordered by (joins emit key-sorted output; projects track renames)."""
    sorted_by: Tuple[str, ...] = ()
    for step in steps:
        if step[0] == "join":
            node = step[1].node
            out = set(node.output_columns)
            names = []
            for lk, rk in zip(node.left_keys, node.right_keys):
                if lk in out:
                    names.append(lk)
                elif rk in out:  # right key column carries the same values
                    names.append(rk)
                else:
                    break
            sorted_by = tuple(names)
        elif step[0] == "project":
            _, names, exprs, _schema = step
            mapping = {}
            for n, e in zip(names, exprs):
                if isinstance(e, FieldAccess):
                    mapping.setdefault(e.name, n)
            kept = []
            for k in sorted_by:
                if k in mapping:
                    kept.append(mapping[k])
                else:
                    break
            sorted_by = tuple(kept)
        elif step[0] == "expand":
            sorted_by = ()  # cardinality change invalidates ordering info
        # filters preserve order
    return sorted_by


# ---------------------------------------------------------------------------
# Streaming operator application


def apply_streaming(batch: Batch, steps: Sequence[Tuple]):
    """Apply filter / project / join-probe steps; returns (batch,
    error_count_on_live_rows) with the count a 0-d int64 tensor on the batch's
    device.  A join step holds its built HashJoinExec (LocalExecutor resolves
    the plan node into one)."""
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
        elif step[0] == "join":
            batch = step[1].probe(batch)
        elif step[0] == "left_join_filter":
            # LEFT join non-equi condition: matched rows failing the filter
            # become UNMATCHED — probe rows stay, build-side columns null out
            # (reference: HashProbe::applyFilter null-ing misses on LEFT).
            # Unmatched rows evaluate the filter over nulls -> Kleene null ->
            # already-null build columns stay null.
            _, expr, build_cols, _ = step
            [r] = ExprSet([expr]).eval(batch)
            if r.errors is not None:
                err = err + (r.errors & active).sum()
            passed = r.values.to(torch.bool)
            if r.validity is not None:
                passed = passed & r.validity
            new_cols = []
            for name, col in zip(batch.schema.names, batch.columns):
                if name in build_cols:
                    fc = col.flatten(batch.capacity)
                    v = passed if fc.validity is None else (fc.validity & passed)
                    col = Column.flat(fc.data, fc.dtype, v, fc.strings)
                new_cols.append(col)
            batch = dataclasses.replace(batch, columns=tuple(new_cols))
        elif step[0] == "expand":
            # the JAX package's expand steps are unnest, group id and unique
            # id; the first two are not ported (their nodes do not exist here)
            node = step[1]
            offset = (
                batch.row_offset
                if batch.row_offset is not None
                else torch.zeros((), dtype=torch.int64, device=batch.device)
            )
            ids = (node.task_unique_id << 40) | (
                offset + torch.arange(batch.capacity, dtype=torch.int64, device=batch.device)
            )
            batch = batch.with_columns(
                node.output_schema, list(batch.columns) + [Column.flat(ids, node.output_schema.types[-1])]
            )
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
        any_nullable = any(k.nullable for k in self.key_infos)
        if any_nullable:
            # presorted grouping relies on upstream key order, which does not
            # place NULL keys adjacently in general — fall back to the sort
            presorted = False
            self.presorted = False
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
            self.grouping = SortGrouping(self.key_infos, presorted)
            if any_nullable and self.grouping.pack_plan(capacity) is None:
                # unbounded nullable keys: NULL-group identity rides a
                # synthetic null-bitmask key (one extra sort key / carry
                # column); every downstream stage (carry merge, host merge)
                # treats it as an ordinary key
                from ..dtypes import BIGINT

                nullable_names = tuple(k.name for k in self.key_infos if k.nullable)
                self.key_infos.append(
                    KeyInfo(
                        "__nullbits__", BIGINT, None, None,
                        (0, (1 << len(nullable_names)) - 1),
                        nullable=False,
                        null_sources=nullable_names,
                    )
                )
                self.grouping = SortGrouping(self.key_infos, presorted)
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

    # ---- sort mode: per-tile partial groups -------------------------------
    def _payload_and_plan(self, batch: Batch):
        payload: List[torch.Tensor] = []
        plan: List[Tuple[int, bool]] = []  # per agg: (n_args, has_validity)
        for i in range(len(self.aggs)):
            values, validity = self._decode_args(batch, i)
            payload.extend(values)
            if validity is not None:
                payload.append(validity)
            plan.append((len(values), validity is not None))
        return payload, plan

    def _reduce_sorted(self, plan, sorted_keys, sorted_payload, sorted_mask, runs):
        accs_out = []
        pos = 0
        for (n_args, has_validity), agg in zip(plan, self.aggs):
            values = tuple(sorted_payload[pos : pos + n_args])
            pos += n_args
            m = sorted_mask
            if has_validity:
                m = m & sorted_payload[pos].to(torch.bool)
                pos += 1
            accs_out.append(agg.run_reduce(values, m, runs))
        key_arrays = SortGrouping.group_keys(sorted_keys, runs)
        return key_arrays, tuple(accs_out), runs.num_runs

    def tile_partial(self, batch: Batch):
        """Returns (key_arrays, accs_nested, num_groups_scalar)."""
        mask = batch.active_mask()
        payload, plan = self._payload_and_plan(batch)
        (
            sorted_keys,
            sorted_payload,
            sorted_mask,
            runs,
        ) = self.grouping.sort_and_group(batch, payload, mask)
        return self._reduce_sorted(plan, sorted_keys, sorted_payload, sorted_mask, runs)

    # ---- device-resident sorted-carry merge for sort mode ------------------
    #
    # Carry = (key tensors [G], acc tensors [G] per aggregate, live-group
    # count, overflow count).  Each tile's partial groups (sorted runs) are
    # merged into the carry with one sort over [G + capacity] rows + run
    # reductions — all on device, so the host fetches nothing until
    # extraction.  This is the streaming analog of the reference's
    # partial->final aggregation (velox/exec/GroupingSet.cpp).

    def carry_row_bytes(self) -> int:
        """Bytes one carry slot holds: every key and every accumulator."""
        return sum(info.dtype.device_dtype.itemsize for info in self.key_infos) + sum(
            dt.itemsize for agg in self.aggs for dt in agg.acc_dtypes
        )

    def init_sorted_carry(self, G: Optional[int] = None, device=None):
        G = G or self.capacity
        keys = tuple(
            torch.zeros((G,), dtype=info.dtype.device_dtype, device=device)
            for info in self.key_infos
        )
        accs = tuple(agg.acc_init(G, device) for agg in self.aggs)
        count = torch.zeros((), dtype=torch.int32, device=device)
        overflow = torch.zeros((), dtype=torch.int32, device=device)
        return (keys, accs, count, overflow)

    def merge_partial_into_carry(self, carry, partial):
        """Merge one partial-groups tuple into the carry.  The partial's third
        element is either a run-count scalar (slots [0, n) valid) or an
        explicit boolean validity mask.

        With resolvable key bounds the key tuple packs into ONE int64 word
        (ops/sortkey.py) whose low bits hold the row id; otherwise the keys
        sort one after the other, last to first.  Either way the accumulators
        follow through the sort's permutation."""
        from ..ops.segmented import SortedRuns, run_boundaries
        from ..ops.sortkey import sort_operands

        keys_c, accs_c, count, overflow = carry
        tile_keys, tile_accs, liveness = partial
        G = keys_c[0].shape[0]
        cap = tile_keys[0].shape[0]
        dev = keys_c[0].device
        idx_g = torch.arange(G, dtype=torch.int32, device=dev)
        idx_t = torch.arange(cap, dtype=torch.int32, device=dev)
        if liveness.ndim == 0:
            # a partial shrunk to fewer slots than it has runs lost groups
            overflow = overflow + (liveness > cap).to(torch.int32)
            tile_valid = idx_t < liveness
        else:
            tile_valid = liveness
        valid = torch.cat([idx_g < count, tile_valid])
        keys_all = [
            torch.cat([kc, tk.to(kc.dtype)]) for kc, tk in zip(keys_c, tile_keys)
        ]
        flat_accs: List[torch.Tensor] = []
        for acc_c, acc_t in zip(accs_c, tile_accs):
            for a_c, a_t in zip(acc_c, acc_t):
                flat_accs.append(torch.cat([a_c, a_t.to(a_c.dtype)]))
        n = G + cap
        plan = (
            self.grouping.pack_plan(n)
            if isinstance(self.grouping, SortGrouping)
            else None
        )
        if plan is not None:
            idx64 = torch.arange(n, dtype=torch.int64, device=dev)
            packed = plan.pack_with_sentinel(keys_all, ~valid)
            s, perm = torch.sort(packed | idx64, stable=True)
            codes = s >> plan.low_bits
            keys_s = [
                plan.unpack(s, i).to(kv.dtype) for i, kv in enumerate(keys_all)
            ]
            accs_s = [a.index_select(0, perm) for a in flat_accs]
            valid_s = valid.index_select(0, perm)
            diff = codes != torch.roll(codes, 1)
        else:
            n_keys = len(keys_all)
            sorted_ops = sort_operands(
                [~valid] + keys_all + flat_accs + [valid], num_keys=1 + n_keys
            )
            keys_s = sorted_ops[1 : 1 + n_keys]
            accs_s = list(sorted_ops[1 + n_keys : -1])
            valid_s = sorted_ops[-1]
            diff = torch.zeros((n,), dtype=torch.bool, device=dev)
            for kv in keys_s:
                diff = diff | (kv != torch.roll(kv, 1))
        runs = SortedRuns(run_boundaries(diff, valid_s), valid_s)
        new_keys = tuple(runs.first(kv)[:G] for kv in keys_s)
        new_accs = []
        i = 0
        for agg in self.aggs:
            k = len(agg.acc_ops)
            merged = agg.merge_runs(accs_s[i : i + k], valid_s, runs)
            i += k
            new_accs.append(tuple(m[:G] for m in merged))
        new_count = runs.num_runs.clamp(max=G).to(torch.int32)
        overflow = overflow + (runs.num_runs > G).to(torch.int32)
        return (new_keys, tuple(new_accs), new_count, overflow)

    # ---- host-exact final merge for sort mode -----------------------------
    def merge_partials_host(self, key_chunks, acc_chunks):
        """key_chunks: list over tiles of list-per-key numpy arrays;
        acc_chunks: list over tiles of nested accs as numpy arrays."""
        keys = [
            np.concatenate([kc[i] for kc in key_chunks])
            for i in range(len(self.key_infos))
        ]
        accs = []
        for ai, agg in enumerate(self.aggs):
            accs.append(
                tuple(
                    np.concatenate([ac[ai][j] for ac in acc_chunks])
                    for j in range(len(agg.acc_dtypes))
                )
            )
        order = np.lexsort(tuple(reversed(keys)))
        keys = [k[order] for k in keys]
        accs = [tuple(a[order] for a in acc) for acc in accs]
        n = len(keys[0])
        if n == 0:
            starts = np.zeros(0, dtype=np.int64)
        else:
            diff = np.zeros(n, dtype=bool)
            diff[0] = True
            for k in keys:
                diff[1:] |= k[1:] != k[:-1]
            starts = np.flatnonzero(diff)
        group_keys = [k[starts] for k in keys]
        merged = [
            agg.host_merge_sorted(list(acc), starts)
            for agg, acc in zip(self.aggs, accs)
        ]
        return group_keys, merged

    # ---- extraction -------------------------------------------------------
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
        elif self.mode == "sort":
            # sort mode: NULL groups carry either the packed null VALUE
            # (bounds hi + 1) or a bit in the synthetic __nullbits__ key
            nullbits = None
            if (
                self.key_infos[-1].null_sources is not None
                and key_arrays is not None
                and len(key_arrays) == len(self.key_infos)
            ):
                nullbits = np.asarray(key_arrays[-1]).astype(np.int64)
            nb_sources = (
                list(self.key_infos[-1].null_sources) if nullbits is not None else []
            )
            for info, name, arr in zip(self.key_infos, names[:nkeys], key_arrays or []):
                arr = np.asarray(arr)
                valid = None
                if nullbits is not None and info.name in nb_sources:
                    bit = nb_sources.index(info.name)
                    valid = (nullbits >> bit) & 1 == 0
                elif info.nullable and info.bounds is not None:
                    null_v = info.bounds[1] + 1
                    valid = arr.astype(np.int64) != null_v
                if valid is not None and not valid.all():
                    arr = np.where(valid, arr, np.zeros_like(arr))
                    validities[name] = valid
                cols[name] = arr
                if info.strings is not None:
                    tables[name] = info.strings
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
        elif isinstance(node, EnforceSingleRowNode):
            if table.num_rows > 1:
                raise QueryError(
                    f"scalar subquery produced {table.num_rows} rows, expected <= 1"
                )
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

    Construction does the planning once: linearization, the build side of
    every join (executed here, device-resident: the HashJoinBridge analog),
    any other non-scan source (a pipeline barrier, materialized by a
    sub-executor), the aggregation mode and the piece-path decision.
    ``device`` None means the CUDA device and raises when there is none;
    sub-executors run on the parent's device and share its pool.  Error
    counts are carried on the device and checked once at the end (no per-tile
    host sync).
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
        from .joins import (
            DuplicateBuildKeys,
            HashJoinExec,
            rewrite_filtered_existence_joins,
            rewrite_left_filter_nm,
        )
        from .memory import ROOT_POOL

        self.device = resolve_device(device)
        self.config = config or DEFAULT_CONFIG
        # Device-memory accounting: the executor reserves its device-resident
        # state (scan tiles, join builds, aggregation carries) against a
        # per-query pool; sub-executors share the parent's pool.  Reference:
        # velox/common/memory/MemoryPool.h:109 + MemoryArbitrator.h:43.
        self._own_pool = pool is None
        if pool is None:
            pool = ROOT_POOL.add_child(
                f"query.{getattr(root, 'id', 'plan')}",
                limit=self.config.query_memory_limit_bytes,
            )
        self.pool = pool
        root = rewrite_filtered_existence_joins(root)
        self.tile_rows = tile_rows
        self.build_seconds = 0.0
        # (output bucket, rows) of every expansion the build sides and
        # barriers ran while this executor was constructed
        self.build_expansions: List[Tuple[int, int]] = []
        # (tile capacity, rows) of every window pass those ran
        self.window_chunks: List[Tuple[int, int]] = []
        lin = _linearize(root)
        if isinstance(lin.source, (WindowNode, UnionAllNode, MergeExchangeNode)):
            # a window or set-operation source runs first, and the plan above
            # it is rebuilt over its rows, so that what the steps above
            # resolve by provenance (string dictionaries, value bounds,
            # nullability) describes the rows they will see: UNION ALL merges
            # the inputs' dictionaries, a window adds columns
            t0 = time.perf_counter()
            values = ValuesNode(self._materialize_source(lin.source), id=lin.source.id)
            self.build_seconds += time.perf_counter() - t0
            root = _replace_plan_node(root, lin.source, values)
            lin = _linearize(root)
        self.root = root

        resolved: List[Tuple] = []
        for step in lin.steps:
            if step[0] != "join":
                resolved.append(step)
                continue
            t0 = time.perf_counter()
            node = step[1]
            sub = self._sub_executor(node.right)
            # a FULL join's build is the host's: it keeps the null-key rows
            # and the right key columns for the unmatched-build tail
            built = None if node.join_type == JoinType.FULL else sub.run_device()
            exec_ = None
            if built is not None:
                # build data stays in device memory end to end
                try:
                    exec_ = HashJoinExec.build_from_device(node, *built)
                except DuplicateBuildKeys:
                    pass  # N:M build: the host path below constructs the per-key runs
            if exec_ is None:
                exec_ = HashJoinExec.build(node, sub.run(), device=self.device)
            self._absorb(sub)
            self.pool.reserve(exec_.state_bytes())
            self.build_seconds += time.perf_counter() - t0
            resolved.append(("xjoin" if exec_.expansion else "join", exec_))
        for i, step in enumerate(resolved):
            if step[0] == "left_join_filter" and i > 0 and resolved[i - 1][0] == "xjoin":
                # non-equi filter on an N:M LEFT join: the single-candidate
                # null-out path cannot see every match — plan again through
                # the uid / inner / left composition (rewrite_left_filter_nm)
                for done in resolved:
                    if done[0] in ("join", "xjoin"):
                        self.pool.release(done[1].state_bytes())
                orig = step[3]
                new_root = _replace_plan_node(self.root, orig, rewrite_left_filter_nm(orig))
                self.__init__(new_root, tile_rows, config, pool=pool, device=self.device)
                return
        # expansion (N:M) joins split the pipeline into phases: the output
        # row count is data-dependent, so each expansion is sized by one
        # scalar read a tile and materialized into a power-of-two bucket
        # before the steps after it run (_expand_tile)
        self._pre_segments: List[Tuple] = []
        cur: List[Tuple] = []
        for step in resolved:
            if step[0] == "xjoin":
                self._pre_segments.append((tuple(cur), step[1]))
                cur = []
            else:
                cur.append(step)
        lin.steps = cur
        self._all_steps = resolved  # incl. xjoin steps (schema tracking)
        # of the last run: (output bucket, rows) of every expansion, a tile
        # after another
        self.expansions: List[Tuple[int, int]] = []
        self._pending_errs: List[torch.Tensor] = []
        # per FULL join phase, its build rows' matched flags over this run
        self._matched: Dict[int, torch.Tensor] = {}
        if not isinstance(lin.source, (TableScanNode, ValuesNode)):
            # A pipeline barrier: run the subtree and scan its result.
            t0 = time.perf_counter()
            lin.source = ValuesNode(self._run_sub(lin.source), id=lin.source.id)
            self.build_seconds += time.perf_counter() - t0
        self.lin = lin
        self.source_table = lin.source.table.select(
            list(lin.source.output_schema.names)
        )
        self.capacity = _pick_capacity(max(self.source_table.num_rows, 1), tile_rows)
        self.agg_exec: Optional[AggExecutor] = None
        self.use_piece = False
        self._device_sort = None
        self._device_topn = None
        # of the last sorted-carry run: the carry's slot count G (None when a
        # single tile needed no merge) and whether it overflowed into the
        # host merge
        self.carry_groups: Optional[int] = None
        self.carry_overflowed = False
        self.groups_out: Optional[int] = None  # groups before any device TopN

        if lin.agg is not None:
            sort_keys = _pipeline_sort_keys(lin.steps)
            presorted = bool(
                sort_keys
                and lin.agg.grouping_keys
                and sort_keys[0] == lin.agg.grouping_keys[0]
                # single-tile pipelines skip presorted grouping on purpose:
                # a full per-tile sort makes runs EXACT groups, so the
                # single-tile fast path needs NO carry merge at all
                # (presorted runs can split logical groups when secondary
                # keys interleave, forcing the merge)
                and self.source_table.num_tiles(self.capacity) > 1
            )
            # total-row bound for narrow sums: filters/projects and
            # NON-expanding joins of row-preserving kinds cannot grow the
            # row count
            agg_max_rows = (
                self.source_table.num_rows
                if not self._pre_segments and all(_keeps_rowbound(s) for s in lin.steps)
                else None
            )
            ex = AggExecutor(lin.agg, self.capacity, presorted, max_rows=agg_max_rows)
            self.agg_exec = ex
            if ex.mode in ("ungrouped", "array"):
                self.kind = "direct_agg"
                # filter/project steps never compact, so the scan tile stays
                # row-aligned with the aggregation input — the precondition
                # for the piece-sum path (raw narrow columns in, one pass
                # over every scanned byte)
                rows_aligned = not self._pre_segments and all(
                    s[0] in ("filter", "project") for s in lin.steps
                )
                self.use_piece = rows_aligned and ex.try_enable_piece_path()
            elif self.config.device_agg_merge:
                self.kind = "sort_agg_device"
            else:
                self.kind = "sort_agg"
        else:
            self.kind = "collect"
            out_schema = lin.source.output_schema
            for step in self._all_steps:
                if step[0] == "project":
                    out_schema = step[3]
                elif step[0] in ("join", "xjoin"):
                    out_schema = step[1].node.output_schema
                elif step[0] == "expand":
                    out_schema = step[1].output_schema
            self.out_schema = out_schema
            self._plan_device_sort()

    def _absorb(self, sub: "LocalExecutor") -> None:
        """Keep a sub-executor's expansion and window reports."""
        self.build_expansions += sub.build_expansions + sub.expansions
        self.window_chunks += sub.window_chunks

    def _run_sub(self, node: PlanNode) -> Table:
        sub = self._sub_executor(node)
        table = sub.run()
        self._absorb(sub)
        return table

    def _materialize_source(self, node: PlanNode) -> Table:
        """The host Table of a window or set-operation source: a window (one
        device pass a chunk of whole partitions), a UNION ALL (inputs aligned
        by POSITION, SQL set-op semantics, renamed to the first input's
        names) or a MergeExchange (inputs concatenated, then sorted again by
        the device OrderBy, stable, so the order equals the reference's k-way
        merge).  Any other barrier is a sub-executor's run (``_run_sub``)."""
        from .grouped import concat_tables

        if isinstance(node, WindowNode):
            child = self._run_sub(node.source)
            table, chunks = _materialize_window(node, child, self.tile_rows, self.device)
            self.window_chunks += chunks
            return table
        if isinstance(node, UnionAllNode):
            first = node.output_schema
            parts = []
            for s in node.inputs:
                p = self._run_sub(s)
                if list(p.schema.names) != list(first.names):
                    ren = dict(zip(p.schema.names, first.names))
                    p = Table(
                        first,
                        {ren[n]: v for n, v in p.columns.items()},
                        {ren[n]: v for n, v in p.string_tables.items()},
                        {ren[n]: v for n, v in p.validities.items()},
                    )
                parts.append(p)
            return concat_tables(parts)
        merged = concat_tables([self._run_sub(s) for s in node.inputs])
        return self._run_sub(OrderByNode(ValuesNode(merged), node.keys))

    def _sub_executor(self, node: PlanNode) -> "LocalExecutor":
        """An executor for a build side or a barrier: the parent's tile size,
        configuration, pool AND device."""
        return LocalExecutor(
            node, self.tile_rows, self.config, pool=self.pool, device=self.device
        )

    def _plan_device_sort(self):
        """Decide whether the leading OrderBy/TopN finisher runs on device
        (exec/sort.py); host finishers remain the fallback for unresolvable
        VARCHAR keys."""
        from .sort import SortSpec

        lin = self.lin
        if not lin.finishers or not isinstance(
            lin.finishers[0], (OrderByNode, TopNNode)
        ):
            return
        node0 = lin.finishers[0]
        below = node0.sources[0]
        strings_of = {
            k.name: resolve_column_strings(below, k.name) for k in node0.keys
        }
        spec = SortSpec.plan(node0.keys, self.out_schema, strings_of)
        if spec is None:
            return
        if isinstance(node0, TopNNode):
            keep = node0.count
        elif len(lin.finishers) > 1 and isinstance(lin.finishers[1], LimitNode):
            # ORDER BY + LIMIT: a sorted prefix of offset+count rows suffices
            keep = lin.finishers[1].offset + lin.finishers[1].count
        else:
            keep = None  # full device OrderBy
        self._device_sort = (spec, keep)

    # ---- per-tile steps ----------------------------------------------------
    def _tile_step(self, carry, batch: Batch):
        accs_rc, errs = carry
        batch2, err = apply_streaming(batch, self.lin.steps)
        accs_rc = self.agg_exec.update_carry(
            accs_rc, batch2, scan_batch=batch if self.use_piece else None
        )
        return (accs_rc, errs + err)

    def _sort_tile_partial(self, batch: Batch):
        batch2, err = apply_streaming(batch, self.lin.steps)
        return self.agg_exec.tile_partial(batch2), err

    def _tile_out(self, batch: Batch):
        batch2, err = apply_streaming(batch, self.lin.steps)
        return compact(batch2), err

    def _tile_source(self, prefetched_tiles):
        """(iterator of tiles, tile count) for one run; a pipeline with
        expansion joins yields each tile after its expansion phases."""
        if prefetched_tiles is not None:
            if any(t.capacity != self.capacity for t in prefetched_tiles):
                raise ValueError(
                    f"prefetched tiles must have capacity {self.capacity}"
                )
            make, n = (lambda: iter(prefetched_tiles)), len(prefetched_tiles)
        else:
            make = lambda: self.source_table.tiles(self.capacity, self.device)  # noqa: E731
            n = self.source_table.num_tiles(self.capacity)
        if not self._pre_segments:
            return make, n
        return (lambda: self._expanded_tiles(make())), n + len(self._full_joins())

    def _full_joins(self) -> List[int]:
        """Indices of the expansion phases whose join is FULL."""
        return [
            i for i, (_, ex) in enumerate(self._pre_segments)
            if ex.node.join_type == JoinType.FULL
        ]

    def _expanded_tiles(self, tiles):
        self.expansions = []
        self._pending_errs = []
        self._expanded_rows = 0
        self._matched = {i: self._pre_segments[i][1].init_matched() for i in self._full_joins()}
        for tile in tiles:
            yield self._expand_tile(tile)
        # FULL join epilogue: after every real tile has marked its matches,
        # the unmatched build rows enter the pipeline just above their join,
        # so the later steps and the aggregation see them
        for j in sorted(self._matched):
            tail = self._pre_segments[j][1].full_tail(self._matched[j])
            yield self._expand_tile(tail, start=j + 1)

    def _expand_tile(self, batch: Batch, start: int = 0) -> Batch:
        """Run the expansion-join phases from ``start`` on one tile: each
        phase's steps, the spans (a FULL join ORs its build rows' matched
        flags), ONE scalar read of the output row count (it sizes the
        power-of-two output bucket), the expansion.  The expanded batch's
        row offset continues over the run, so unique ids assigned after it
        stay unique across tiles (the JAX package leaves it unset: ids start
        at 0 in every expanded tile)."""
        for i in range(start, len(self._pre_segments)):
            steps, ex = self._pre_segments[i]
            batch, err = apply_streaming(batch, steps)
            self._pending_errs.append(err)
            spans = ex.probe_spans(batch)
            if i in self._matched:
                self._matched[i] = self._matched[i] | spans[4]
            total = int(fetch_tree(spans[3]))
            out_cap = bucket_of(max(total, 1))
            self.expansions.append((out_cap, total))
            batch = ex.expand(batch, spans[:3], out_cap)
            batch = dataclasses.replace(
                batch,
                row_offset=torch.tensor(self._expanded_rows, dtype=torch.int64, device=batch.device),
            )
            self._expanded_rows += total
        return batch

    def _drain_pending_errs(self) -> int:
        """Errors of the steps before the expansion joins, read once."""
        if not self._pending_errs:
            return 0
        total = sum(int(e) for e in fetch_tree(self._pending_errs))
        self._pending_errs = []
        return total

    def run(
        self,
        prefetched_tiles: Optional[List[Batch]] = None,
        stats: Optional[RunStats] = None,
    ) -> Table:
        t_start = time.perf_counter()
        self.groups_out = None
        self.carry_overflowed = False
        make_tiles, n_tiles = self._tile_source(prefetched_tiles)
        if stats is not None:
            stats.tiles = n_tiles
            stats.rows_in = self.source_table.num_rows

        skip_finishers = 0
        if self.kind == "direct_agg":
            ex = self.agg_exec
            carry = (
                ex.init_carry(self.device),
                torch.zeros((), dtype=torch.int64, device=self.device),
            )
            t0 = time.perf_counter()
            for tile in make_tiles():
                carry = self._tile_step(carry, tile)
            # one fetch for the whole final state
            (accs_np, rowcounts_np), errs = fetch_tree(carry)
            if stats is not None:
                stats.device_seconds = time.perf_counter() - t0
            _raise_on_errors(int(errs) + self._drain_pending_errs())
            result = ex.extract(None, accs_np, rowcounts_np)
        elif self.kind == "sort_agg_device":
            result = self._run_sort_agg_device(make_tiles, n_tiles, stats)
        elif self.kind == "sort_agg":
            result = self._run_sort_agg_host(make_tiles, stats)
        elif self._device_sort is not None:
            # OrderBy/TopN executes on device (exec/sort.py); the finisher it
            # implements is consumed here
            result = self._run_collect_sorted(make_tiles, stats)
            skip_finishers = 1
        else:
            result = self._run_collect(make_tiles, stats)
        result = apply_finishers(result, self.lin.finishers[skip_finishers:])
        if stats is not None:
            stats.total_seconds = time.perf_counter() - t_start
        return result

    # ---- sort-mode aggregation, device-resident carry ------------------------
    def _run_sort_agg_device(self, make_tiles, n_tiles: int, stats) -> Table:
        ex = self.agg_exec
        t0 = time.perf_counter()
        tile_iter = make_tiles()
        partial0, err0 = self._sort_tile_partial(next(tile_iter))
        if n_tiles == 1 and not ex.presorted:
            # single tile: the partial IS the final state — no merge
            keys_d, accs_d = partial0[0], partial0[1]
            count_d, errs_d = partial0[2], err0
            overflow_d = torch.zeros((), dtype=torch.int32, device=self.device)
            self.carry_groups = None
        else:
            # adaptive carry size: ~4x tile 0's group count (the reference
            # sizes its hash table adaptively too, HashTable::decideHashMode);
            # undersized carries are detected on device and fall back
            nruns0 = int(fetch_tree(partial0[2]))
            G = min(self.capacity, bucket_of(max(nruns0, 1) * 4))
            self.carry_groups = G
            # device-memory reservation: the carry twice over (the previous
            # state lives while the merge builds the next) plus the merge's
            # working set over G + tile rows: every column before and after
            # the sort, and the permutation
            rows = G + partial0[0][0].shape[0]
            reserve = 2 * G * ex.carry_row_bytes() + rows * (
                2 * (ex.carry_row_bytes() + 8 + 1) + 8
            )
            self.pool.reserve(reserve)

            def shrink(partial):
                keys, accs, nruns = partial
                if keys[0].shape[0] <= G:
                    return partial
                return (
                    tuple(k[:G] for k in keys),
                    tuple(tuple(a[:G] for a in acc) for acc in accs),
                    nruns,
                )

            try:
                state = ex.init_sorted_carry(G, self.device)
                state = ex.merge_partial_into_carry(state, shrink(partial0))
                errs_d = err0
                for tile in tile_iter:
                    partial, err = self._sort_tile_partial(tile)
                    state = ex.merge_partial_into_carry(state, shrink(partial))
                    errs_d = errs_d + err
            finally:
                self.pool.release(reserve)
            keys_d, accs_d, count_d, overflow_d = state
        # fetch the scalars first, then only the live-group prefix
        count, overflow, errs = fetch_tree((count_d, overflow_d, errs_d))
        self.carry_overflowed = bool(overflow)
        if self.carry_overflowed:
            # more distinct groups than carry slots: fall back to the
            # host-merge path, which handles unbounded group counts at the
            # cost of per-tile fetches
            return self._run_sort_agg_host(make_tiles, stats)
        count = int(count)
        self.groups_out = count
        topn = self._device_topn_plan()
        if topn is not None and count > topn[0]:
            # TopN over agg outputs: select the top-K groups ON DEVICE and
            # fetch only K rows (the fetch-result-sized discipline).  The
            # host finisher re-sorts the K rows exactly afterwards.
            keys_d, accs_d = self._device_topn_select(topn, keys_d, accs_d, count)
            count = min(count, topn[0])
        flat = list(keys_d) + [a for acc in accs_d for a in acc]
        fetched = fetch_prefix(flat, count)
        if stats is not None:
            stats.device_seconds = time.perf_counter() - t0
        _raise_on_errors(int(errs) + self._drain_pending_errs())
        nkeys = len(ex.key_infos)
        accs_np = []
        i = nkeys
        for agg in ex.aggs:
            accs_np.append(tuple(fetched[i : i + len(agg.acc_dtypes)]))
            i += len(agg.acc_dtypes)
        return ex.extract(fetched[:nkeys], accs_np)

    # ---- device TopN over aggregation outputs -----------------------------
    def _device_topn_plan(self):
        """(K, plan) if the first finisher is a TopN whose every sort key maps
        to a device-orderable operand (group key, or sum/min/max/count
        accumulator limbs); else None (host path).  plan items:
        ('key', idx, desc, ranks|None) | ('agg', idx, desc)."""
        if self._device_topn is not None:
            return self._device_topn or None
        lin = self.lin
        self._device_topn = False
        if not lin.finishers or not isinstance(lin.finishers[0], TopNNode):
            return None
        ex = self.agg_exec
        node = lin.finishers[0]
        out_names = list(ex.node.output_schema.names)
        nkeys = len(ex.node.grouping_keys)

        def ranks_of(info):
            if info.strings is None:
                return None
            return np.asarray(info.strings.sort_permutation(), np.int32)

        plan: List[Tuple] = []
        for sk in node.keys:
            if sk.name in ex.node.grouping_keys:
                idx = list(ex.node.grouping_keys).index(sk.name)
                plan.append(("key", idx, not sk.ascending, ranks_of(ex.key_infos[idx])))
            elif sk.name in out_names[nkeys:]:
                ai = out_names[nkeys:].index(sk.name)
                if ex.aggs[ai].name not in ("sum", "min", "max", "count"):
                    return None
                plan.append(("agg", ai, not sk.ascending))
            else:
                return None
        # total order: every group key as a tiebreaker
        for idx, info in enumerate(ex.key_infos):
            plan.append(("key", idx, False, ranks_of(info)))
        self._device_topn = (node.count, tuple(plan))
        return self._device_topn

    def _device_topn_select(self, topn, keys_d, accs_d, count: int):
        """The K best of the first ``count`` carry slots, by the TopN's keys:
        order-preserving int64 operands, one stable sort each from the last
        key to the first, then K-row gathers."""
        from ..ops.sortkey import sort_operands
        from .sort import float_to_ordered_i64

        k, plan = topn
        ex = self.agg_exec
        # live groups occupy the first `count` slots: sort those, not the
        # carry's whole capacity
        keys_d = tuple(x[:count] for x in keys_d)
        accs_d = tuple(tuple(a[:count] for a in acc) for acc in accs_d)
        operands: List[torch.Tensor] = []
        for item in plan:
            if item[0] == "key":
                _, i, desc, ranks = item
                arr = keys_d[i]
                if ranks is not None:
                    arr = _take_clamped(torch.as_tensor(ranks, device=arr.device), arr)
                limbs = [arr]
            else:
                _, ai, desc = item
                acc, agg = accs_d[ai], ex.aggs[ai]
                if agg.name == "sum" and len(agg.acc_dtypes) == 3:
                    limbs = [acc[0], acc[1]]  # wide hi, lo
                else:
                    limbs = [acc[0]]
            for limb in limbs:
                code = (
                    float_to_ordered_i64(limb)
                    if limb.dtype.is_floating_point
                    else limb.to(torch.int64)
                )
                operands.append(~code if desc else code)  # ~: overflow-free reversal
        position = torch.arange(count, dtype=torch.int64, device=self.device)
        perm = sort_operands(operands + [position], num_keys=len(operands))[-1][:k]
        return (
            tuple(x.index_select(0, perm) for x in keys_d),
            tuple(tuple(a.index_select(0, perm) for a in acc) for acc in accs_d),
        )

    # ---- sort-mode aggregation, host merge -----------------------------------
    def _run_sort_agg_host(self, make_tiles, stats) -> Table:
        """Host-merge grouped aggregation: unbounded group counts, one fetch
        of the live partial groups a tile (reference:
        GroupingSet::getOutputWithSpill, velox/exec/GroupingSet.cpp:956;
        spilling of the collected partials is not ported yet)."""
        ex = self.agg_exec
        err_total = 0
        key_chunks, acc_chunks = [], []
        t0 = time.perf_counter()
        for tile in make_tiles():
            (key_arrays, accs, ngroups), err = self._sort_tile_partial(tile)
            g, err_i = fetch_tree((ngroups, err))
            err_total += int(err_i)
            flat = list(key_arrays) + [a for acc in accs for a in acc]
            fetched = fetch_prefix(flat, int(g))
            nkeys = len(ex.key_infos)
            accs_np = []
            k = nkeys
            for agg in ex.aggs:
                accs_np.append(tuple(fetched[k : k + len(agg.acc_dtypes)]))
                k += len(agg.acc_dtypes)
            key_chunks.append(fetched[:nkeys])
            acc_chunks.append(accs_np)
        if stats is not None:
            stats.device_seconds = time.perf_counter() - t0
        _raise_on_errors(err_total + self._drain_pending_errs())
        group_keys, merged = ex.merge_partials_host(key_chunks, acc_chunks)
        result = ex.extract(group_keys, merged)
        self.groups_out = result.num_rows
        return result

    # ---- collect pipelines -----------------------------------------------------
    def _result_table(self, arrays, layout, strings) -> Table:
        """Host Table of a collect pipeline from fetched flat arrays."""
        return _host_table(self.out_schema, arrays, layout, strings)

    def _run_collect(self, make_tiles, stats) -> Table:
        """Collect pipeline: every tile's compacted live prefix, fetched after
        the last tile was issued (one read of the lengths and error counts,
        then the prefixes)."""
        from .sort import flatten_columns

        t0 = time.perf_counter()
        outs = [self._tile_out(tile) for tile in make_tiles()]
        lens_errs = fetch_tree([(o.length, e) for o, e in outs])
        # fail BEFORE host assembly
        _raise_on_errors(sum(int(e) for _, e in lens_errs) + self._drain_pending_errs())
        parts = []
        strings: Dict[str, StringTable] = {}
        for (out, _), (n, _) in zip(outs, lens_errs):
            arrays, layout = flatten_columns(out.columns, out.capacity)
            strings.update(_batch_strings(out))
            parts.append(self._result_table(fetch_prefix(arrays, int(n)), layout, strings))
        if stats is not None:
            stats.device_seconds = time.perf_counter() - t0
        return _concat_tables(self.out_schema, parts)

    def _run_collect_sorted(self, make_tiles, stats) -> Table:
        """Collect pipeline whose leading OrderBy/TopN runs on device.

        TopN fetches exactly K rows over the host link (bytes scale with the
        result, not the input); OrderBy fetches the live prefix already
        globally sorted, so the host lexsort finisher disappears.  Reference:
        velox/exec/OrderBy.h:35 / TopN.h:23; design notes in exec/sort.py.
        Spilling sorted runs under memory pressure is not ported yet.
        """
        from .sort import merge_sorted_chunks, tile_sorted_prefix

        spec, keep = self._device_sort
        tile_keep = None if keep is None else bucket_of(max(keep, 1))
        t0 = time.perf_counter()
        chunks, layouts, counts, errs = [], [], [], []
        strings = {}
        for tile in make_tiles():
            batch2, err = apply_streaming(tile, self.lin.steps)
            arrays, layout, count = tile_sorted_prefix(spec, batch2, tile_keep)
            strings.update(_batch_strings(batch2))
            chunks.append(arrays)
            layouts.append(layout)
            counts.append(count)
            errs.append(err)
        chunks, layout = _align_layouts(chunks, layouts)
        if len(chunks) == 1:
            flat, live_d = chunks[0], counts[0]
        else:
            flat, live_d = merge_sorted_chunks(spec, chunks, counts, layout, keep)
        live, errs_np = fetch_tree((live_d, errs))
        n = int(live) if keep is None else min(int(live), keep)
        arrays = fetch_prefix(list(flat), n)
        if stats is not None:
            stats.device_seconds = time.perf_counter() - t0
        _raise_on_errors(sum(int(e) for e in errs_np) + self._drain_pending_errs())
        return self._result_table(arrays, layout, strings)

    def run_device(self):
        """Execute a collect-kind pipeline keeping results device-resident.

        Returns (list of compacted device Batches, tuple of per-tile error
        scalars), or None when the pipeline kind needs host finalization
        (aggregations, finishers) — callers fall back to ``run()`` there.
        """
        if self.kind != "collect" or self.lin.finishers:
            return None
        batches, errs = [], []
        make_tiles, _ = self._tile_source(None)
        for tile in make_tiles():
            out, e = self._tile_out(tile)
            batches.append(out)
            errs.append(e)
        return batches, tuple(errs) + tuple(self._pending_errs)

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


def _keeps_rowbound(step) -> bool:
    """Can this pipeline step only keep or drop rows (never multiply them)?"""
    if step[0] in ("filter", "project", "left_join_filter", "expand"):
        return True
    if step[0] == "join":
        # a "join" step has a unique (or deduplicated) build side; expansion
        # joins are "xjoin" steps
        return step[1].node.join_type in (
            JoinType.INNER, JoinType.LEFT, JoinType.LEFT_SEMI, JoinType.ANTI
        )
    return False


def _replace_plan_node(root: PlanNode, target: PlanNode, replacement: PlanNode) -> PlanNode:
    """Rebuild the plan with ``target`` (by identity or id: _linearize may hand
    back a reconstructed node that kept the tree id) swapped for
    ``replacement``; the nodes above it are re-created."""

    def walk(node: PlanNode) -> PlanNode:
        if node is target or node.id == target.id:
            return replacement
        changed = {}
        for attr in ("source", "left", "right"):
            child = getattr(node, attr, None)
            if isinstance(child, PlanNode):
                new = walk(child)
                if new is not child:
                    changed[attr] = new
        return dataclasses.replace(node, **changed) if changed else node

    return walk(root)


def _batch_strings(batch: Batch) -> Dict[str, StringTable]:
    return {
        name: col.strings
        for name, col in zip(batch.schema.names, batch.columns)
        if col.strings is not None
    }


def _host_widen(arr, dtype) -> np.ndarray:
    """Cast a fetched narrow-on-the-wire array back to the schema's host
    dtype (Column._widen's host-side twin)."""
    if dtype.is_complex or dtype.is_long_decimal:
        return arr
    want = dtype.numpy_dtype
    a = np.asarray(arr)
    return a if a.dtype == want else a.astype(want)


def _concat_tables(schema: RowType, parts: Sequence[Table]) -> Table:
    """Row-wise concatenation of per-tile result Tables (a part without a
    validity array for a column is all-valid there)."""
    cols = {
        n: np.concatenate([p.columns[n] for p in parts]) for n in schema.names
    }
    validities = {}
    for n in schema.names:
        if any(n in p.validities for p in parts):
            validities[n] = np.concatenate(
                [p.validities.get(n, np.ones(p.num_rows, dtype=bool)) for p in parts]
            )
    strings: Dict[str, StringTable] = {}
    for p in parts:
        strings.update(p.string_tables)
    return Table(schema, cols, strings, validities)


def _align_layouts(chunks, layouts):
    """Give every chunk's flat arrays the same layout: a column that carries
    a validity in any chunk gets an all-valid one where it has none.  (A FULL
    join's tail tile carries NULL probe columns that the other tiles hold
    without a validity; the JAX package concatenates such chunks as they
    are, and its rows then come out misaligned.)"""
    union = [any(col) for col in zip(*layouts)]
    out = []
    for arrays, layout in zip(chunks, layouts):
        if list(layout) == union:
            out.append(arrays)
            continue
        fixed, k = [], 0
        for has, want in zip(layout, union):
            data = arrays[k]
            fixed.append(data)
            k += 1
            if has:
                fixed.append(arrays[k])
                k += 1
            elif want:
                fixed.append(torch.ones(data.shape, dtype=torch.bool, device=data.device))
        out.append(fixed)
    return out, union


def _host_table(schema: RowType, arrays, layout, strings) -> Table:
    """Host Table from fetched flat arrays (per column its data, then its
    validity where the layout says so; an all-valid validity is dropped)."""
    cols: Dict[str, np.ndarray] = {}
    validities: Dict[str, np.ndarray] = {}
    k = 0
    for name, dtype, has_validity in zip(schema.names, schema.types, layout):
        cols[name] = _host_widen(arrays[k], dtype)
        k += 1
        if has_validity:
            if not arrays[k].all():
                validities[name] = arrays[k]
            k += 1
    return Table(schema, cols, dict(strings), validities)


def _window_one_tile(wnode, child: Table, capacity: int, device) -> Table:
    """Run a WindowNode over one host Table slice as one device pass: upload
    one tile, sort, compute, compact, fetch the live prefix."""
    from .sort import flatten_columns
    from .window import WindowExec

    batch = child.tile(0, capacity, device)
    out = compact(WindowExec(wnode, capacity).apply(batch))
    arrays, layout = flatten_columns(out.columns, out.capacity)
    n = int(fetch_tree(out.length))
    return _host_table(wnode.output_schema, fetch_prefix(arrays, n), layout, _batch_strings(out))


def _materialize_window(wnode, child: Table, tile_rows: int, device):
    """Execute a WindowNode over its child's host Table; returns (Table,
    [(tile capacity, rows) of every device pass]).

    Window functions never cross partitions, so an input larger than one
    tile splits into chunks of WHOLE partitions (greedy packing after a host
    sort by the partition keys) and each chunk runs as one device pass — the
    analog of the reference's SortWindowBuild emitting one partition batch
    at a time (velox/exec/WindowBuild.h).  A partition larger than a tile,
    and a window without partition keys, gets a pass sized to fit.  The JAX
    package spills finished chunks to disk past a threshold; spilling is not
    ported (it comes with the memory and spill slice)."""
    from .grouped import concat_tables

    rows = child.num_rows
    if rows <= tile_rows or not wnode.partition_keys:
        cap = _pick_capacity(max(rows, 1), 1 << 62)
        return _window_one_tile(wnode, child, cap, device), [(cap, rows)]
    # group whole partitions: host sort by partition keys (rank-ordered)
    order = _sort_indices(child, [SortKey(k) for k in wnode.partition_keys])
    sorted_t = _table_slice(child, order)
    diff = np.zeros(rows, dtype=bool)
    diff[0] = True
    for k in wnode.partition_keys:
        key = np.asarray(sorted_t.columns[k])
        diff[1:] |= key[1:] != key[:-1]
    starts = np.flatnonzero(diff)
    sizes = np.diff(np.append(starts, rows))
    chunks: List[Tuple[int, int]] = []
    cur_start, cur_rows = 0, 0
    for st, sz in zip(starts, sizes):
        if cur_rows and cur_rows + int(sz) > tile_rows:
            chunks.append((cur_start, int(st)))
            cur_start, cur_rows = int(st), 0
        cur_rows += int(sz)
    chunks.append((cur_start, rows))
    parts, passes = [], []
    for a, b in chunks:
        cap = _pick_capacity(b - a, 1 << 62)
        parts.append(_window_one_tile(wnode, _table_slice(sorted_t, slice(a, b)), cap, device))
        passes.append((cap, b - a))
    return concat_tables(parts), passes


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
