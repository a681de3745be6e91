"""Fluent plan construction.

Counterpart of the JAX package's ``plan/builder.py``.  Reference:
velox/exec/tests/utils/PlanBuilder.h:77 — the same ergonomics: SQL strings for
expressions, method chaining for operators, automatic projection of aggregate
arguments, automatic string-literal binding against scan dictionaries.

Ported so far: ``table_scan``, ``values``, ``filter``, ``project``,
``aggregation`` (plain aggregates and ``count(distinct x)``), ``hash_join``
(every join type), ``cross_join``, ``nested_loop_join``, ``union_all``,
``merge_exchange``, ``window``, ``row_number``, ``topn_row_number``,
``mark_distinct``, ``assign_unique_id``, ``enforce_single_row``, ``orderby``,
``topn``, ``limit``, ``build``.  ``unnest`` and ``group_id`` (complex types),
``arrow_stream`` and ``table_write`` (file formats) raise
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Union

from ..dtypes import RowType
from ..expr.binding import bind_string_literals
from ..expr.ir import Call, Expr, FieldAccess
from ..expr.parser import parse_expr
from ..io.table import Table
from .nodes import (
    AggregationNode,
    AggregationStep,
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

_AS_RE = re.compile(r"^(?P<expr>.*?)\s+as\s+(?P<name>[A-Za-z_][A-Za-z_0-9]*)\s*$", re.IGNORECASE | re.DOTALL)
_AGG_RE = re.compile(r"^\s*(?P<fn>[A-Za-z_][A-Za-z_0-9]*)\s*\((?P<arg>.*)\)\s*$", re.DOTALL)


def _split_call_args(text):
    """Split a call's argument text on top-level commas ('' -> [])."""
    if not text.strip():
        return []
    out, depth, start, quote = [], 0, 0, None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append(text[start:i].strip())
            start = i + 1
    out.append(text[start:].strip())
    return out


def _later(method: str, slice_name: str):
    def raiser(self, *args, **kwargs):
        raise NotImplementedError(
            f"PlanBuilder.{method} is not ported yet; it comes with the "
            f"{slice_name} slice"
        )

    raiser.__name__ = method
    return raiser


class PlanBuilder:
    def __init__(self, node: Optional[PlanNode] = None):
        self.node = node

    # ---- helpers -------------------------------------------------------
    @property
    def schema(self) -> RowType:
        return self.node.output_schema

    def _parse(self, sql: str, schema: Optional[RowType] = None) -> Expr:
        schema = schema or self.schema
        expr = parse_expr(sql, schema)
        # always bind: besides interning string literals against dictionaries,
        # this dispatches unit-literal calls even when the plan has no string
        # columns at all
        return bind_string_literals(expr, self._string_tables())

    def _string_tables(self) -> dict:
        """String tables visible to expressions at this point of the plan.

        Current-schema VARCHAR columns resolve through their provenance (so
        renamed / substr-derived columns bind correctly); scan-leaf tables are
        added by original name.
        """
        out = {}
        if self.node is None:
            return out
        from ..exec.runner import resolve_column_strings

        schema = self.node.output_schema
        for name, t in zip(schema.names, schema.types):
            if t.is_string:
                tab = resolve_column_strings(self.node, name)
                if tab is not None:
                    out[name] = tab

        def walk(node: PlanNode):
            for s in node.sources:
                walk(s)
            if isinstance(node, (TableScanNode, ValuesNode)):
                for k, v in node.table.string_tables.items():
                    out.setdefault(k, v)

        walk(self.node)
        return out

    # ---- sources -------------------------------------------------------
    def table_scan(
        self,
        table: Table,
        columns: Optional[Sequence[str]] = None,
        filter: Optional[str] = None,
    ) -> "PlanBuilder":
        assert self.node is None, "table_scan must be the leaf"
        columns = tuple(columns) if columns else tuple(table.schema.names)
        node = TableScanNode(table, columns)
        self.node = node
        if filter:
            node.subfield_filter = self._parse(filter, node.output_schema)
        return self

    def values(self, table: Table) -> "PlanBuilder":
        assert self.node is None
        self.node = ValuesNode(table)
        return self

    # ---- operators -----------------------------------------------------
    def filter(self, sql: str) -> "PlanBuilder":
        self.node = FilterNode(self.node, self._parse(sql))
        return self

    def project(self, exprs: Sequence[str]) -> "PlanBuilder":
        names, parsed = [], []
        for i, item in enumerate(exprs):
            m = _AS_RE.match(item)
            if m:
                text, name = m.group("expr"), m.group("name")
            else:
                text = item
                name = item if re.fullmatch(r"[A-Za-z_][A-Za-z_0-9]*", item.strip()) else f"p{i}"
                name = name.strip()
            names.append(name)
            parsed.append(self._parse(text))
        self.node = ProjectNode(self.node, tuple(names), tuple(parsed))
        return self

    def aggregation(
        self,
        grouping_keys: Sequence[str],
        aggregates: Sequence[str],
        step: Union[str, AggregationStep] = AggregationStep.SINGLE,
    ) -> "PlanBuilder":
        """aggregates: 'sum(expr) as name' strings ('count(distinct x)'
        supported).  Non-field arguments are auto-projected first (the
        reference PlanBuilder does the same); distinct aggregates rewrite into
        a dedupe aggregation feeding a count (the physical plan the
        reference's planner also emits).  approx_distinct,
        approx_most_frequent and reduce_agg lower onto sketches and windows
        and are not ported yet."""
        step = AggregationStep(step)
        parsed = []  # (fn, [arg texts], name, is_distinct)
        for i, item in enumerate(aggregates):
            m = _AS_RE.match(item)
            if m:
                body, name = m.group("expr"), m.group("name")
            else:
                body, name = item, f"a{i}"
            call_m = _AGG_RE.match(body)
            if not call_m:
                raise ValueError(f"cannot parse aggregate {item!r}")
            fn = call_m.group("fn").lower()
            argtext = call_m.group("arg").strip()
            if fn in ("approx_distinct", "approx_most_frequent", "reduce_agg"):
                raise NotImplementedError(
                    f"aggregate {item!r}: sketch aggregates are not ported "
                    "yet; they come with the sketch slice"
                )
            distinct = False
            if argtext.lower().startswith("distinct "):
                distinct = True
                argtext = argtext[len("distinct "):].strip()
            if fn == "count" and argtext in ("*", "") and not distinct:
                args: List[str] = []
            else:
                args = _split_call_args(argtext)
            parsed.append((fn, args, name, distinct))
        if any(d for _, _, _, d in parsed):
            return self._aggregation_with_distinct(grouping_keys, parsed, step)
        return self._plain_aggregation(
            grouping_keys, [(f, a, n) for f, a, n, _ in parsed], step
        )

    def _plain_aggregation(self, grouping_keys, items, step) -> "PlanBuilder":
        """items: (fn, [arg texts], output name)."""
        arg_lists: List[List[Expr]] = [
            [self._parse(a) for a in args] for _, args, _ in items
        ]
        need_project = any(
            not isinstance(e, FieldAccess) for exprs in arg_lists for e in exprs
        )
        key_fields = [FieldAccess(self.schema.type_of(k), k) for k in grouping_keys]
        if need_project:
            names = list(grouping_keys)
            exprs: List[Expr] = list(key_fields)
            new_lists: List[List[str]] = []
            for i, arg_exprs in enumerate(arg_lists):
                out_names = []
                for j, e in enumerate(arg_exprs):
                    if isinstance(e, FieldAccess):
                        if e.name not in names:
                            names.append(e.name)
                            exprs.append(e)
                        out_names.append(e.name)
                    else:
                        nm = f"_a{i}_{j}"
                        names.append(nm)
                        exprs.append(e)
                        out_names.append(nm)
                new_lists.append(out_names)
            self.node = ProjectNode(self.node, tuple(names), tuple(exprs))
            arg_lists = [
                [FieldAccess(self.schema.type_of(n), n) for n in out_names]
                for out_names in new_lists
            ]

        from ..exec.aggregates import bind_aggregate

        calls = []
        for (fn, _, _), arg_exprs in zip(items, arg_lists):
            arg_ts = tuple(e.dtype for e in arg_exprs) or None
            bound = bind_aggregate(fn, arg_ts, None)
            calls.append(Call(bound.result_type, fn, tuple(arg_exprs)))
        self.node = AggregationNode(
            self.node,
            step,
            tuple(grouping_keys),
            tuple(n for _, _, n in items),
            tuple(calls),
        )
        return self

    def _aggregation_with_distinct(self, grouping_keys, parsed, step) -> "PlanBuilder":
        """Split distinct and plain aggregates into separate aggregations over
        the same subtree and join the parts back on the grouping keys (an
        all-constant key when there are none)."""
        keys = list(grouping_keys)
        base = self.node
        regular = [(f, a, n) for f, a, n, d in parsed if not d]
        distincts = [(f, a, n) for f, a, n, d in parsed if d]
        parts: List[PlanBuilder] = []
        if regular:
            parts.append(PlanBuilder(base)._plain_aggregation(keys, regular, step))
        for fn, args, name in distincts:
            if fn != "count":
                raise NotImplementedError(
                    f"distinct is only supported for count, not {fn}"
                )
            if len(args) != 1:
                raise ValueError("count(distinct ...) takes one argument")
            pb = PlanBuilder(base)
            tmp = f"_d_{name}"
            pb.project(list(keys) + [f"{args[0]} as {tmp}"])
            pb._plain_aggregation(keys + [tmp], [("count", [], "_c")], step)
            pb._plain_aggregation(keys, [("count", [], name)], step)
            parts.append(pb)

        join_keys = keys
        if not keys:
            # single-row parts: join on a constant key
            join_keys = ["_one"]
            for pb in parts:
                cols = list(pb.schema.names)
                pb.project(cols + ["1 as _one"])
        else:
            # NULL-safe join keys: a NULL grouping key forms one group (SQL
            # semantics), but join keys with NULL never match — so each part
            # projects per key an is-null flag plus a zero-coalesced value
            # and the parts re-join on those (reference: GroupingSet NULL-key
            # handling, velox/exec/GroupingSet.cpp).
            join_keys = []
            for j, k in enumerate(keys):
                join_keys += [f"_nj{j}", f"_vj{j}"]
            for pb in parts:
                s = pb.schema
                texts = list(s.names)
                for j, k in enumerate(keys):
                    kt = s.type_of(k)
                    texts.append(f"cast({k} is null as bigint) as _nj{j}")
                    # any in-domain default works: the is-null flag
                    # disambiguates a real default from a coalesced NULL.
                    # project() binds the string literal through the
                    # column's dictionary
                    default = "''" if kt.is_string else "0"
                    texts.append(f"coalesce({k}, {default}) as _vj{j}")
                pb.project(texts)
        result = parts[0]
        for pb in parts[1:]:
            build_cols = [
                n for n in pb.schema.names
                if n not in join_keys and n not in result.schema.names
            ]
            result.hash_join(
                pb, join_keys, join_keys,
                output=list(result.schema.names) + build_cols,
            )
        out_names = list(grouping_keys) + [n for _, _, n, _ in parsed]
        result.project(out_names)
        self.node = result.node
        return self

    def assign_unique_id(
        self, name: str = "unique_id", task_unique_id: int = 0
    ) -> "PlanBuilder":
        self.node = AssignUniqueIdNode(self.node, name, task_unique_id)
        return self

    def enforce_single_row(self) -> "PlanBuilder":
        """Reference: core::EnforceSingleRowNode."""
        self.node = EnforceSingleRowNode(self.node)
        return self

    def cross_join(
        self,
        right: Union["PlanBuilder", PlanNode],
        output: Sequence[str],
        filter: Optional[str] = None,
    ) -> "PlanBuilder":
        """Cartesian product (reference: core::NestedLoopJoinNode +
        exec/NestedLoopJoinProbe.cpp).  Lowered onto the expansion hash join
        with a constant key on both sides — every probe row matches the whole
        build side, which is exactly the nested-loop product; an optional
        filter lands above (the reference's join condition)."""
        right_node = right.node if isinstance(right, PlanBuilder) else right
        rb = PlanBuilder(right_node).project(
            list(right_node.output_schema.names) + ["1 as __xk_r"]
        )
        self.project(list(self.schema.names) + ["1 as __xk_l"])
        self.hash_join(rb, ["__xk_l"], ["__xk_r"], output=list(output))
        if filter:
            self.filter(filter)
        return self

    def _sort_keys(self, keys: Sequence[str]):
        out = []
        for k in keys:
            parts = k.split()
            name = parts[0]
            ascending = True
            nulls_first = False
            rest = [p.lower() for p in parts[1:]]
            if "desc" in rest:
                ascending = False
            if rest[-2:] == ["nulls", "first"]:
                nulls_first = True
            if name not in self.schema:
                raise KeyError(f"sort key {name!r} not in {self.schema}")
            out.append(SortKey(name, ascending, nulls_first))
        return tuple(out)

    def orderby(self, keys: Sequence[str]) -> "PlanBuilder":
        self.node = OrderByNode(self.node, self._sort_keys(keys))
        return self

    def topn(self, keys: Sequence[str], count: int) -> "PlanBuilder":
        self.node = TopNNode(self.node, self._sort_keys(keys), count)
        return self

    def limit(self, count: int, offset: int = 0) -> "PlanBuilder":
        self.node = LimitNode(self.node, offset, count)
        return self

    def hash_join(
        self,
        right: Union["PlanBuilder", PlanNode],
        left_keys: Sequence[str],
        right_keys: Sequence[str],
        output: Sequence[str],
        join_type: Union[str, JoinType] = JoinType.INNER,
        filter: Optional[str] = None,
        null_aware: bool = False,
    ) -> "PlanBuilder":
        right_node = right.node if isinstance(right, PlanBuilder) else right
        node = HashJoinNode(
            self.node,
            right_node,
            JoinType(join_type),
            tuple(left_keys),
            tuple(right_keys),
            tuple(output),
            null_aware=null_aware,
        )
        if filter:
            combined = RowType(
                list(self.schema.names) + list(right_node.output_schema.names),
                list(self.schema.types) + list(right_node.output_schema.types),
            )
            # bind string literals against BOTH sides' dictionaries (the
            # filter evaluates over probe ++ build columns)
            tables = PlanBuilder(self.node)._string_tables()
            tables.update(PlanBuilder(right_node)._string_tables())
            node.filter = bind_string_literals(parse_expr(filter, combined), tables)
        self.node = node
        return self

    def build(self) -> PlanNode:
        return self.node

    def nested_loop_join(
        self,
        right: Union["PlanBuilder", PlanNode],
        output: Sequence[str],
        join_type: Union[str, JoinType] = JoinType.INNER,
        condition: Optional[str] = None,
    ) -> "PlanBuilder":
        """General nested-loop join: any (non-equi) condition, any of
        INNER / LEFT / RIGHT / FULL (reference: core::NestedLoopJoinNode,
        exec/NestedLoopJoinProbe.cpp:23).

        Lowered as in the JAX package: the Cartesian pairing rides the
        expansion hash join with a constant key on both sides, and the
        condition becomes the join filter, so the filtered-join lowerings keep
        LEFT / FULL unmatched rows with NULL build columns.  RIGHT flips to
        LEFT.  The product is materialized a tile at a time."""
        jt = JoinType(join_type)
        right_node = right.node if isinstance(right, PlanBuilder) else right
        if jt == JoinType.RIGHT:
            # flip: probe the current side's rows from the right
            return PlanBuilder(right_node).nested_loop_join(
                self.node, output, JoinType.LEFT, condition
            )._steal(self)
        rb = PlanBuilder(right_node).project(
            list(right_node.output_schema.names) + ["1 as __xk_r"]
        )
        self.project(list(self.schema.names) + ["1 as __xk_l"])
        return self.hash_join(
            rb, ["__xk_l"], ["__xk_r"], output=list(output), join_type=jt,
            filter=condition,
        )

    def _steal(self, other: "PlanBuilder") -> "PlanBuilder":
        """Move this builder's node into ``other`` (RIGHT-join flips)."""
        other.node = self.node
        return other

    def union_all(self, inputs: Sequence[Union["PlanBuilder", PlanNode]]) -> "PlanBuilder":
        """Row-concatenation of same-typed inputs (SQL UNION ALL; reference:
        the LocalPartition round-robin lowering).  A source: the builder must
        be empty."""
        if self.node is not None:
            raise ValueError("union_all is a source")
        self.node = UnionAllNode(
            tuple(i.node if isinstance(i, PlanBuilder) else i for i in inputs)
        )
        return self

    def merge_exchange(
        self,
        inputs: Sequence[Union["PlanBuilder", PlanNode]],
        keys: Sequence[str],
    ) -> "PlanBuilder":
        """Sorted merge of already-sorted inputs (core::MergeExchangeNode).
        A source: the builder must be empty."""
        if self.node is not None:
            raise ValueError("merge_exchange is a source")
        nodes = tuple(i.node if isinstance(i, PlanBuilder) else i for i in inputs)
        self.node = nodes[0]  # resolve sort keys against the input schema
        self.node = MergeExchangeNode(nodes, self._sort_keys(keys))
        return self

    def window(
        self,
        partition_keys: Sequence[str],
        order_keys: Sequence[str],
        calls: Sequence[str],
    ) -> "PlanBuilder":
        """calls: 'rank() as r' / 'sum(x) as s' / 'lag(x, 2) as prev'."""
        from ..exec.window import WindowNode, parse_window_call

        parsed, names = [], []
        for i, item in enumerate(calls):
            m = _AS_RE.match(item)
            if m:
                body, name = m.group("expr"), m.group("name")
            else:
                body, name = item, f"w{i}"
            parsed.append(parse_window_call(body))
            names.append(name)
        self.node = WindowNode(
            self.node,
            tuple(partition_keys),
            self._sort_keys(order_keys),
            tuple(parsed),
            tuple(names),
        )
        return self

    def row_number(
        self,
        partition_keys: Sequence[str],
        name: str = "row_number",
        limit: Optional[int] = None,
    ) -> "PlanBuilder":
        """Reference: core::RowNumberNode — row numbers per partition in
        arbitrary order, with an optional per-partition limit."""
        self.window(partition_keys, [], [f"row_number() as {name}"])
        if limit is not None:
            self.filter(f"{name} <= {limit}")
        return self

    def topn_row_number(
        self,
        partition_keys: Sequence[str],
        order_keys: Sequence[str],
        count: int,
        name: str = "row_number",
    ) -> "PlanBuilder":
        """Reference: core::TopNRowNumberNode — keep the top ``count`` rows of
        each partition by the given order."""
        self.window(partition_keys, order_keys, [f"row_number() as {name}"])
        return self.filter(f"{name} <= {count}")

    def mark_distinct(self, marker: str, keys: Sequence[str]) -> "PlanBuilder":
        """Reference: core::MarkDistinctNode — a boolean column that is True
        for the first occurrence of each distinct key combination."""
        tmp = f"_{marker}_rn"
        self.window(list(keys), [], [f"row_number() as {tmp}"])
        cols = [n for n in self.schema.names if n != tmp]
        return self.project(cols + [f"{tmp} = 1 as {marker}"])

    # ---- later slices ----------------------------------------------------
    unnest = _later("unnest", "complex types")
    group_id = _later("group_id", "complex types")
    arrow_stream = _later("arrow_stream", "file formats")
    table_write = _later("table_write", "file formats")
