"""Fluent plan construction.

Counterpart of the JAX package's ``plan/builder.py``.  Reference:
velox/exec/tests/utils/PlanBuilder.h:77 — the same ergonomics: SQL strings for
expressions, method chaining for operators, automatic projection of aggregate
arguments, automatic string-literal binding against scan dictionaries.

Ported so far: ``table_scan``, ``values``, ``filter``, ``project``,
``aggregation`` (plain aggregates), ``hash_join``, ``orderby``, ``topn``,
``limit``, ``build``.  Every other method of the reference's class raises
``NotImplementedError`` naming the slice that brings it.
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
    FilterNode,
    HashJoinNode,
    JoinType,
    LimitNode,
    OrderByNode,
    PlanNode,
    ProjectNode,
    SortKey,
    TableScanNode,
    TopNNode,
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
        """aggregates: 'sum(expr) as name' strings.  Non-field arguments are
        auto-projected first (the reference PlanBuilder does the same).
        Distinct aggregates, approx_distinct, approx_most_frequent and
        reduce_agg lower onto joins, windows or sketches and are not ported
        yet."""
        step = AggregationStep(step)
        parsed = []  # (fn, [arg texts], name)
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
            if (
                fn in ("approx_distinct", "approx_most_frequent", "reduce_agg")
                or argtext.lower().startswith("distinct ")
            ):
                raise NotImplementedError(
                    f"aggregate {item!r}: distinct and sketch aggregates are "
                    "not ported yet; they come with the remaining TPC-H plans "
                    "and the sketch slice"
                )
            if fn == "count" and argtext in ("*", ""):
                args: List[str] = []
            else:
                args = _split_call_args(argtext)
            parsed.append((fn, args, name))
        return self._plain_aggregation(grouping_keys, parsed, step)

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

    # ---- later slices ----------------------------------------------------
    cross_join = _later("cross_join", "expansion joins")
    nested_loop_join = _later("nested_loop_join", "expansion joins")
    union_all = _later("union_all", "remaining TPC-H plans")
    merge_exchange = _later("merge_exchange", "remaining TPC-H plans")
    window = _later("window", "window")
    row_number = _later("row_number", "window")
    topn_row_number = _later("topn_row_number", "window")
    mark_distinct = _later("mark_distinct", "window")
    enforce_single_row = _later("enforce_single_row", "remaining TPC-H plans")
    unnest = _later("unnest", "complex types")
    group_id = _later("group_id", "complex types")
    assign_unique_id = _later("assign_unique_id", "complex types")
    arrow_stream = _later("arrow_stream", "file formats")
    table_write = _later("table_write", "file formats")
