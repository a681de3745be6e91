"""Fluent plan construction.

Counterpart of the JAX package's ``plan/builder.py``.  Reference:
velox/exec/tests/utils/PlanBuilder.h:77 — the same ergonomics: SQL strings for
expressions, method chaining for operators, automatic projection of aggregate
arguments, automatic string-literal binding against scan dictionaries.

Ported: ``table_scan``, ``values``, ``arrow_stream``, ``filter``,
``project``, ``aggregation`` (plain aggregates and ``count(distinct x)``),
``hash_join`` (every join type), ``cross_join``, ``nested_loop_join``,
``union_all``, ``merge_exchange``, ``window``, ``row_number``,
``topn_row_number``, ``mark_distinct``, ``unnest``, ``group_id``,
``assign_unique_id``, ``enforce_single_row``, ``orderby``, ``topn``,
``limit``, ``table_write``, ``build``.
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
    ArrowStreamNode,
    AssignUniqueIdNode,
    EnforceSingleRowNode,
    FilterNode,
    GroupIdNode,
    HashJoinNode,
    JoinType,
    LimitNode,
    MergeExchangeNode,
    OrderByNode,
    PlanNode,
    ProjectNode,
    SortKey,
    TableScanNode,
    TableWriteNode,
    TopNNode,
    UnionAllNode,
    UnnestNode,
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
        added by original name for columns referenced through pending joins.
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
                # ARRAY/MAP columns: expose the child string dictionary (MAP
                # keys first) so literals in element_at(m, 'k') etc. bind
                for k, t in zip(node.table.schema.names, node.table.schema.types):
                    if t.is_complex:
                        seg = node.table.columns.get(k)
                        for tab in getattr(seg, "string_tables", ()) or ():
                            if tab is not None:
                                out.setdefault(k, tab)
                                break

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

    def arrow_stream(self, reader) -> "PlanBuilder":
        """Arrow RecordBatchReader / batch-iterable source (core::ArrowStreamNode)."""
        assert self.node is None
        self.node = ArrowStreamNode(reader)
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
        reference's planner also emits).  approx_most_frequent and reduce_agg
        lower onto windows and collect aggregates, as in the JAX package.  A
        lone approx_distinct stays a call for the executor's sketch rewrite
        (exec/sketch.py); beside other aggregates it becomes an exact
        distinct count, as in the JAX package."""
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
            distinct = False
            if fn == "approx_distinct":
                argtext = _split_call_args(argtext)[0]  # ignore max-error arg
                if len(aggregates) != 1:
                    # a lone approx_distinct stays a real call: the executor
                    # lowers it to the bounded-state HLL sketch
                    # (exec/sketch.py); in a mixed node it becomes an exact
                    # distinct count, as in the JAX package
                    distinct, fn = True, "count"
            elif argtext.lower().startswith("distinct "):
                distinct = True
                argtext = argtext[len("distinct "):].strip()
            if fn == "count" and argtext in ("*", "") and not distinct:
                args: List[str] = []
            else:
                args = _split_call_args(argtext)
            parsed.append((fn, args, name, distinct))

        if (
            len(parsed) == 1
            and parsed[0][0] == "approx_most_frequent"
            and re.fullmatch(
                r"[A-Za-z_][A-Za-z_0-9]*", parsed[0][1][1].strip()
            )
        ):
            # bounded-state lowering (reference:
            # ApproxMostFrequentStreamSummary.h): exact per-(group, value)
            # counts through the grouped aggregation, then a windowed top-k
            # cut so only groups x buckets rows reach the host map assembly
            # — tighter than the reference's sketch (results are exact)
            fn, args, name, _ = parsed[0]
            buckets = int(args[0])
            v = args[1].strip()
            keys = list(grouping_keys)
            self.filter(f"{v} is not null")
            self._plain_aggregation(keys + [v], [("count", [], "__mf_c")], step)
            self.topn_row_number(
                keys, ["__mf_c desc", v], buckets, name="__mf_rn"
            )
            self.project(keys + [v, "__mf_c"])
            return self._plain_aggregation(
                keys, [("map_agg", [v, "__mf_c"], name)], step
            )

        reduce_aggs = [
            (i, args, name)
            for i, (f, args, name, _) in enumerate(parsed)
            if f == "reduce_agg"
        ]
        if reduce_aggs:
            # reduce_agg(x, s0, input_fn, combine_fn) lowers to
            # array_agg(x) + reduce(...) above the aggregation: a sequential
            # fold with the input function computes the same state as the
            # reference's pairwise combine, because reduce_agg's contract
            # requires commutative/associative functions
            # (reference: prestosql/aggregates/ReduceAgg.cpp).
            rewritten = []
            post: List[tuple] = []  # (output name, reduce expr text, tmp name)
            for i, (f, args, name, d) in enumerate(parsed):
                if f != "reduce_agg":
                    rewritten.append((f, args, name, d))
                    continue
                assert len(args) >= 3, "reduce_agg(x, s0, input_fn[, combine_fn])"
                tmp = f"__ra{i}"
                rewritten.append(("array_agg", [args[0]], tmp, False))
                post.append(
                    (name, f"reduce({tmp}, {args[1]}, {args[2]}, s -> s)")
                )
            self.aggregation(
                grouping_keys,
                [
                    f"{f}({', '.join(a) if a else '*'}) as {n}"
                    for f, a, n, _ in rewritten
                ],
                step,
            )
            keep = [
                n for n in self.schema.names if not n.startswith("__ra")
            ]
            exprs = list(keep) + [f"{text} as {name}" for name, text in post]
            return self.project(exprs)

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

    def unnest(
        self,
        replicate: Sequence[str],
        unnest: Sequence[str],
        ordinality: Optional[str] = None,
    ) -> "PlanBuilder":
        """Reference: core::UnnestNode — one row per element of the ``unnest``
        ARRAY / MAP columns (zipped to the longest), ``replicate`` columns
        repeated, an optional 1-based ordinality column."""
        self.node = UnnestNode(
            self.node, tuple(replicate), tuple(unnest), ordinality_name=ordinality
        )
        return self

    def group_id(
        self,
        grouping_sets: Sequence[Sequence[str]],
        agg_inputs: Sequence[str],
        name: str = "group_id",
    ) -> "PlanBuilder":
        """Reference: core::GroupIdNode — the input once per grouping set,
        keys outside the set NULL, plus a BIGINT set id."""
        self.node = GroupIdNode(
            self.node,
            tuple(tuple(s) for s in grouping_sets),
            tuple(agg_inputs),
            name,
        )
        return self

    def table_write(
        self,
        root: str,
        partition_by: Sequence[str] = (),
    ) -> "PlanBuilder":
        """Write the pipeline's rows as a (optionally partitioned) parquet
        dataset (reference: PlanBuilder::tableWrite + HiveDataSink)."""
        from ..connectors.hive import HiveDataSink

        part = list(partition_by)
        self.node = TableWriteNode(self.node, lambda: HiveDataSink(root, part))
        return self
