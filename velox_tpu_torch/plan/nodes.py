"""Physical plan nodes.

Counterpart of the JAX package's ``plan/nodes.py``.  Reference:
velox/core/PlanNode.h:109 and its subclasses.  Same contract as the reference:
plans are *fully specified physical plans* — no SQL, no optimizer; an
integrator (or PlanBuilder) constructs the tree.

This package has the nodes its executor runs so far: TableScan, Values,
Filter, Project, Aggregation, HashJoin, AssignUniqueId, and the finishers
OrderBy / TopN / Limit / EnforceSingleRow.  Unnest, group-id, window, union,
exchange and table-write nodes come with the slices that execute them.

Nodes carry typed expressions from ``expr``; output schemas are computed
bottom-up at construction.
"""

from __future__ import annotations

import dataclasses
import itertools
from enum import Enum
from typing import List, Optional, Tuple

from ..dtypes import BIGINT, DataType, RowType
from ..expr.ir import Call, Expr
from ..io.table import Table

_ids = itertools.count()


def _next_id(prefix: str) -> str:
    return f"{prefix}_{next(_ids)}"


class PlanNode:
    """Base plan node; subclasses set ``output_schema`` and ``sources``."""

    id: str
    sources: Tuple["PlanNode", ...] = ()
    output_schema: RowType

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Node", "")

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        line = f"{pad}- {self.name}[{self.id}] -> {self.output_schema}"
        return "\n".join([line] + [s.pretty(indent + 1) for s in self.sources])


@dataclasses.dataclass
class TableScanNode(PlanNode):
    """Scan a connector table (reference: PlanNode.h TableScanNode).

    ``subfield_filter`` is the pushed-down predicate evaluated as the first
    step of the scan's pipeline (reference: ScanSpec subfield filters,
    velox/dwio/common/ScanSpec.h:40).
    """

    table: Table
    columns: Tuple[str, ...]
    subfield_filter: Optional[Expr] = None
    id: str = dataclasses.field(default_factory=lambda: _next_id("scan"))

    def __post_init__(self):
        self.sources = ()
        self.output_schema = RowType(
            self.columns, [self.table.schema.type_of(c) for c in self.columns]
        )


@dataclasses.dataclass
class ValuesNode(PlanNode):
    """Literal in-memory rows (reference: PlanNode.h ValuesNode)."""

    table: Table
    id: str = dataclasses.field(default_factory=lambda: _next_id("values"))

    def __post_init__(self):
        self.sources = ()
        self.output_schema = self.table.schema


@dataclasses.dataclass
class FilterNode(PlanNode):
    source: PlanNode
    predicate: Expr
    id: str = dataclasses.field(default_factory=lambda: _next_id("filter"))

    def __post_init__(self):
        self.sources = (self.source,)
        self.output_schema = self.source.output_schema


@dataclasses.dataclass
class ProjectNode(PlanNode):
    source: PlanNode
    names: Tuple[str, ...]
    exprs: Tuple[Expr, ...]
    id: str = dataclasses.field(default_factory=lambda: _next_id("project"))

    def __post_init__(self):
        self.sources = (self.source,)
        self.output_schema = RowType(self.names, [e.dtype for e in self.exprs])


class AggregationStep(str, Enum):
    """Reference: core::AggregationNode::Step (partial/intermediate/final/single)."""

    PARTIAL = "partial"
    INTERMEDIATE = "intermediate"
    FINAL = "final"
    SINGLE = "single"


@dataclasses.dataclass
class AggregationNode(PlanNode):
    source: PlanNode
    step: AggregationStep
    grouping_keys: Tuple[str, ...]
    agg_names: Tuple[str, ...]
    aggregates: Tuple[Call, ...]  # e.g. Call('sum', (FieldAccess,))
    id: str = dataclasses.field(default_factory=lambda: _next_id("agg"))

    def __post_init__(self):
        from ..exec.aggregates import bind_aggregate

        self.sources = (self.source,)
        in_schema = self.source.output_schema
        names = list(self.grouping_keys)
        types: List[DataType] = [in_schema.type_of(k) for k in self.grouping_keys]
        for name, call in zip(self.agg_names, self.aggregates):
            arg_ts = tuple(a.dtype for a in call.args) or None
            bound = bind_aggregate(call.name, arg_ts, None)
            names.append(name)
            types.append(bound.result_type)
        self.output_schema = RowType(names, types)


@dataclasses.dataclass(frozen=True)
class SortKey:
    name: str
    ascending: bool = True
    nulls_first: bool = False


@dataclasses.dataclass
class OrderByNode(PlanNode):
    source: PlanNode
    keys: Tuple[SortKey, ...]
    id: str = dataclasses.field(default_factory=lambda: _next_id("orderby"))

    def __post_init__(self):
        self.sources = (self.source,)
        self.output_schema = self.source.output_schema


@dataclasses.dataclass
class TopNNode(PlanNode):
    source: PlanNode
    keys: Tuple[SortKey, ...]
    count: int
    id: str = dataclasses.field(default_factory=lambda: _next_id("topn"))

    def __post_init__(self):
        self.sources = (self.source,)
        self.output_schema = self.source.output_schema


@dataclasses.dataclass
class LimitNode(PlanNode):
    source: PlanNode
    offset: int
    count: int
    id: str = dataclasses.field(default_factory=lambda: _next_id("limit"))

    def __post_init__(self):
        self.sources = (self.source,)
        self.output_schema = self.source.output_schema


@dataclasses.dataclass
class EnforceSingleRowNode(PlanNode):
    """Fail unless at most one row is produced (reference: PlanNode.h
    EnforceSingleRowNode, used under scalar subqueries)."""

    source: PlanNode
    id: str = dataclasses.field(default_factory=lambda: _next_id("single"))

    def __post_init__(self):
        self.sources = (self.source,)
        self.output_schema = self.source.output_schema


@dataclasses.dataclass
class AssignUniqueIdNode(PlanNode):
    """Append a unique BIGINT id per row (reference: core::AssignUniqueIdNode,
    exec/AssignUniqueId.cpp — id = task-unique bits | row counter)."""

    source: PlanNode
    id_name: str = "unique_id"
    task_unique_id: int = 0
    id: str = dataclasses.field(default_factory=lambda: _next_id("uniqueid"))

    def __post_init__(self):
        self.sources = (self.source,)
        src = self.source.output_schema
        self.output_schema = RowType(
            list(src.names) + [self.id_name], list(src.types) + [BIGINT]
        )


class JoinType(str, Enum):
    """Reference: core::JoinType (PlanNode.h:1271-1310)."""

    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    LEFT_SEMI = "left_semi"
    RIGHT_SEMI = "right_semi"
    ANTI = "anti"


@dataclasses.dataclass
class HashJoinNode(PlanNode):
    """Hash join; right side is the build side (reference: PlanNode.h:1476)."""

    left: PlanNode
    right: PlanNode
    join_type: JoinType
    left_keys: Tuple[str, ...]
    right_keys: Tuple[str, ...]
    output_columns: Tuple[str, ...]  # names drawn from left ++ right schemas
    filter: Optional[Expr] = None
    # NOT IN three-valued-NULL semantics (reference: HashJoinNode nullAware,
    # PlanNode.h:1476): a NULL build key empties the result; NULL probe keys
    # never pass once the build set is non-empty
    null_aware: bool = False
    id: str = dataclasses.field(default_factory=lambda: _next_id("hashjoin"))

    def __post_init__(self):
        if self.null_aware and self.join_type != JoinType.ANTI:
            raise ValueError(
                "null_aware is only supported on ANTI joins (NOT IN); the "
                "reference also allows left-semi-project, which this engine "
                "expresses as IN-list predicates instead"
            )
        self.sources = (self.left, self.right)
        ls, rs = self.left.output_schema, self.right.output_schema
        types = []
        for c in self.output_columns:
            if c in ls:
                types.append(ls.type_of(c))
            elif c in rs:
                types.append(rs.type_of(c))
            else:
                raise KeyError(f"join output column {c!r} not in either input")
        self.output_schema = RowType(self.output_columns, types)
