from .builder import PlanBuilder
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

__all__ = [
    "AggregationNode",
    "AggregationStep",
    "FilterNode",
    "HashJoinNode",
    "JoinType",
    "LimitNode",
    "OrderByNode",
    "PlanBuilder",
    "PlanNode",
    "ProjectNode",
    "SortKey",
    "TableScanNode",
    "TopNNode",
    "ValuesNode",
]
