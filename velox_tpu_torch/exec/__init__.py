from .aggregates import AGGREGATE_NAMES, BoundAggregate, bind_aggregate
from .runner import LocalExecutor, QueryError, RunStats, run_plan

__all__ = [
    "AGGREGATE_NAMES",
    "BoundAggregate",
    "LocalExecutor",
    "QueryError",
    "RunStats",
    "bind_aggregate",
    "run_plan",
]
