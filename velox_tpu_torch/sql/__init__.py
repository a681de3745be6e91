"""SQL frontend: SELECT statements -> engine plans (a copy of the JAX
package's ``sql``).

Reference: velox/duckdb/conversion/QueryPlanner.h:24 — the reference plans SQL
by delegating to an embedded DuckDB and converting its logical plan.  DuckDB is
not available here, so this is a self-contained planner over the engine's own
expression parser (expr/parser.py) and PlanBuilder: tokenizer -> clause parser
-> name resolution across FROM sources -> join assembly (explicit JOIN .. ON
and comma-style with WHERE equi-extraction) -> aggregate extraction -> ORDER
BY/LIMIT lowering onto OrderBy/TopN.
"""

from .planner import plan_sql, run_sql

__all__ = ["plan_sql", "run_sql"]
