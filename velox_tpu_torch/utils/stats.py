"""Plan / operator statistics and plan printing.

Counterpart of the JAX package's ``utils/stats.py``.  Reference:
velox/exec/TaskStats.h:30 (TaskStats / PipelineStats / OperatorStats),
velox/exec/PlanNodeStats.h:38,145 (toPlanStats + printPlanWithStats) and the
runtime counters surfaced per operator (velox/exec/Operator.h:83).

A pipeline runs its whole operator chain over a tile in one pass, so single
operators are not timed there: per-run counters live in
``exec.runner.RunStats``.  ``collect_operator_stats`` is the instrumented
mode: it runs each prefix of the pipeline as its own query to attribute rows
and time per operator — the analog of the reference's per-operator timers,
at the cost of running the input once a prefix (debugging only).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from ..plan.nodes import PlanNode


@dataclasses.dataclass
class OperatorStats:
    """Reference: exec::OperatorStats (rows in and out, wall time)."""

    plan_node_id: str
    operator_type: str
    input_rows: int = 0
    output_rows: int = 0
    wall_seconds: float = 0.0


@dataclasses.dataclass
class PlanStats:
    operators: List[OperatorStats] = dataclasses.field(default_factory=list)

    def by_node(self) -> Dict[str, OperatorStats]:
        return {o.plan_node_id: o for o in self.operators}


def print_plan(node: PlanNode, stats: Optional[PlanStats] = None, indent: int = 0) -> str:
    """Reference: printPlanWithStats (velox/exec/PlanNodeStats.h:145)."""
    pad = "  " * indent
    line = f"{pad}- {node.name}[{node.id}] -> {node.output_schema}"
    if stats is not None:
        s = stats.by_node().get(node.id)
        if s is not None:
            line += (
                f"   [in: {s.input_rows:,} rows, out: {s.output_rows:,} rows, "
                f"{s.wall_seconds*1e3:.1f} ms]"
            )
    lines = [line]
    for src in node.sources:
        lines.append(print_plan(src, stats, indent + 1))
    return "\n".join(lines)


def collect_operator_stats(
    root: PlanNode, tile_rows: int = 1 << 20, config=None, device=None
) -> PlanStats:
    """Instrumented execution: run each prefix of the chain from the leaf
    source up to ``root`` (following each node's first source) as its own
    query, and attribute its result rows and time to its top operator; an
    operator's input rows are the rows of the prefix below it.  A prefix the
    executor cannot run alone records -1 rows.  ``device`` None = the CUDA
    device (raises without one)."""
    from ..exec.runner import LocalExecutor

    chain: List[PlanNode] = []
    node = root
    while True:
        chain.append(node)
        if not node.sources:
            break
        node = node.sources[0]
    chain.reverse()

    stats = PlanStats()
    prev_rows = 0
    for n in chain:
        t0 = time.perf_counter()
        try:
            rows = LocalExecutor(n, tile_rows, config, device=device).run().num_rows
        except NotImplementedError:
            rows = -1
        wall = time.perf_counter() - t0
        stats.operators.append(OperatorStats(n.id, n.name, prev_rows, rows, wall))
        prev_rows = rows
    return stats
