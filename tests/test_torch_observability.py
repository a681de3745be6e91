"""Operator stats, plan printing, tracing and the injection points of the
port.

Mirrors ``tests/test_misc_operators.py``'s ``test_print_plan_and_stats``
and ``test_testvalue_injection_points`` on the same inputs: the rows each
operator saw are the JAX package's, and the overflow fallback's injection
point fires with the JAX package's group count.  The profiler context
(``device_profile``, the counterpart of the JAX package's ``xla_profile``)
writes a Chrome trace that holds the query's operations and the executor's
spans (``tests/test_torch_trace_spans.py`` covers the spans)."""

import json
import os

import numpy as np

import velox_tpu as vt
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.utils import testvalue as ref_testvalue
from velox_tpu.utils.stats import collect_operator_stats as ref_collect_operator_stats
from velox_tpu.utils.stats import print_plan as ref_print_plan
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.utils import testvalue
from velox_tpu_torch.utils.stats import collect_operator_stats, print_plan
from velox_tpu_torch.utils.trace import device_profile


def _pair(**cols):
    names = list(cols)
    arrays = {k: np.asarray(v, np.int64) for k, v in cols.items()}
    ref = RefTable(vt.RowType(names, [vt.BIGINT] * len(names)), dict(arrays))
    return ref, table_from_numpy(names, ["BIGINT"] * len(names), arrays)


def _stat_plan(builder, t):
    return builder().table_scan(t).filter("v % 2 = 0").project(["v * 2 as w"]).build()


def test_print_plan_and_stats():
    ref_t, t = _pair(v=list(range(100)))
    plan = _stat_plan(PlanBuilder, t)
    text = print_plan(plan)
    assert "Project" in text and "Filter" in text and "TableScan" in text
    stats = collect_operator_stats(plan, device="cpu")
    text2 = print_plan(plan, stats)
    assert "rows" in text2
    assert stats.by_node()[plan.id].output_rows == 50
    ref_plan = _stat_plan(RefBuilder, ref_t)
    ref_stats = ref_collect_operator_stats(ref_plan)
    assert [(o.operator_type, o.input_rows, o.output_rows) for o in stats.operators] == [
        (o.operator_type, o.input_rows, o.output_rows) for o in ref_stats.operators
    ]
    # the same tree, line for line, apart from the node ids
    strip = lambda s: [ln.split("[")[0] + ln.split("]", 1)[1] for ln in s.splitlines()]  # noqa: E731
    assert strip(text) == strip(ref_print_plan(ref_plan))


def test_testvalue_injection_points():
    """Hooks fire at exact internal states: here the device merge's
    overflow fallback, in both packages."""
    rng = np.random.default_rng(0)
    n, nkeys = 8000, 5000
    keys = rng.permutation(np.repeat(np.arange(nkeys), 2))[:n]
    ref_t, t = _pair(k=keys, v=rng.integers(0, 5, n))

    def make(builder, table):
        return (builder().table_scan(table)
                .aggregation(["k"], ["sum(v) as s"]).orderby(["k"]).build())

    fired = []
    with testvalue.scoped("AggExecutor::carryOverflowFallback", fired.append):
        # a 1024-slot carry with ~5000 distinct keys overflows the device merge
        out = LocalExecutor(make(PlanBuilder, t), tile_rows=1024, device="cpu").run()
    ref_fired = []
    with ref_testvalue.scoped("AggExecutor::carryOverflowFallback", ref_fired.append):
        ref = RefExecutor(make(RefBuilder, ref_t), tile_rows=1024).run()
    assert fired and ref_fired, "overflow fallback injection point did not fire"
    assert out.num_rows == ref.num_rows == len(np.unique(keys))
    np.testing.assert_array_equal(out.columns["s"], np.asarray(ref.columns["s"]))


def test_device_profile_writes_a_trace(tmp_path):
    _, t = _pair(v=list(range(1000)))
    log_dir = str(tmp_path / "prof")
    with device_profile(log_dir):
        LocalExecutor(_stat_plan(PlanBuilder, t), device="cpu").run()
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"velox.construct", "velox.run"} <= names
