"""The port stands alone: importing it (or chip_smoke) pulls in neither jax
nor the JAX package, and its entry points refuse to run without a CUDA device
unless the caller asks for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
sys.path.insert(0, {root!r})
import {module}
import velox_tpu_torch.exec.runner, velox_tpu_torch.connectors.tpch.plans
import velox_tpu_torch.ops.group_piece, velox_tpu_torch.ops.group_sum
import velox_tpu_torch.ops.selective_sum, velox_tpu_torch.ops.cuda_build
import velox_tpu_torch.ops.segmented, velox_tpu_torch.ops.sortkey
import velox_tpu_torch.ops.compact, velox_tpu_torch.exec.joins
import velox_tpu_torch.exec.sort, velox_tpu_torch.exec.grouping
import velox_tpu_torch.utils.transfer
import velox_tpu_torch.ops.segpool, velox_tpu_torch.sql.planner
import velox_tpu_torch.testing
import velox_tpu_torch.utils.tz, velox_tpu_torch.utils.porter
import velox_tpu_torch.functions.presto.tzfuncs
import velox_tpu_torch.ops.int128, velox_tpu_torch.exec.hugeint
import velox_tpu_torch.exec.sketch, velox_tpu_torch.functions.spark.scalar
import velox_tpu_torch.utils.bloom, velox_tpu_torch.utils.spark_bloom
import velox_tpu_torch.connectors.tpch.dbgen
import velox_tpu_torch.io.filesystems, velox_tpu_torch.io.cache
import velox_tpu_torch.connectors.base, velox_tpu_torch.connectors.hive
import velox_tpu_torch.native, velox_tpu_torch.serde, velox_tpu_torch.serde.page
import velox_tpu_torch.serde.rows, velox_tpu_torch.vector.fuzzer
import velox_tpu_torch.vector.saver, velox_tpu_torch.utils.reporter
import velox_tpu_torch.exec.memory, velox_tpu_torch.exec.grace
import velox_tpu_torch.exec.grouped, velox_tpu_torch.utils.testvalue
import velox_tpu_torch.utils.stats, velox_tpu_torch.utils.trace
import velox_tpu_torch.substrait, velox_tpu_torch.substrait.convert
import velox_tpu_torch.parallel, velox_tpu_torch.parallel.exchange
import velox_tpu_torch.parallel.distributed, velox_tpu_torch.parallel.shuffle_join
import velox_tpu_torch.parallel.runner, velox_tpu_torch.testing.world
import velox_tpu_torch.testing.dist_tasks
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "velox_tpu" or m.startswith("velox_tpu.")
             or m == "triton" or m.startswith("triton."))
print("BAD", bad)
"""


@pytest.mark.parametrize("module", ["velox_tpu_torch", "chip_smoke", "kernel_study"])
def test_import_pulls_in_no_jax(module):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=ROOT, module=module)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_sources_name_no_jax_import():
    import re

    pattern = re.compile(r"^\s*(import jax|from jax|import velox_tpu\b|from velox_tpu\b)")
    offenders = []
    paths = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "kernel_study.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "velox_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if pattern.match(line):
                    offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders


def _tiny_plan():
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.testing import table_from_numpy

    table = table_from_numpy(
        ["k", "v"], ["BIGINT", "BIGINT"],
        {"k": np.arange(8) % 2, "v": np.arange(8)},
    )
    return table, PlanBuilder().table_scan(table).aggregation(["k"], ["sum(v) as s"]).build()


def test_default_device_raises_without_cuda():
    from velox_tpu_torch.device import resolve_device
    from velox_tpu_torch.exec.runner import LocalExecutor, run_plan

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device exists")
    table, plan = _tiny_plan()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalExecutor(plan, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_plan(plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table.tile(0, 1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table.device_tiles(1024)


def test_join_and_collect_entry_points_raise_without_cuda():
    """Joins, collect pipelines and a host table's upload for a join build
    resolve ``device=None`` to CUDA like every other entry point; with ``device="cpu"`` the build sides'
    sub-executors run on the CPU too (they take the parent's device)."""
    from velox_tpu_torch.exec.joins import HashJoinExec
    from velox_tpu_torch.exec.runner import LocalExecutor, table_batches
    from velox_tpu_torch.plan import PlanBuilder

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device exists")
    table, _ = _tiny_plan()
    build = PlanBuilder().table_scan(table).aggregation(["v"], ["count(*) as n"])
    join = (
        PlanBuilder().table_scan(table)
        .hash_join(build, ["v"], ["v"], output=["k", "n"], join_type="left")
        .orderby(["k"]).build()
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalExecutor(join)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalExecutor(PlanBuilder().table_scan(table).build())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HashJoinExec.build(join.source, *table_batches(table, 1024))
    ex = LocalExecutor(join, device="cpu")
    assert ex.run().num_rows == 8
    [step] = [s for s in ex.lin.steps if s[0] == "join"]
    assert step[1].device.type == "cpu"


def test_sql_and_plan_time_fragments_raise_without_cuda():
    """``run_sql`` and the scalar-subquery fragments that Q11 / Q15 / Q22 run
    while their plans are built take ``device=None`` as CUDA too."""
    from velox_tpu_torch.connectors.tpch import plans
    from velox_tpu_torch.sql import run_sql

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device exists")
    table, _ = _tiny_plan()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sql("select k, sum(v) as s from t group by k", {"t": table})
    got = run_sql("select k, sum(v) as s from t group by k order by k", {"t": table}, device="cpu")
    assert list(got.columns["s"]) == [12, 16]
    tables = plans.load_query_tables(22, 0.001)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plans.build_query(22, tables)
    assert plans.build_query(22, tables, device="cpu") is not None


def test_sketch_and_spark_entry_points_raise_without_cuda():
    """The sketch rewrites, the bloom filter's build and probe and the Spark
    functions run inside the executor and ``run_sql``: ``device=None`` is
    CUDA there too, ``device="cpu"`` runs them on the host.  dbgen's tables
    are host tables, as ``gen.py``'s are."""
    from velox_tpu_torch.connectors.tpch import dbgen
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.sql import run_sql

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device exists")
    table, _ = _tiny_plan()
    plans = [
        PlanBuilder().table_scan(table).aggregation(["k"], [agg]).build()
        for agg in ("approx_distinct(v) as d", "approx_percentile(v, 0.5) as m",
                    "bloom_filter_agg(v) as bf")
    ]
    for plan in plans:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LocalExecutor(plan)
        assert LocalExecutor(plan, device="cpu").run().num_rows == 2
    text = "select pmod(v, 3) as b, max(xxhash64(v)) as x, min(rand(7)) as r from t group by pmod(v, 3)"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sql(text, {"t": table})
    assert run_sql(text, {"t": table}, device="cpu").num_rows == 3
    region = dbgen.table("region", 0.01)
    assert region.num_rows == 5
    with pytest.raises(RuntimeError, match="no CUDA device"):
        region.tile(0, 8)


def test_memory_slice_entry_points_raise_without_cuda():
    """GroupedExecution, the Grace join and the operator stats run plans:
    ``device=None`` is CUDA there too, ``device="cpu"`` runs on the host."""
    from velox_tpu_torch.exec.grace import grace_join_table
    from velox_tpu_torch.exec.grouped import GroupedExecution
    from velox_tpu_torch.config import DEFAULT_CONFIG
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.utils.stats import collect_operator_stats

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device exists")
    table, plan = _tiny_plan()
    make = lambda t: PlanBuilder().table_scan(t).aggregation(["k"], ["sum(v) as s"]).build()  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GroupedExecution(make, [("all", table)])
    assert GroupedExecution(make, [("all", table)], device="cpu").run().num_rows == 2
    join = (PlanBuilder().table_scan(table)
            .hash_join(PlanBuilder().table_scan(table).build(), ["k"], ["k"], output=["v"])
            .build())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grace_join_table(join, table, 1024, DEFAULT_CONFIG)
    assert grace_join_table(join, table, 1024, DEFAULT_CONFIG, device="cpu").num_rows == 32
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collect_operator_stats(plan)
    assert collect_operator_stats(plan, device="cpu").by_node()[plan.id].output_rows == 2


def test_explicit_cpu_runs():
    from velox_tpu_torch.exec.runner import run_plan

    _, plan = _tiny_plan()
    got = run_plan(plan, device="cpu").to_pandas().sort_values("k")
    assert list(got["s"]) == [0 + 2 + 4 + 6, 1 + 3 + 5 + 7]


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_wrappers_raise_on_a_device_they_do_not_serve():
    """A tensor that is neither on the CPU nor on CUDA is refused; nothing
    routes it to the plain version."""
    from velox_tpu_torch.ops.group_piece import grouped_piece_sums, plan_spec
    from velox_tpu_torch.ops.group_sum import grouped_int64_sums
    from velox_tpu_torch.ops.selective_sum import selective_sum

    meta = torch.device("meta")
    gid = torch.zeros(1024, dtype=torch.int8, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        grouped_piece_sums([], gid, [plan_spec([])], 4)
    v = torch.zeros(1024, dtype=torch.int64, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        selective_sum(v, [], [])
    with pytest.raises(ValueError, match="unsupported device"):
        grouped_int64_sums(
            [v], torch.zeros(1024, dtype=torch.int32, device=meta),
            torch.zeros(1024, dtype=torch.bool, device=meta), 4,
        )


def test_top_level_run_sql_matches_reference():
    """``velox_tpu_torch.run_sql`` beside ``run_plan``, as the JAX package's
    ``velox_tpu.run_sql``: one TPC-H text at SF 0.01."""
    import velox_tpu
    import velox_tpu_torch
    from velox_tpu.connectors.tpch import plans as ref_plans
    from velox_tpu_torch.connectors.tpch import plans
    from velox_tpu_torch.connectors.tpch.queries import SQL
    from velox_tpu_torch.testing import assert_same_rows

    tables = plans.load_query_tables(6, 0.01)
    got = velox_tpu_torch.run_sql(SQL[6], tables, tile_rows=1 << 13, device="cpu")
    want = velox_tpu.run_sql(SQL[6], ref_plans.load_query_tables(6, 0.01), tile_rows=1 << 13)
    assert got.num_rows == 1
    assert_same_rows(got, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            velox_tpu_torch.run_sql(SQL[6], tables)
