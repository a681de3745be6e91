"""Aggregation fuzzer of the port (``tests/test_aggregation_fuzzer.py``):
random grouped aggregations over random nullable rows give the same rows
under every logically equal plan of the port (small tiles with the device
carry merge, one tile, small tiles with the host merge) and match the JAX
package's rows for the same plan.  Integers exactly, DOUBLE to rtol 1e-9."""

import numpy as np
import pytest

import velox_tpu as vt
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu_torch.config import QueryConfig
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import assert_same_rows, table_from_numpy

AGGS = [
    "sum(v) as r", "count(*) as r", "count(v) as r", "min(v) as r", "max(v) as r",
    "avg(w) as r", "var_pop(w) as r", "min_by(v, w) as r", "max_by(w, v) as r",
    "count_if(v > 0) as r", "bool_or(v > 900) as r", "bitwise_and_agg(v) as r",
    "bitwise_or_agg(v) as r", "checksum(v) as r", "arbitrary(v) as r", "geometric_mean(w2) as r",
]


def _tables(seed, n=700):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, rng.integers(2, 40), n).astype(np.int64)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    w = rng.normal(size=n)
    w2 = np.abs(w) + 0.5
    valid_v = rng.random(n) > 0.15
    cols = {"k": k, "v": v, "w": w, "w2": w2}
    names = list(cols)
    port = table_from_numpy(names, ["BIGINT", "BIGINT", "DOUBLE", "DOUBLE"], cols, validities={"v": valid_v})
    ref = RefTable(
        vt.RowType(names, [vt.BIGINT, vt.BIGINT, vt.DOUBLE, vt.DOUBLE]), cols, {}, {"v": valid_v}
    )
    return ref, port


def _plan(builder, table, aggs):
    # count_if / bool_or take a boolean column: project it first
    return (
        builder().table_scan(table)
        .project(["k", "v", "w", "w2", "v > 0 as pos", "v > 900 as big"])
        .aggregation(["k"], [a.replace("v > 0", "pos").replace("v > 900", "big") for a in aggs])
        .orderby(["k"]).build()
    )


@pytest.mark.parametrize("seed", range(8))
def test_aggregation_plan_equivalence(seed):
    # two aggregates a seed, every one of AGGS once over the eight seeds
    aggs = [AGGS[2 * seed], AGGS[2 * seed + 1].replace(" as r", " as r2")]
    ref_t, port_t = _tables(seed)
    plan = _plan(PlanBuilder, port_t, aggs)
    results = {
        label: LocalExecutor(plan, tile_rows=tile, device="cpu", **kw).run()
        for label, tile, kw in [
            ("small_tiles", 64, {}),
            ("one_tile", 4096, {}),
            ("host_merge", 64, {"config": QueryConfig(device_agg_merge=False)}),
        ]
    }
    want = RefExecutor(_plan(RefBuilder, ref_t, aggs), tile_rows=64).run()
    for label, got in results.items():
        assert_same_rows(got, results["small_tiles"])
        assert_same_rows(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_multi_aggregate_tiling_invariance(seed):
    ref_t, port_t = _tables(100 + seed, n=1500)
    aggs = [
        "sum(v) as s", "count(*) as c", "min(w) as mn", "max(w) as mx", "avg(v) as av",
        "stddev(w) as sd", "min_by(w, v) as mb", "max_by(v, w) as xb", "bitwise_or_agg(v) as o",
        "checksum(w) as h",
    ]
    plan = _plan(PlanBuilder, port_t, aggs)
    a = LocalExecutor(plan, tile_rows=128, device="cpu").run()
    b = LocalExecutor(plan, tile_rows=1 << 12, device="cpu").run()
    assert_same_rows(a, b)
    assert_same_rows(a, RefExecutor(_plan(RefBuilder, ref_t, aggs), tile_rows=128).run())
