"""NULL grouping keys form ONE group, in the port as in the JAX package: the
cases of ``tests/test_null_grouping.py`` through both ``LocalExecutor``s on
the same rows, with the new aggregates beside sum and count.  Integers
exactly, DOUBLE to rtol 1e-9."""

import numpy as np
import pytest

import velox_tpu as vt
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor
from velox_tpu_torch.plan import PlanBuilder as PortBuilder
from velox_tpu_torch.testing import assert_same_rows, table_from_numpy


def _null_tables(names, types, data, validities, strings=None):
    port = table_from_numpy(names, types, data, strings, validities)
    ref_types = [vt.VARCHAR if t == "VARCHAR" else vt.BIGINT for t in types]
    ref_strings = {n: vt.StringTable.from_values(v) for n, v in (strings or {}).items()}
    ref = RefTable(vt.RowType(names, ref_types), dict(data), ref_strings, dict(validities))
    return ref, port


NULL_CASES = {
    "single_group": (
        ["k", "x"], ["BIGINT", "BIGINT"],
        {"k": np.array([1, 2, 1, 99, 55, 2, 77]), "x": np.arange(7)},
        {"k": np.array([1, 1, 1, 0, 0, 1, 0], bool)}, None,
        None, ["k"], ["sum(x) as s", "count(*) as c", "min_by(x, k) as m", "bool_or(x > 3) as b"], 64,
    ),
    "multi_key": (
        ["k1", "k2", "x"], ["BIGINT", "BIGINT", "BIGINT"],
        {
            "k1": np.random.default_rng(3).integers(0, 5, 500),
            "k2": np.random.default_rng(4).integers(0, 4, 500),
            "x": np.random.default_rng(5).integers(0, 100, 500),
        },
        {
            "k1": np.random.default_rng(6).random(500) >= 0.3,
            "k2": np.random.default_rng(7).random(500) >= 0.3,
        }, None,
        None, ["k1", "k2"], ["sum(x) as s", "count(*) as c", "var_pop(x) as v", "checksum(x) as h"], 128,
    ),
    "unbounded_fallback": (
        ["k", "x"], ["BIGINT", "BIGINT"],
        {"k": np.array([1 << 40, -(1 << 40), 1 << 40, 123, 456]), "x": np.arange(5)},
        {"k": np.array([1, 1, 1, 0, 0], bool)}, None,
        ["k * 1 as kk", "x"], ["kk"], ["sum(x) as s", "count(*) as c", "max_by(x, x) as m"], 4,
    ),
    "array_mode_strings": (
        ["k", "x"], ["VARCHAR", "BIGINT"],
        {"k": np.array([1, 2, 1, 2, 1], np.int32), "x": np.arange(5)},
        {"k": np.array([1, 1, 0, 0, 1], bool)}, {"k": ["", "a", "b"]},
        None, ["k"], ["sum(x) as s", "count(*) as c", "bitwise_or_agg(x) as o"], 4,
    ),
    "non_null_keys": (
        ["k", "x"], ["BIGINT", "BIGINT"],
        {"k": np.array([3, 1, 3, 2, 1]), "x": np.arange(5)}, {}, None,
        None, ["k"], ["sum(x) as s", "count_if(x > 1) as c"], 64,
    ),
    "count_distinct_nullable_string_key": (
        ["k", "v"], ["VARCHAR", "BIGINT"],
        {"k": np.array([1, 2, 1, 0, 2], np.int32), "v": np.array([7, 8, 7, 9, 8])},
        {"k": np.array([1, 1, 1, 0, 1], bool)}, {"k": ["", "x", "y"]},
        None, ["k"], ["count(distinct v) as d", "count(*) as c"], 4,
    ),
}


@pytest.mark.parametrize("case", list(NULL_CASES))
def test_null_grouping_matches_reference(case):
    names, types, data, validities, strings, project, keys, aggs, tile = NULL_CASES[case]
    data = {n: np.asarray(v).astype(np.int32 if t == "VARCHAR" else np.int64) for (n, v), t in zip(data.items(), types)}
    ref_t, port_t = _null_tables(names, types, data, validities, strings)

    def plan(builder, t):
        pb = builder().table_scan(t)
        if project:
            pb = pb.project(project)
        return pb.aggregation(keys, aggs).orderby(keys).build()

    got = PortExecutor(plan(PortBuilder, port_t), tile_rows=tile, device="cpu").run()
    want = RefExecutor(plan(RefBuilder, ref_t), tile_rows=tile).run()
    assert_same_rows(got, want)
    if len(keys) == 1 and keys[0] in got.validities:
        # every NULL key is one group
        assert int((~np.asarray(got.validities[keys[0]])).sum()) == 1
