"""Small synthetic plans through both packages' PlanBuilder and LocalExecutor:
string and nullable grouping keys, every ported aggregate, the host finishers
(orderby / topn / limit), a Values source and evaluation errors.  Integer
columns equal bit for bit, DOUBLE columns to rtol 1e-12 (float64 sums add in
another order)."""

import numpy as np
import pytest

import velox_tpu as vt
from velox_tpu.exec.runner import LocalExecutor as RefExecutor, QueryError as RefQueryError
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.vector.string_table import StringTable as RefStrings
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor, QueryError
from velox_tpu_torch.plan import PlanBuilder as PortBuilder
from velox_tpu_torch.testing import assert_plan_result, run_at_tile_sizes, table_from_numpy

N = 5000
_NAMES = ["city", "k", "v", "d", "x", "z"]
_TYPES = ["VARCHAR", "BIGINT", "BIGINT", "DECIMAL(12,2)", "DOUBLE", "BIGINT"]
_CITIES = ["", "lyon", "oslo", "rome", "bern"]


def _data():
    rng = np.random.default_rng(23)
    cols = {
        "city": rng.integers(1, 5, N).astype(np.int32),
        "k": rng.integers(10, 14, N).astype(np.int64),
        "v": rng.integers(-1000, 1000, N).astype(np.int64),
        "d": rng.integers(0, 100000, N).astype(np.int64),
        "x": rng.normal(0, 10, N),
        "z": rng.integers(0, 3, N).astype(np.int64),
    }
    validities = {"k": rng.random(N) < 0.9, "v": rng.random(N) < 0.8}
    return cols, validities


def _tables():
    cols, validities = _data()
    port = table_from_numpy(_NAMES, _TYPES, cols, {"city": _CITIES}, validities)
    types = [vt.VARCHAR, vt.BIGINT, vt.BIGINT, vt.decimal(12, 2), vt.DOUBLE, vt.BIGINT]
    ref = RefTable(
        vt.RowType(_NAMES, types), dict(cols),
        {"city": RefStrings.from_values(_CITIES)}, dict(validities),
    )
    return ref, port


def _same(got, want):
    assert list(got.schema.names) == list(want.schema.names)
    assert got.num_rows == want.num_rows
    assert set(got.validities) == set(want.validities)
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        valid = want.validities.get(name)
        if valid is not None:
            np.testing.assert_array_equal(got.validities[name], valid)
            g, w = g[valid], w[valid]
        if dtype.is_string:
            g = got.string_tables[name].decode(g)
            w = want.string_tables[name].decode(w)
            assert list(g) == list(w)
        elif dtype.is_floating:
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


_AGGS = [
    "count(*) as n", "count(v) as nv", "sum(v) as sv", "avg(v) as av",
    "min(v) as lo", "max(d) as hi", "sum(d * 2) as sd", "avg(d) as ad",
    "sum(x) as sx", "avg(x) as ax", "min(x) as mx", "max(city) as last_city",
]


def _plan(builder, table, finish):
    b = builder().table_scan(table, filter="z < 2 and d >= 100.00")
    b = b.aggregation(["city", "k"], _AGGS)
    return finish(b).build()


_FINISHERS = {
    "orderby": lambda b: b.orderby(["city", "k nulls first"]),
    "orderby_desc": lambda b: b.orderby(["n desc", "city", "k"]),
    "topn": lambda b: b.topn(["sd desc", "city", "k"], 5),
    "orderby_limit": lambda b: b.orderby(["city desc", "k"]).limit(4, 2),
}


@pytest.mark.parametrize(
    "finisher,tile_rows",
    [("orderby", 1 << 10), ("orderby_desc", 1 << 20), ("topn", 1 << 20), ("orderby_limit", 1 << 11)],
)
def test_grouped_plan_matches_reference(finisher, tile_rows):
    ref_t, port_t = _tables()
    ref = RefExecutor(_plan(RefBuilder, ref_t, _FINISHERS[finisher]), tile_rows=tile_rows)
    port = PortExecutor(
        _plan(PortBuilder, port_t, _FINISHERS[finisher]), tile_rows=tile_rows, device="cpu"
    )
    assert (port.kind, port.agg_exec.mode, port.agg_exec.num_groups) == (
        ref.kind, ref.agg_exec.mode, ref.agg_exec.num_groups,
    )
    assert port.use_piece == (getattr(ref.agg_exec, "_piece_plan", None) is not None)
    _same(port.run(), ref.run())


def test_ungrouped_over_values_source():
    ref_t, port_t = _tables()
    aggs = ["count(*) as n", "sum(v) as sv", "avg(d) as ad", "max(x) as mx", "min(city) as c"]
    ref = RefExecutor(RefBuilder().values(ref_t).filter("v > 0").aggregation([], aggs).build())
    port = PortExecutor(
        PortBuilder().values(port_t).filter("v > 0").aggregation([], aggs).build(), device="cpu"
    )
    assert port.agg_exec.mode == ref.agg_exec.mode == "ungrouped"
    _same(port.run(), ref.run())


def test_empty_input_gives_null_sums():
    ref_t, port_t = _tables()
    aggs = ["count(*) as n", "sum(v) as sv", "min(d) as lo"]
    ref = RefExecutor(RefBuilder().table_scan(ref_t, filter="z > 5").aggregation([], aggs).build())
    port = PortExecutor(
        PortBuilder().table_scan(port_t, filter="z > 5").aggregation([], aggs).build(),
        device="cpu",
    )
    got, want = port.run(), ref.run()
    _same(got, want)
    assert int(got.columns["n"][0]) == 0 and not got.validities["sv"][0]


def test_evaluation_error_raises_in_both():
    ref_t, port_t = _tables()
    with pytest.raises(RefQueryError):
        RefExecutor(
            RefBuilder().table_scan(ref_t).project(["100 / z as q"]).aggregation([], ["sum(q) as s"]).build()
        ).run()
    with pytest.raises(QueryError, match="row"):
        PortExecutor(
            PortBuilder().table_scan(port_t).project(["100 / z as q"]).aggregation([], ["sum(q) as s"]).build(),
            device="cpu",
        ).run()
    # try() nulls the failing rows instead
    ok = PortExecutor(
        PortBuilder().table_scan(port_t).project(["try(100 / z) as q"]).aggregation([], ["count(q) as c"]).build(),
        device="cpu",
    ).run()
    assert int(ok.columns["c"][0]) == int((_data()[0]["z"] != 0).sum())


def test_testing_helpers():
    import pandas as pd

    _, port_t = _tables()
    plan = PortBuilder().table_scan(port_t).aggregation(["z"], ["count(*) as n", "sum(d) as sd"]).build()
    cols, _ = _data()
    df = pd.DataFrame({"z": cols["z"], "d": cols["d"]})
    want = df.groupby("z", as_index=False).agg(n=("d", "size"), sd=("d", "sum"))
    want["sd"] = want["sd"] / 100.0
    assert_plan_result(plan, want, sort_by=["z"], tile_rows=1 << 11, device="cpu")
    run_at_tile_sizes(plan, (1 << 10, 1 << 12, 1 << 20), device="cpu")
