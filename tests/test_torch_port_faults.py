"""Repairs of the port's known faults against the JAX package: the session
properties of ``QueryConfig``, ``Table.concat``, a BIGINT ``sum`` past
int64, the Grace join's salt on a recursive level, and subnormal doubles in
plain arithmetic.

Where the JAX package's value is wrong (the wrapped sum) or differs by design
(subnormals flushed to zero by XLA on the CPU), the port is held to the
expected value and the JAX package's value is asserted beside it.
"""

import dataclasses

import numpy as np
import pytest

import velox_tpu as vt
from velox_tpu.config import QueryConfig as RefConfig
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.sql import run_sql as ref_run_sql
from velox_tpu.vector.string_table import StringTable as RefStrings
from velox_tpu_torch.config import DEFAULT_CONFIG, QueryConfig
from velox_tpu_torch.exec.grace import _salt_of, pick_partition_count, splitmix64_np
from velox_tpu_torch.exec.memory import table_nbytes
from velox_tpu_torch.exec.runner import LocalExecutor, QueryError
from velox_tpu_torch.io.table import Table
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.plan.nodes import ValuesNode
from velox_tpu_torch.sql import run_sql
from velox_tpu_torch.testing import assert_same_rows, python_rows, table_from_numpy

# the ten fields the port's QueryConfig lacked, with a value of each
NEW_FIELDS = {
    "tile_rows": "4096",
    "bench_tile_rows": "8192",
    "max_array_groups": "128",
    "abandon_partial_min_pct": "0.5",
    "strict_errors": "false",
    "session_timezone": "America/New_York",
    "adjust_timestamp_to_session_timezone": "true",
    "exchange_bucket_rows": "32",
    "broadcast_join_max_rows": "64",
    "distributed_carry_rows": "128",
}


class TestQueryConfigProperties:
    """Mirror of tests/test_misc_components.py::TestQueryConfigProperties."""

    def test_from_properties(self):
        props = {
            "spill_enabled": "false",
            "tile_rows": "4096",
            "query_memory_limit_bytes": "1000000",
            "session_timezone": "America/New_York",
            "abandon_partial_min_pct": "0.5",
        }
        cfg = QueryConfig.from_properties(props)
        assert cfg.spill_enabled is False
        assert cfg.tile_rows == 4096
        assert cfg.query_memory_limit_bytes == 1_000_000
        assert cfg.session_timezone == "America/New_York"
        assert cfg.abandon_partial_min_pct == 0.5
        ref = RefConfig.from_properties(props)
        for name in props:
            assert getattr(cfg, name) == getattr(ref, name), name

    def test_unknown_property_raises(self):
        with pytest.raises(KeyError, match="unknown session property"):
            QueryConfig.from_properties({"no_such_knob": "1"})

    @pytest.mark.parametrize("name", sorted(NEW_FIELDS))
    def test_new_field_defaults_parse_and_round_trip(self, name):
        """Each field has the JAX package's default, parses as there, and
        survives to_properties -> from_properties."""
        assert getattr(DEFAULT_CONFIG, name) == getattr(RefConfig(), name)
        cfg = QueryConfig.from_properties({name: NEW_FIELDS[name]})
        assert getattr(cfg, name) == getattr(RefConfig.from_properties({name: NEW_FIELDS[name]}), name)
        assert QueryConfig.from_properties(cfg.to_properties()) == cfg

    def test_round_trip_of_every_field(self):
        cfg = QueryConfig.from_properties(NEW_FIELDS)
        props = cfg.to_properties()
        assert set(NEW_FIELDS) <= set(props)
        assert QueryConfig.from_properties(props) == cfg
        assert cfg.broadcast_join_max_rows == 64 and cfg.exchange_bucket_rows == 32
        assert DEFAULT_CONFIG.broadcast_join_max_rows == 1 << 16


# ---------------------------------------------------------------------------
# Table.concat


def _tables(seed, n, names, with_null=False):
    rng = np.random.default_rng(seed)
    values = [""] + names
    cols = {"k": rng.integers(-5, 5, n), "s": rng.integers(1, len(values), n).astype(np.int32),
            "x": rng.random(n)}
    valid = {"x": rng.random(n) > 0.3} if with_null else {}
    port = table_from_numpy(["k", "s", "x"], ["BIGINT", "VARCHAR", "DOUBLE"], cols, {"s": values}, valid)
    ref = RefTable(vt.RowType(["k", "s", "x"], [vt.BIGINT, vt.VARCHAR, vt.DOUBLE]), dict(cols),
                   {"s": RefStrings.from_values(values)}, dict(valid))
    return port, ref


def test_table_concat_matches_reference():
    """Dictionaries unified part by part (a value keeps one code), validity
    kept where one part has it, rows in part order."""
    parts = [_tables(1, 50, ["ash", "oak"]), _tables(2, 0, ["elm"]),
             _tables(3, 40, ["oak", "fir", "ash"], with_null=True)]
    got = Table.concat([p for p, _ in parts])
    want = RefTable.concat([r for _, r in parts])
    assert_same_rows(got, want)
    assert got.string_tables["s"].values() == want.string_tables["s"].values()
    np.testing.assert_array_equal(got.columns["s"], want.columns["s"])
    assert set(got.validities) == set(want.validities) == {"x"}


def test_table_concat_refuses_complex_and_other_schemas():
    from velox_tpu_torch.dtypes import BIGINT, RowType, array
    from velox_tpu_torch.vector.complex import HostSegments

    t = Table(RowType(["a"], [array(BIGINT)]),
              {"a": HostSegments.from_pylist([[1, 2], [3]], array(BIGINT))})
    with pytest.raises(NotImplementedError, match="complex"):
        Table.concat([t, t])
    a, _ = _tables(1, 5, ["ash"])
    with pytest.raises(ValueError, match="different schemas"):
        Table.concat([a, a.select(["k", "s"])])


def test_concat_tables_still_drops_empty_inputs():
    from velox_tpu_torch.exec.grouped import concat_tables

    a, _ = _tables(1, 5, ["ash"])
    empty = dataclasses.replace(a, columns={n: v[:0] for n, v in a.columns.items()})
    assert concat_tables([empty, a]).num_rows == 5
    assert Table.concat([empty, a]).num_rows == 5


# ---------------------------------------------------------------------------
# BIGINT sum past int64


SUM_SQL = "select sum(x) as s from t"


def _sum_tables(values):
    x = np.asarray(values, dtype=np.int64)
    return (table_from_numpy(["x"], ["BIGINT"], {"x": x}),
            RefTable(vt.RowType(["x"], [vt.BIGINT]), {"x": x}))


def test_bigint_sum_overflow_raises():
    """Presto raises where the exact sum leaves int64; the JAX package
    returns the wrapped value -2^63 (a deliberate difference)."""
    port, ref = _sum_tables([1 << 62] * 3)
    with pytest.raises(QueryError, match="NUMERIC_VALUE_OUT_OF_RANGE"):
        run_sql(SUM_SQL, {"t": port}, device="cpu")
    with np.errstate(invalid="ignore"):
        want = ref_run_sql(SUM_SQL, {"t": ref}).to_pandas()
    assert int(want["s"][0]) == -9_223_372_036_854_775_808


@pytest.mark.parametrize("values", [
    [1 << 62, 1 << 62, -(1 << 62), (1 << 62) - 1],  # partial sums pass 2^63, the total does not
    [-(1 << 62)] * 2,  # exactly -2^63
    [(1 << 62) - 1, 1 << 62],  # exactly 2^63 - 1
])
def test_bigint_sum_in_range_unchanged(values):
    port, ref = _sum_tables(values)
    got = run_sql(SUM_SQL, {"t": port}, device="cpu")
    want = ref_run_sql(SUM_SQL, {"t": ref})
    assert int(got.columns["s"][0]) == sum(values) == int(want.columns["s"][0])


def test_grouped_bigint_sum_overflow_raises():
    port, _ = _sum_tables([1 << 62] * 3 + [5])
    port = table_from_numpy(["g", "x"], ["BIGINT", "BIGINT"],
                            {"g": np.array([0, 0, 0, 1]), "x": port.columns["x"]})
    with pytest.raises(QueryError, match="NUMERIC_VALUE_OUT_OF_RANGE"):
        run_sql("select g, sum(x) as s from t group by g", {"t": port}, device="cpu")


# ---------------------------------------------------------------------------
# Grace salt on a recursive level


def test_grace_recursion_spreads_an_oversized_partition():
    """60 % of the build's keys hash to level-0 partition 0, which then
    still exceeds the budget and is split again.  With a salt of the join's
    id alone the second level hashed every row into one partition again;
    salted by id and level, the rows spread, and the joined rows equal the
    JAX package's."""
    rng = np.random.default_rng(5)
    n_b, budget = 8000, 60_000
    probe_cols = {"k": rng.integers(0, 200_000, 20_000), "x": rng.integers(0, 100, 20_000)}
    probe = table_from_numpy(["k", "x"], ["BIGINT", "BIGINT"], probe_cols)
    placeholder = table_from_numpy(["bk", "y"], ["BIGINT", "BIGINT"],
                                   {"bk": np.arange(n_b), "y": np.arange(n_b)})
    plan = (PlanBuilder().table_scan(probe)
            .hash_join(PlanBuilder().table_scan(placeholder).build(), ["k"], ["bk"],
                       output=["k", "x", "y"]).build())
    salt = _salt_of(plan)
    P = pick_partition_count(table_nbytes(placeholder), budget)
    cand = np.arange(200_000, dtype=np.int64)
    part = splitmix64_np(cand, salt) & (P - 1)
    hot = cand[part == 0][: int(n_b * 0.6)]
    keys = rng.permutation(np.concatenate([hot, cand[part != 0][: n_b - len(hot)]]))
    build_cols = {"bk": keys, "y": rng.integers(0, 1000, n_b)}
    build = table_from_numpy(["bk", "y"], ["BIGINT", "BIGINT"], build_cols)
    plan = dataclasses.replace(plan, right=ValuesNode(build))
    ex = LocalExecutor(plan, tile_rows=4096,
                       config=DEFAULT_CONFIG.copy(query_memory_limit_bytes=budget), device="cpu")
    got = ex.run()
    [report] = ex.grace_joins
    first = report["partitions"][0]
    assert first["build_rows"] == len(hot)
    [again] = first["grace_joins"]
    assert again["salt"] != report["salt"]
    sizes = [p["build_rows"] for p in again["partitions"]]
    assert sum(sizes) == len(hot) and sum(1 for s in sizes if s) >= 2, sizes
    assert not again["no_progress"]

    ref_probe = RefTable(vt.RowType(["k", "x"], [vt.BIGINT, vt.BIGINT]), probe_cols)
    ref_build = RefTable(vt.RowType(["bk", "y"], [vt.BIGINT, vt.BIGINT]), build_cols)
    ref_plan = (RefBuilder().table_scan(ref_probe)
                .hash_join(RefBuilder().values(ref_build).build(), ["k"], ["bk"],
                           output=["k", "x", "y"]).build())
    want = RefExecutor(ref_plan, tile_rows=4096).run()

    def rows(t):
        return sorted(zip(*python_rows(t).values()))

    assert rows(got) == rows(want)


# ---------------------------------------------------------------------------
# subnormal doubles


def test_subnormal_double_arithmetic_keeps_ieee():
    """Decided: the port keeps IEEE subnormals in plain DOUBLE arithmetic,
    as numpy (and Presto's Java doubles) do; XLA on the CPU flushes them to
    zero, so the JAX package returns 0.0 (a deliberate difference)."""
    x = np.array([1e-300, 2.5e-300, 1.0])
    y = np.array([1e-10, 1e-15, 1.0])
    port = table_from_numpy(["x", "y"], ["DOUBLE", "DOUBLE"], {"x": x, "y": y})
    ref = RefTable(vt.RowType(["x", "y"], [vt.DOUBLE, vt.DOUBLE]), {"x": x, "y": y})

    def plan(builder, t):
        return builder().table_scan(t).project(["x * y as p", "x / 1e10 as q"]).build()

    got = LocalExecutor(plan(PlanBuilder, port), device="cpu").run()
    want = RefExecutor(plan(RefBuilder, ref)).run()
    with np.errstate(under="ignore"):
        np.testing.assert_array_equal(got.columns["p"], x * y)
        np.testing.assert_array_equal(got.columns["q"], x / 1e10)
    assert 0 < got.columns["p"][0] < np.finfo(np.float64).tiny  # subnormal
    np.testing.assert_array_equal(want.columns["p"], [0.0, 0.0, 1.0])
    np.testing.assert_array_equal(want.columns["q"], [0.0, 0.0, 1e-10])


# ---------------------------------------------------------------------------
# a descending host sort over int64's minimum


def test_descending_host_sort_over_int64_minimum():
    """The host OrderBy / TopN finisher (``_sort_indices``) reversed a
    descending integer key by negation, and -(-2^63) is -2^63 again: int64's
    minimum sorted first in a descending order.  The port reverses by
    bitwise not; the JAX package's finisher keeps the fault (its order
    asserted beside the right one)."""
    from velox_tpu.exec.runner import _sort_indices as ref_sort_indices
    from velox_tpu.plan.nodes import SortKey as RefKey
    from velox_tpu_torch.exec.runner import _sort_indices
    from velox_tpu_torch.plan.nodes import SortKey

    v = np.array([5, np.iinfo(np.int64).min, 7, -3, np.iinfo(np.int64).max], dtype=np.int64)
    port = table_from_numpy(["v"], ["BIGINT"], {"v": v})
    ref = RefTable(vt.RowType(["v"], [vt.BIGINT]), {"v": v})
    got = v[_sort_indices(port, [SortKey("v", ascending=False)])]
    assert got.tolist() == sorted(v.tolist(), reverse=True)
    want = v[ref_sort_indices(ref, [RefKey("v", ascending=False)])]
    assert want[0] == np.iinfo(np.int64).min  # the JAX package's order

    def plan(builder, t):
        return builder().table_scan(t).orderby(["v desc"]).build()

    ex = LocalExecutor(plan(PlanBuilder, port), device="cpu")
    ex._device_sort = None  # the host finisher, as a TopN over aggregates takes it
    assert ex.run().columns["v"].tolist() == sorted(v.tolist(), reverse=True)


# ---------------------------------------------------------------------------
# NOT IN over a build side that repeats a value


def test_not_in_over_repeated_build_values():
    """``x NOT IN (2, 2, 3)``: the build side holds no NULL, so 1 and 4 pass.
    The device build counted the NULL-key rows as the live rows less the
    DISTINCT valid keys, so a repeated value read as a NULL and emptied the
    result; it now counts the live rows whose key is NULL.  The JAX package
    keeps the fault (its empty result asserted beside the right one)."""
    probe_x = np.array([1, 2, 3, 4], dtype=np.int64)
    build_y = np.array([2, 2, 3], dtype=np.int64)

    def plan(builder, probe, build):
        return (
            builder().table_scan(probe)
            .hash_join(builder().table_scan(build), ["x"], ["y"], output=["x"],
                       join_type="anti", null_aware=True)
            .orderby(["x"]).build()
        )

    port = plan(PlanBuilder, table_from_numpy(["x"], ["BIGINT"], {"x": probe_x}),
                table_from_numpy(["y"], ["BIGINT"], {"y": build_y}))
    ref = plan(RefBuilder, RefTable(vt.RowType(["x"], [vt.BIGINT]), {"x": probe_x}),
               RefTable(vt.RowType(["y"], [vt.BIGINT]), {"y": build_y}))
    ex = LocalExecutor(port, device="cpu")
    [join] = [s[1] for s in ex.lin.steps if s[0] == "join"]
    assert not join.build_has_null_key and join.n_valid_build_keys == 2
    assert ex.run().columns["x"].tolist() == [1, 4]
    assert RefExecutor(ref).run().num_rows == 0  # the JAX package's rows
