"""The slice as a whole: TPC-H Q6 and Q1 at SF 0.01 through both packages'
``LocalExecutor`` over the same generated rows.

The rows are generated once by the JAX package's generator and carried into
the port as plain numpy / Python values (``testing.table_from_numpy``), so
the port's generator is held against the reference's too.  Integer, decimal,
date and string columns must agree bit for bit, DOUBLE columns to rtol 1e-9
(the averages are one host-side float division of exact integer sums)."""

import numpy as np
import pandas as pd
import pytest

from velox_tpu.connectors.tpch import plans as ref_plans
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu_torch.connectors.tpch import plans as port_plans
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor
from velox_tpu_torch.testing import table_from_numpy

SF = 0.01
_CACHE = {}


def _carry_across(table):
    """A port Table from the plain values of a JAX-package Table."""
    names = list(table.schema.names)
    return table_from_numpy(
        names,
        [str(t) for t in table.schema.types],
        {n: np.asarray(table.columns[n]) for n in names},
        {n: t.values() for n, t in table.string_tables.items()},
        {n: np.asarray(v) for n, v in table.validities.items()},
    )


def _tables(num):
    if num not in _CACHE:
        ref = ref_plans.load_query_tables(num, SF, cache_dir=None)
        _CACHE[num] = (ref, {k: _carry_across(t) for k, t in ref.items()})
    return _CACHE[num]


def _assert_same_table(got, want):
    """Port result Table vs reference result Table, on the device
    representation (unscaled decimals, day numbers, decoded strings)."""
    assert list(got.schema.names) == list(want.schema.names)
    assert [str(t) for t in got.schema.types] == [str(t) for t in want.schema.types]
    assert got.num_rows == want.num_rows
    assert set(got.validities) == set(want.validities)
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        if dtype.is_string:
            g = got.string_tables[name].decode(g)
            w = want.string_tables[name].decode(w)
            assert list(g) == list(w), name
        elif dtype.is_floating:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=name)
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("tile_rows", [1 << 12, 1 << 14, 1 << 20])
@pytest.mark.parametrize("num", [6, 1])
def test_query_matches_reference_executor(num, tile_rows):
    ref_tables, port_tables = _tables(num)
    ref_ex = RefExecutor(ref_plans.build_query(num, ref_tables), tile_rows=tile_rows)
    port_ex = PortExecutor(
        port_plans.build_query(num, port_tables), tile_rows=tile_rows, device="cpu"
    )
    # same planning decisions
    assert port_ex.kind == ref_ex.kind == "direct_agg"
    assert port_ex.capacity == ref_ex.capacity
    assert port_ex.agg_exec.mode == ref_ex.agg_exec.mode
    assert port_ex.agg_exec.num_groups == ref_ex.agg_exec.num_groups
    ref_piece = getattr(ref_ex.agg_exec, "_piece_plan", None)
    assert port_ex.use_piece == (ref_piece is not None)
    assert [a.acc_ops for a in port_ex.agg_exec.aggs] == [
        a.acc_ops for a in ref_ex.agg_exec.aggs
    ]
    if ref_piece is not None:
        r_cols, r_specs, r_slots, r_count = ref_piece
        p_cols, p_specs, p_slots, p_count = port_ex.agg_exec._piece_plan
        assert (p_cols, p_slots, p_count) == (r_cols, r_slots, r_count)
        assert [
            [(f.col, f.scale, f.offset, f.lo, f.hi) for f in p.factors] for p in p_specs
        ] == [
            [(f.col, f.scale, f.offset, f.lo, f.hi) for f in p.factors] for p in r_specs
        ]
    want = ref_ex.run()
    got = port_ex.run()
    _assert_same_table(got, want)
    if tile_rows == 1 << 20:
        assert port_ex.source_table.num_tiles(port_ex.capacity) == 1
    else:
        assert port_ex.source_table.num_tiles(port_ex.capacity) > 1


def test_expected_modes():
    """Q6 is ungrouped and stays off the piece path (cost gate); Q1 is
    array-mode over 12 slots and takes it."""
    q6 = PortExecutor(port_plans.build_query(6, _tables(6)[1]), 1 << 14, device="cpu")
    q1 = PortExecutor(port_plans.build_query(1, _tables(1)[1]), 1 << 14, device="cpu")
    assert (q6.agg_exec.mode, q6.agg_exec.num_groups, q6.use_piece) == ("ungrouped", 1, False)
    assert (q1.agg_exec.mode, q1.agg_exec.num_groups, q1.use_piece) == ("array", 12, True)
    cols, specs, _, _ = q1.agg_exec._piece_plan
    assert len(cols) == 4 and len(specs) == 6
    # narrow rebinding: Q6's sum carries two accumulators, not three limbs
    assert [a.acc_ops for a in q6.agg_exec.aggs] == [("sum", "sum")]


@pytest.mark.parametrize("num", [6, 1])
def test_port_generator_and_oracle_match_reference(num):
    """The port's own generator makes the same rows, and its oracle the same
    answer, as the JAX package's."""
    ref_tables, _ = _tables(num)
    own = port_plans.load_query_tables(num, SF)
    assert set(own) == set(ref_tables)
    for name, table in own.items():
        ref = ref_tables[name]
        assert list(table.schema.names) == list(ref.schema.names)
        for col in ref.schema.names:
            np.testing.assert_array_equal(table.columns[col], ref.columns[col], err_msg=col)
        for col, tab in ref.string_tables.items():
            assert table.string_tables[col].values() == tab.values()
    pd.testing.assert_frame_equal(
        port_plans.oracle_result(num, own), ref_plans.oracle_result(num, ref_tables)
    )


@pytest.mark.parametrize("num", [6, 1])
def test_port_matches_its_own_oracle(num):
    tables = port_plans.load_query_tables(num, SF)
    got = PortExecutor(
        port_plans.build_query(num, tables), tile_rows=1 << 13, device="cpu"
    ).run().to_pandas()
    pd.testing.assert_frame_equal(
        got.reset_index(drop=True),
        port_plans.oracle_result(num, tables).reset_index(drop=True),
        check_dtype=False,
        rtol=1e-9,
    )


def test_general_path_equals_piece_path():
    """With the piece path off Q1 runs the per-accumulator update and gives
    the same table."""
    tables = _tables(1)[1]
    plan = port_plans.build_query(1, tables)
    piece = PortExecutor(plan, tile_rows=1 << 13, device="cpu")
    general = PortExecutor(plan, tile_rows=1 << 13, device="cpu")
    assert piece.use_piece and general.use_piece
    general.use_piece = False  # the scan tile no longer rides along
    _assert_same_table(general.run(), piece.run())


def test_prefetched_tiles_and_stats():
    from velox_tpu_torch.exec.runner import RunStats

    tables = _tables(1)[1]
    ex = PortExecutor(port_plans.build_query(1, tables), tile_rows=1 << 14, device="cpu")
    tiles = ex.device_tiles()
    assert ex.pool.reserved > 0
    stats = RunStats()
    a = ex.run(prefetched_tiles=tiles, stats=stats)
    b = ex.run()
    _assert_same_table(a, b)
    other = PortExecutor(port_plans.build_query(1, tables), tile_rows=1 << 12, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        other.run(prefetched_tiles=tiles)
    assert stats.tiles == len(tiles) and stats.rows_in == tables["lineitem"].num_rows
    assert stats.total_seconds >= stats.device_seconds > 0


def test_unported_plans_raise_by_name():
    tables = _tables(1)[1]
    assert port_plans.implemented_queries() == list(range(1, 23))
    from velox_tpu_torch.plan import PlanBuilder

    scan = lambda: PlanBuilder().table_scan(tables["lineitem"])  # noqa: E731
    # table_write is ported (tests/test_torch_connectors.py runs it): it
    # builds a node whose output is the written row count
    write = scan().table_write("unused").build()
    assert type(write).__name__ == "TableWriteNode"
    assert [str(t) for t in write.output_schema.types] == ["BIGINT"]
    # unnest and group_id run: every lineitem row once per grouping set, and
    # one row per element of an array built from its columns
    n = tables["lineitem"].num_rows
    grouped = scan().group_id([["l_returnflag"], []], ["l_quantity"], "gid").build()
    out = PortExecutor(grouped, tile_rows=1 << 14, device="cpu").run()
    assert out.num_rows == 2 * n
    assert np.bincount(np.asarray(out.columns["gid"])).tolist() == [n, n]
    unnested = (
        scan().project(["array[l_quantity, l_discount] as qd"])
        .unnest([], ["qd"], ordinality="pos").build()
    )
    out = PortExecutor(unnested, tile_rows=1 << 14, device="cpu").run()
    assert out.num_rows == 2 * n
    assert np.bincount(np.asarray(out.columns["pos"])).tolist() == [0, n, n]
    # a join whose build side repeats its key runs as an expansion join:
    # one output row per pair of rows with equal keys
    cols = {n: np.asarray(tables["lineitem"].columns[n]) for n in ("l_tax", "l_quantity", "l_discount")}
    probe = PlanBuilder().table_scan(tables["lineitem"], filter="l_quantity = 1 and l_discount = 0")
    build = PlanBuilder().table_scan(tables["lineitem"], filter="l_quantity = 2")
    dup = probe.hash_join(build, ["l_tax"], ["l_tax"], output=["l_tax"]).build()
    ex = PortExecutor(dup, tile_rows=1 << 14, device="cpu")
    assert [s[0] for s in ex._all_steps] == ["filter", "xjoin"]
    probe_tax = cols["l_tax"][(cols["l_quantity"] == 100) & (cols["l_discount"] == 0)]
    build_tax = cols["l_tax"][cols["l_quantity"] == 200]
    counts = np.bincount(build_tax, minlength=16)
    assert ex.run().num_rows == int(counts[probe_tax].sum()) > 0
    # a FULL join over the same sides: every key of either side matches one
    # of the other, so it has the inner join's rows
    full = PlanBuilder().table_scan(
        tables["lineitem"], filter="l_quantity = 1 and l_discount = 0"
    ).hash_join(
        PlanBuilder().table_scan(tables["lineitem"], filter="l_quantity = 1 and l_discount = 0"),
        ["l_tax"], ["l_tax"], output=["l_tax"], join_type="full",
    ).build()
    probe_counts = np.bincount(probe_tax, minlength=16)
    assert PortExecutor(full, tile_rows=1 << 14, device="cpu").run().num_rows == int(
        (probe_counts ** 2).sum()
    )
    # what the earlier slices refused now runs: a collect pipeline and a
    # sort-mode grouping
    collect = PortExecutor(scan().limit(3).build(), tile_rows=1 << 14, device="cpu")
    assert collect.kind == "collect" and collect.run().num_rows == 3
    sort_mode = scan().aggregation(["l_extendedprice"], ["count(*) as c"]).build()
    ex = PortExecutor(sort_mode, tile_rows=1 << 14, device="cpu")
    assert ex.kind == "sort_agg_device"
    assert int(ex.run().columns["c"].sum()) == tables["lineitem"].num_rows


def test_piece_path_with_wide_accumulators():
    """When the total row count is too large for the narrow rebinding (TPC-H
    Q1's sum_charge from about SF 7 up), the sum keeps its (hi, lo, count)
    limbs and the piece path still runs, under a per-tile proof.  Simulated
    here by binding the aggregation for 6e7 rows over the SF 0.01 table."""
    from velox_tpu_torch.exec.runner import AggExecutor

    tables = _tables(1)[1]
    plan = port_plans.build_query(1, tables)
    narrow = PortExecutor(plan, tile_rows=1 << 13, device="cpu")
    wide = PortExecutor(plan, tile_rows=1 << 13, device="cpu")
    wide.agg_exec = AggExecutor(wide.lin.agg, wide.capacity, max_rows=60_000_000)
    wide.use_piece = wide.agg_exec.try_enable_piece_path()
    assert wide.use_piece
    ops = [a.acc_ops for a in wide.agg_exec.aggs]
    assert ops[3] == ("sum", "sum", "sum")  # sum_charge stayed wide
    assert ops[0] == ("sum", "sum")  # sum_qty still narrow
    assert wide.agg_exec._piece_wide[3] and not wide.agg_exec._piece_wide[0]
    _assert_same_table(wide.run(), narrow.run())
    # a bound that does not even fit one tile keeps the aggregation off the path
    huge = AggExecutor(wide.lin.agg, 1 << 30, max_rows=1 << 40)
    assert not huge.try_enable_piece_path()
