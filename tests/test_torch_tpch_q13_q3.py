"""The slice as a whole: TPC-H Q13 and Q3 at SF 0.01 through both packages'
``LocalExecutor`` over the same generated rows, at two tile sizes.

The rows are generated once by the JAX package's generator and carried into
the port as plain numpy / Python values (``testing.table_from_numpy``), so
the port's generator is held against the reference's too.  Integer, decimal,
date and string columns must agree bit for bit; the one DOUBLE-typed output
there could be (none in these two queries) would hold rtol 1e-9."""

import numpy as np
import pandas as pd
import pytest

from velox_tpu.connectors.tpch import plans as ref_plans
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu_torch.connectors.tpch import plans as port_plans
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.utils.transfer import bucket_of

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
    assert list(got.schema.names) == list(want.schema.names)
    assert [str(t) for t in got.schema.types] == [str(t) for t in want.schema.types]
    assert got.num_rows == want.num_rows
    assert set(got.validities) == set(want.validities)
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        if dtype.is_floating:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=name)
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _joins(ex):
    return [s[1] for s in ex.lin.steps if s[0] == "join"]


@pytest.mark.parametrize("tile_rows", [1 << 12, 1 << 20])
@pytest.mark.parametrize("num", [13, 3])
def test_query_matches_reference_executor(num, tile_rows):
    ref_tables, port_tables = _tables(num)
    ref_ex = RefExecutor(ref_plans.build_query(num, ref_tables), tile_rows=tile_rows)
    port_ex = PortExecutor(
        port_plans.build_query(num, port_tables), tile_rows=tile_rows, device="cpu"
    )
    # same planning decisions
    assert port_ex.kind == ref_ex.kind == "sort_agg_device"
    assert port_ex.capacity == ref_ex.capacity
    assert port_ex.agg_exec.mode == ref_ex.agg_exec.mode == "sort"
    assert port_ex.agg_exec.grouping.presorted == ref_ex.agg_exec.grouping.presorted
    assert [k.name for k in port_ex.agg_exec.key_infos] == [
        k.name for k in ref_ex.agg_exec.key_infos
    ]
    assert [a.acc_ops for a in port_ex.agg_exec.aggs] == [
        a.acc_ops for a in ref_ex.agg_exec.aggs
    ]
    for p, r in zip(_joins(port_ex), _joins(ref_ex)):
        # the port builds every build side on the device, in a power-of-two
        # bucket; the JAX package builds Q13's aggregated one on the host, in
        # exactly its row count
        assert (r.build_valid is None) == (num == 13)
        want_size = bucket_of(r.build_size) if num == 13 else r.build_size
        assert (p.build_size, p.key_range, p.n_valid_build_keys) == (
            want_size, r.key_range, r.n_valid_build_keys,
        )
        assert (p.bp_plan is None) == (r.bp_plan is None)
    want = ref_ex.run()
    got = port_ex.run()
    _assert_same_table(got, want)
    # and the oracle, through pandas
    got_df = got.to_pandas()
    if num in port_plans.ENGINE_OUTPUT_ORDER:
        got_df = got_df[port_plans.ENGINE_OUTPUT_ORDER[num]]
    pd.testing.assert_frame_equal(
        got_df.reset_index(drop=True),
        port_plans.oracle_result(num, port_tables).reset_index(drop=True),
        check_dtype=False, rtol=1e-9,
    )


def test_expected_shapes():
    """Q13: the build side is an aggregation over ``orders`` (packed sort
    grouping, its result uploaded and built on the device), the outer grouping key ``coalesce(cnt, 0)``
    has no bounds (several-key fallback with the null-bits key).  Q3: a semi
    join inside the build side of an inner join, both built on the device, a
    packed payload, presorted grouping over several tiles and a device TopN."""
    q13 = PortExecutor(port_plans.build_query(13, _tables(13)[1]), 1 << 12, device="cpu")
    assert [k.name for k in q13.agg_exec.key_infos] == ["c_count", "__nullbits__"]
    assert q13.agg_exec.grouping.pack_plan(q13.capacity) is None
    [j13] = _joins(q13)
    assert j13.node.join_type.value == "left"
    assert int(j13.build_valid.sum()) == j13.n_valid_build_keys > 0
    assert j13.bp_plan is not None
    assert q13.source_table.num_tiles(q13.capacity) == 1 and q13.build_seconds > 0

    # 60175 lineitem rows in 4 tiles, as SF 10 has at 2^24-row tiles: the
    # carry, sized at 4x tile 0's group count, holds every group (with the
    # 15 tiles of 4096 rows it overflows into the host merge, same rows)
    q3 = PortExecutor(port_plans.build_query(3, _tables(3)[1]), 1 << 14, device="cpu")
    [j3] = _joins(q3)
    assert j3.build_valid is not None  # device build
    assert j3.bp_fields == (("v", "o_orderdate"), ("v", "o_shippriority"))
    assert q3.agg_exec.grouping.presorted
    assert q3.agg_exec.grouping.pack_plan(q3.capacity) is not None
    assert q3.source_table.num_tiles(q3.capacity) == 4
    assert q3._device_topn_plan()[0] == 10
    q3.run()
    assert q3.carry_groups is not None and not q3.carry_overflowed
    assert q3.pool.peak > q3.pool.reserved > 0
    # wide limbs: 60175 rows x a 10^9-scale product still fits, so narrow
    assert [a.acc_ops for a in q3.agg_exec.aggs] == [("sum", "sum")]


@pytest.mark.parametrize("num", [13, 3])
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


@pytest.mark.parametrize("num", [13, 3])
def test_run_query_against_its_own_oracle(num):
    got, want = port_plans.run_query(num, SF, tile_rows=1 << 13, device="cpu")
    pd.testing.assert_frame_equal(got, want.reset_index(drop=True), check_dtype=False, rtol=1e-9)


def test_expressions_the_two_queries_bind():
    """``not like`` over a dictionary, string equality, a date compare and
    ``coalesce`` over a nullable join output, each against numpy."""
    _, t13 = _tables(13)
    _, t3 = _tables(3)
    from velox_tpu_torch.plan import PlanBuilder

    orders, customer = t13["orders"], t3["customer"]
    words = orders.string_tables["o_comment"].values()
    import re

    rx = re.compile(".*special.*requests.*", re.DOTALL)
    keep = np.asarray([not rx.fullmatch(w) for w in words])[orders.columns["o_comment"]]
    plan = (
        PlanBuilder().table_scan(orders, filter="o_comment not like '%special%requests%'")
        .aggregation([], ["count(*) as n"]).build()
    )
    assert int(PortExecutor(plan, 1 << 12, device="cpu").run().columns["n"][0]) == int(keep.sum())
    assert 0 < keep.sum() < len(keep)

    seg = customer.string_tables["c_mktsegment"].lookup("BUILDING")
    plan = (
        PlanBuilder().table_scan(customer, filter="c_mktsegment = 'BUILDING'")
        .aggregation([], ["count(*) as n"]).build()
    )
    assert int(PortExecutor(plan, 1 << 12, device="cpu").run().columns["n"][0]) == int(
        (customer.columns["c_mktsegment"] == seg).sum()
    )

    o3 = t3["orders"]
    plan = (
        PlanBuilder().table_scan(o3, filter="o_orderdate < date '1995-03-15'")
        .aggregation([], ["count(*) as n"]).build()
    )
    cutoff = (np.datetime64("1995-03-15") - np.datetime64("1970-01-01")).astype(int)
    assert int(PortExecutor(plan, 1 << 12, device="cpu").run().columns["n"][0]) == int(
        (o3.columns["o_orderdate"] < cutoff).sum()
    )


def test_unported_queries_raise_by_name():
    assert port_plans.implemented_queries() == list(range(1, 23))
    with pytest.raises(KeyError):
        port_plans.build_query(23, {})
