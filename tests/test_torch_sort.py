"""The device OrderBy / TopN of the port against the JAX package's, on the same
numpy inputs: the order-preserving int64 operands, the per-tile sorted prefix,
the merge of sorted chunks, collect pipelines with a leading OrderBy / TopN /
OrderBy+Limit through both ``LocalExecutor``s, and the device TopN over
aggregation outputs.  Rows agree exactly and in order: ties are broken by
input position in both packages (every sort is stable)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import velox_tpu as vt
import velox_tpu_torch as vtt
from velox_tpu.exec import sort as ref_sort
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.plan.nodes import SortKey as RefKey
from velox_tpu.vector.column import Batch as RefBatch
from velox_tpu.vector.string_table import StringTable as RefStrings
from velox_tpu_torch.exec import sort as port_sort
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor
from velox_tpu_torch.exec.runner import QueryError as PortQueryError
from velox_tpu_torch.plan import PlanBuilder as PortBuilder
from velox_tpu_torch.plan.nodes import SortKey as PortKey
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.vector.column import Batch as PortBatch

N = 3000
_NAMES = ["a", "x", "s", "d", "z", "g"]
_WORDS = ["", "pear", "apple", "fig", "Zucchini", "banana"]


def _cols(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 5, N).round(1)  # many ties
    x[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan]
    cols = {
        "a": rng.integers(-5, 5, N).astype(np.int64),
        "x": x,
        "s": rng.integers(1, 6, N).astype(np.int32),
        "d": rng.integers(9000, 9010, N).astype(np.int32),
        "z": rng.integers(0, 3, N).astype(np.int64),
        "g": (rng.integers(0, 40, N) * 10).astype(np.int64),  # span 391: sort mode
    }
    cols["a"][:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    validities = {"a": rng.random(N) < 0.9, "x": rng.random(N) < 0.9}
    return cols, validities


def _tables(sums_in_range=False):
    """``sums_in_range``: the row holding int64's minimum takes that minimum
    + 16, so that the one group whose sum(a) passed int64 (-2^63 - 16) sums
    to -2^63 exactly: in range, where Presto (and the port) raise otherwise."""
    cols, validities = _cols()
    if sums_in_range:
        cols["a"][0] += 16
    port = table_from_numpy(
        _NAMES, ["BIGINT", "DOUBLE", "VARCHAR", "DATE", "BIGINT", "BIGINT"], cols, {"s": _WORDS}, validities
    )
    ref = RefTable(
        vt.RowType(_NAMES, [vt.BIGINT, vt.DOUBLE, vt.VARCHAR, vt.DATE, vt.BIGINT, vt.BIGINT]),
        dict(cols), {"s": RefStrings.from_values(_WORDS)}, dict(validities),
    )
    return ref, port


def _same_rows(got, want):
    """Row-exact, NaN == NaN, -0.0 and +0.0 told apart by the bits."""
    assert list(got.schema.names) == list(want.schema.names)
    assert got.num_rows == want.num_rows
    assert set(got.validities) == set(want.validities)
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        valid = want.validities.get(name)
        if valid is not None:
            np.testing.assert_array_equal(got.validities[name], valid, err_msg=name)
            g, w = g[valid], w[valid]
        if dtype.is_string:
            g, w = got.string_tables[name].decode(g), want.string_tables[name].decode(w)
        assert g.dtype == w.dtype or dtype.is_string, name
        if dtype.is_floating:
            g, w = g.view(np.int64), w.view(np.int64)
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_float_to_ordered_i64():
    x = np.asarray(
        [0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, np.nan, -np.nan, 3e-308, -3e-308, 1e308, -1e308]
    )
    want = np.asarray(ref_sort.float_to_ordered_i64(jnp.asarray(x)))
    got = port_sort.float_to_ordered_i64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[1]  # one code for both zeros
    assert got[6] == got[7] > got[4]  # NaN above +inf, one code
    order = np.argsort(got, kind="stable")
    finite = x[order][~np.isnan(x[order])]
    assert (np.diff(finite) >= 0).all()
    # subnormals keep their order here (XLA on the CPU flushes them to zero,
    # so they are left out of the comparison above)
    tiny = port_sort.float_to_ordered_i64(torch.tensor([-5e-324, 0.0, 5e-324], dtype=torch.float64))
    assert tiny.tolist() == [-2, 0, 1]


@pytest.mark.parametrize("nulls_first", [False, True])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("column", ["a", "x", "s", "d"])
def test_sort_operand(column, ascending, nulls_first):
    cols, validities = _cols()
    values, validity = cols[column], validities.get(column)
    ranks = None
    if column == "s":
        ranks = np.asarray(RefStrings.from_values(_WORDS).sort_permutation(), np.int32)
    want = ref_sort.sort_operand(
        jnp.asarray(values), None if validity is None else jnp.asarray(validity),
        RefKey(column, ascending, nulls_first), ranks,
    )
    got = port_sort.sort_operand(
        torch.from_numpy(values), None if validity is None else torch.from_numpy(validity),
        PortKey(column, ascending, nulls_first), ranks,
    )
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if validity is not None:
        nulls = got.numpy()[~validity]
        rest = got.numpy()[validity]
        assert (nulls <= rest.min()).all() if nulls_first else (nulls >= rest.max()).all()


def _batches(sel):
    cols, validities = _cols()
    arrays = [cols[n] for n in _NAMES]
    vals = [validities.get(n) for n in _NAMES]
    r_tab, p_tab = RefStrings.from_values(_WORDS), None
    rb = RefBatch.from_numpy(
        vt.RowType(_NAMES, [vt.BIGINT, vt.DOUBLE, vt.VARCHAR, vt.DATE, vt.BIGINT, vt.BIGINT]),
        arrays, vals, [None, None, r_tab, None, None, None], capacity=4096,
    ).with_selection(jnp.asarray(sel))
    from velox_tpu_torch.vector.string_table import StringTable

    p_tab = StringTable.from_values(_WORDS)
    pb = PortBatch.from_numpy(
        vtt.RowType(_NAMES, [vtt.BIGINT, vtt.DOUBLE, vtt.VARCHAR, vtt.DATE, vtt.BIGINT, vtt.BIGINT]),
        arrays, vals, [None, None, p_tab, None, None, None], capacity=4096, device="cpu",
    ).with_selection(torch.from_numpy(sel))
    return rb, pb, (r_tab, p_tab)


_KEYSETS = {
    "asc_desc": [("a", True, False), ("x", False, False)],
    "nulls_first": [("x", True, True), ("a", False, True)],
    "strings_ties": [("s", True, False), ("d", False, False)],  # ties by position
}


@pytest.mark.parametrize("keep", [None, 16, 5000])
@pytest.mark.parametrize("keyset", list(_KEYSETS))
def test_tile_sorted_prefix_and_merge(keyset, keep):
    rng = np.random.default_rng(1)
    sel = np.concatenate([rng.random(N) < 0.7, np.zeros(4096 - N, bool)])
    rb, pb, (r_tab, p_tab) = _batches(sel)
    r_schema, p_schema = rb.schema, pb.schema
    r_spec = ref_sort.SortSpec.plan(
        [RefKey(*k) for k in _KEYSETS[keyset]], r_schema, {"s": r_tab}
    )
    p_spec = port_sort.SortSpec.plan(
        [PortKey(*k) for k in _KEYSETS[keyset]], p_schema, {"s": p_tab}
    )
    assert p_spec.key_indices == r_spec.key_indices
    r_arr, r_layout, r_n = ref_sort.tile_sorted_prefix(r_spec, rb, keep)
    p_arr, p_layout, p_n = port_sort.tile_sorted_prefix(p_spec, pb, keep)
    n = int(p_n)
    assert n == int(r_n) == (int(sel.sum()) if keep is None else min(int(sel.sum()), keep))
    assert list(p_layout) == list(r_layout)
    for g, w in zip(p_arr, r_arr):
        assert g.shape[0] == w.shape[0]
        np.testing.assert_array_equal(g.numpy()[:n], np.asarray(w)[:n])
    # merge this chunk with itself: every row twice, equal rows adjacent
    r_m, r_live = ref_sort.merge_sorted_chunks(r_spec, [r_arr, r_arr], [r_n, r_n], r_layout, keep)
    p_m, p_live = port_sort.merge_sorted_chunks(p_spec, [p_arr, p_arr], [p_n, p_n], p_layout, keep)
    m = int(p_live)
    assert m == int(r_live)
    for g, w in zip(p_m, r_m):
        np.testing.assert_array_equal(g.numpy()[:m], np.asarray(w)[:m])


def _collect_plan(builder, table, finish):
    b = builder().table_scan(table, filter="z < 2").project(["a", "x", "s", "d"])
    return finish(b).build()


_FINISH = {
    "orderby": lambda b: b.orderby(["s", "a desc nulls first", "x"]),
    "orderby_ties": lambda b: b.orderby(["d"]),
    "topn": lambda b: b.topn(["x desc", "a", "s"], 25),
    "topn_more_than_rows": lambda b: b.topn(["a", "d desc"], 100000),
    "orderby_limit": lambda b: b.orderby(["d desc", "s"]).limit(40, 3),
}


@pytest.mark.parametrize("tile_rows", [1 << 10, 1 << 20])
@pytest.mark.parametrize("finish", list(_FINISH))
def test_collect_sorted_plan_matches_reference(finish, tile_rows):
    ref_t, port_t = _tables()
    ref = RefExecutor(_collect_plan(RefBuilder, ref_t, _FINISH[finish]), tile_rows=tile_rows)
    port = PortExecutor(
        _collect_plan(PortBuilder, port_t, _FINISH[finish]), tile_rows=tile_rows, device="cpu"
    )
    assert port.kind == ref.kind == "collect"
    assert (port._device_sort is not None) and (ref._device_sort is not None)
    assert port._device_sort[1] == ref._device_sort[1]
    got = port.run()
    _same_rows(got, ref.run())
    if finish == "topn_more_than_rows":
        assert got.num_rows == int((port_t.columns["z"] < 2).sum())


def test_plain_collect_and_run_device():
    """No finisher: rows come back in scan order, tile by tile; ``run_device``
    keeps the same rows on the device as compacted batches.  An aggregation's
    ``run_device`` uploads what ``run`` returns, in one tile."""
    ref_t, port_t = _tables()
    plan = lambda b, t: b().table_scan(t, filter="z < 2").project(["a", "x", "s"]).build()  # noqa: E731
    port = PortExecutor(plan(PortBuilder, port_t), tile_rows=1 << 10, device="cpu")
    got = port.run()
    _same_rows(got, RefExecutor(plan(RefBuilder, ref_t), tile_rows=1 << 10).run())
    keep = port_t.columns["z"] < 2
    np.testing.assert_array_equal(got.columns["a"], port_t.columns["a"][keep])
    batches, errs = port.run_device()
    assert len(batches) == len(errs) == 3 and all(b.selection is None for b in batches)
    assert sum(int(b.length) for b in batches) == int(keep.sum())
    agg = PortBuilder().table_scan(port_t).aggregation(["a"], ["count(*) as n"]).build()
    agg_ex = PortExecutor(agg, device="cpu")
    [tile], errs = agg_ex.run_device()
    want = agg_ex.run()
    assert errs == () and tile.capacity == 1024 and int(tile.length) == want.num_rows
    for name in ("a", "n"):
        values, _ = tile.column(name).decode(tile.capacity)
        np.testing.assert_array_equal(values[: want.num_rows].numpy(), want.columns[name])


def test_string_key_without_a_dictionary_falls_back_to_the_host_finisher():
    _, port_t = _tables()
    spec = port_sort.SortSpec.plan([PortKey("s")], port_t.schema, {})
    assert spec is None
    assert port_sort.SortSpec.plan([PortKey("nope")], port_t.schema, {}) is None


@pytest.mark.parametrize(
    "keys,k",
    [(["total desc", "g"], 5), (["lo", "s desc"], 3), (["n desc", "sx"], 4), (["total"], 1000)],
)
def test_device_topn_over_aggregation_outputs(keys, k):
    def plan(builder, t):
        return (
            builder().table_scan(t)
            .aggregation(["g", "s"], ["sum(a) as total", "min(a) as lo", "count(*) as n", "sum(x) as sx"])
            .topn(keys, k)
            .build()
        )

    # over _cols() as they are, one group's sum(a) is -2^63 - 16: Presto's
    # overflow error, raised where the sum is finalised (the JAX package
    # wraps it); the TopN is held on the same rows with that sum in range
    _, overflowing = _tables()
    with pytest.raises(PortQueryError, match="NUMERIC_VALUE_OUT_OF_RANGE"):
        PortExecutor(plan(PortBuilder, overflowing), tile_rows=1 << 10, device="cpu").run()
    ref_t, port_t = _tables(sums_in_range=True)

    ref = RefExecutor(plan(RefBuilder, ref_t), tile_rows=1 << 10)
    port = PortExecutor(plan(PortBuilder, port_t), tile_rows=1 << 10, device="cpu")
    assert port.kind == ref.kind == "sort_agg_device"
    topn = port._device_topn_plan()
    assert topn is not None and topn[0] == k == ref._device_topn_k()
    got = port.run()
    want = ref.run()
    # float sums: same rows in the same order, values to rtol 1e-9
    assert got.num_rows == want.num_rows == min(k, 200)
    for name in ("g", "s", "total", "lo", "n"):
        valid = want.validities.get(name)
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        if valid is not None:
            np.testing.assert_array_equal(got.validities[name], valid)
            g, w = g[valid], w[valid]
        np.testing.assert_array_equal(g, w, err_msg=name)
    # sum(x) over a group holds only its own rows' x in the port.  The JAX
    # package takes prefix-sum differences, so the inf and -inf of x's first
    # rows turn every later group's sum into NaN there: its known-wrong
    # values, asserted as such where they differ from the groups' own sums
    cols, validities = _cols()
    x = np.where(validities["x"], cols["x"], 0.0)
    own = np.array([
        x[(cols["g"] == g) & (cols["s"] == s)].sum()
        for g, s in zip(np.asarray(got.columns["g"]), np.asarray(got.columns["s"]))
    ])
    sx, ref_sx = np.asarray(got.columns["sx"]), np.asarray(want.columns["sx"])
    np.testing.assert_allclose(sx, own, rtol=1e-9, atol=1e-6)
    ref_off = ~np.isclose(ref_sx, own, rtol=1e-9, atol=1e-6, equal_nan=True)
    assert np.isnan(ref_sx[ref_off]).all() and not np.isnan(own[ref_off]).any()
    # and the host finisher alone gives the same rows
    host = PortExecutor(plan(PortBuilder, port_t), tile_rows=1 << 10, device="cpu")
    host._device_topn = False
    np.testing.assert_array_equal(host.run().columns["total"], got.columns["total"])


def test_topn_on_an_average_stays_on_the_host():
    _, port_t = _tables()
    plan = (
        PortBuilder().table_scan(port_t)
        .aggregation(["g", "s"], ["avg(a) as m"]).topn(["m desc"], 3).build()
    )
    ex = PortExecutor(plan, tile_rows=1 << 10, device="cpu")
    assert ex._device_topn_plan() is None
    assert ex.run().num_rows == 3
