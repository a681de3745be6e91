"""Sort-mode grouping of the port against the JAX package's, on the same numpy
inputs: ``SortGrouping.sort_and_group`` in its three branches (packed word,
several-key fallback, presorted), ``AggExecutor.tile_partial`` and the carry
merge, and whole grouped plans through both ``LocalExecutor``s.

Integers, dates, dictionary codes and masks agree exactly; DOUBLE results to
rtol 1e-9 (run sums are prefix-sum differences; atol 1e-6 where they cancel)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import velox_tpu as vt
import velox_tpu_torch as vtt
from velox_tpu.config import QueryConfig as RefConfig
from velox_tpu.exec import grouping as ref_grp
from velox_tpu.exec.runner import AggExecutor as RefAgg, LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.vector.column import Batch as RefBatch
from velox_tpu.vector.string_table import StringTable as RefStrings
from velox_tpu_torch.config import QueryConfig as PortConfig
from velox_tpu_torch.exec import grouping as port_grp
from velox_tpu_torch.exec import runner as port_runner
from velox_tpu_torch.exec.runner import AggExecutor as PortAgg, LocalExecutor as PortExecutor
from velox_tpu_torch.exec.runner import QueryError as PortQueryError
from velox_tpu_torch.plan import PlanBuilder as PortBuilder
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.vector.column import Batch as PortBatch

N = 4096


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _batches(seed=0, sorted_by_a=False):
    rng = np.random.default_rng(seed)
    a = rng.integers(1000, 1200, N).astype(np.int64)
    b = rng.integers(9000, 9004, N).astype(np.int32)
    if sorted_by_a:
        a = np.sort(a)
    av = rng.random(N) < 0.9
    p = rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64)
    pv = rng.random(N) < 0.8
    sel = rng.random(N) < 0.7
    names = ["a", "b", "p"]
    rb = RefBatch.from_numpy(
        vt.RowType(names, [vt.BIGINT, vt.DATE, vt.BIGINT]), [a, b, p], [av, None, pv]
    ).with_selection(jnp.asarray(sel))
    pb = PortBatch.from_numpy(
        vtt.RowType(names, [vtt.BIGINT, vtt.DATE, vtt.BIGINT]), [a, b, p], [av, None, pv],
        device="cpu",
    ).with_selection(torch.from_numpy(sel))
    return rb, pb, (a, b, av, p, pv, sel)


def _infos(grp, types, bounded, nullable_a):
    big, date = types
    ba = (1000, 1199) if bounded else None
    bb = (9000, 9003) if bounded else None
    # radix is None for these spans only through key_info's MAX_ARRAY_GROUPS
    # test on `a`; `b` is made unbounded-radix by hand so both keys sort
    ka = grp.KeyInfo("a", big, None, None, ba, nullable_a)
    kb = grp.KeyInfo("b", date, None, None, bb, False)
    return [ka, kb]


@pytest.mark.parametrize(
    "branch,nullable_a",
    [("packed", False), ("packed", True), ("fallback", False), ("presorted", False)],
)
def test_sort_and_group_matches_reference(branch, nullable_a):
    presorted = branch == "presorted"
    rb, pb, (a, b, av, p, pv, sel) = _batches(sorted_by_a=presorted)
    bounded = branch != "fallback"
    r_infos = _infos(ref_grp, (vt.BIGINT, vt.DATE), bounded, nullable_a)
    p_infos = _infos(port_grp, (vtt.BIGINT, vtt.DATE), bounded, nullable_a)
    if presorted:
        # ordered by the first key only: runs of (a, b) may split a group
        r_infos, p_infos = r_infos[:1], p_infos[:1]
    if not nullable_a:
        # a non-nullable key's validity is never consulted: drop the NULLs
        rb = rb.with_selection(jnp.asarray(av))
        pb = pb.with_selection(torch.from_numpy(av))
    rg = ref_grp.SortGrouping(r_infos, presorted)
    pg = port_grp.SortGrouping(p_infos, presorted)
    assert (pg.pack_plan(N) is None) == (rg.pack_plan(N) is None) == (branch == "fallback")
    r_pay = [rb.column("p").decode(N)[0], rb.column("p").decode(N)[1]]
    p_pay = [pb.column("p").decode(N)[0], pb.column("p").decode(N)[1]]
    rk, rp, rm, rr = rg.sort_and_group(rb, r_pay, rb.active_mask())
    pk, pp, pm, pr = pg.sort_and_group(pb, p_pay, pb.active_mask())
    n_live = int(_np(pm).sum())
    assert n_live == int(np.asarray(rm).sum())
    np.testing.assert_array_equal(_np(pm), np.asarray(rm))
    # live rows: same keys, same payloads, same order (the sort is stable and
    # the packed word carries the row id)
    live = _np(pm)
    for g, w in zip(list(pk) + list(pp), list(rk) + list(rp)):
        np.testing.assert_array_equal(_np(g)[live], np.asarray(w)[live])
    n = int(pr.num_runs)
    assert n == int(rr.num_runs)
    np.testing.assert_array_equal(_np(pr.boundary), np.asarray(rr.boundary))
    np.testing.assert_array_equal(_np(pr.end_positions), np.asarray(rr.end_positions))
    for g, w in zip(pg.group_keys(pk, pr), rg.group_keys(rk, rr)):
        np.testing.assert_array_equal(_np(g)[:n], np.asarray(w)[:n])
    if nullable_a:
        # NULL keys form ONE group per value of b, at the null code
        null_value = pg.pack_plan(N).null_value(0)
        got_a = _np(pg.group_keys(pk, pr)[0])[:n]
        rows = sel & ~av
        assert (got_a == null_value).sum() == len(np.unique(b[rows]))


def _tables(n=6000, seed=11, n_groups=900):
    rng = np.random.default_rng(seed)
    cols = {
        "k": rng.integers(0, n_groups, n).astype(np.int64),
        "dt": rng.integers(9000, 9400, n).astype(np.int32),
        "city": rng.integers(1, 5, n).astype(np.int32),
        "u": rng.integers(-(1 << 50), 1 << 50, n).astype(np.int64),
        "d": rng.integers(0, 10**9, n).astype(np.int64),
        "x": rng.normal(0, 100, n),
        "z": rng.integers(0, 4, n).astype(np.int64),
        "g": (rng.integers(0, 60, n) * 5).astype(np.int64),  # span 296: past array mode
        # 40 distinct values spread over 62 bits: no packed word can hold it
        "w": rng.integers(-(1 << 61), 1 << 61, 40)[rng.integers(0, 40, n)].astype(np.int64),
    }
    validities = {
        "k": rng.random(n) < 0.95, "d": rng.random(n) < 0.9, "w": rng.random(n) < 0.9,
    }
    names = list(cols)
    types = ["BIGINT", "DATE", "VARCHAR", "BIGINT", "DECIMAL(15,2)", "DOUBLE", "BIGINT", "BIGINT", "BIGINT"]
    cities = ["", "lyon", "oslo", "rome", "bern"]
    port = table_from_numpy(names, types, cols, {"city": cities}, validities)
    ref = RefTable(
        vt.RowType(
            names,
            [vt.BIGINT, vt.DATE, vt.VARCHAR, vt.BIGINT, vt.decimal(15, 2), vt.DOUBLE, vt.BIGINT,
             vt.BIGINT, vt.BIGINT],
        ),
        dict(cols), {"city": RefStrings.from_values(cities)}, dict(validities),
    )
    return ref, port


_AGGS = [
    "count(*) as n", "count(d) as nd", "sum(d) as sd", "sum(u) as su", "avg(d) as ad",
    "min(u) as lo", "max(dt) as last", "sum(x) as sx", "min(x) as mx", "max(city) as c",
]

_PLANS = {
    # few groups: the carry sized from tile 0 holds them all
    "packed_small": (["g", "city"], "z < 3"),
    # nullable bounded key + date: packed word with a null code
    "packed_nullable": (["k", "dt"], "z < 3"),
    # dictionary key + bounded keys
    "packed_strings": (["city", "dt", "k"], None),
    # a key too wide for the word: several-key fallback + the null-bits key
    "fallback_nullbits": (["w", "dt"], "z < 3"),
}


def _plan(builder, table, which):
    keys, flt = _PLANS[which]
    b = builder().table_scan(table, filter=flt)
    return b.aggregation(keys, _AGGS).orderby(list(keys)).build()


def _same_table(got, want):
    assert list(got.schema.names) == list(want.schema.names)
    assert [str(t) for t in got.schema.types] == [str(t) for t in want.schema.types]
    assert got.num_rows == want.num_rows
    assert set(got.validities) == set(want.validities)
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        valid = want.validities.get(name)
        if valid is not None:
            np.testing.assert_array_equal(got.validities[name], valid, err_msg=name)
            g, w = g[valid], w[valid]
        if dtype.is_string:
            assert list(got.string_tables[name].decode(g)) == list(
                want.string_tables[name].decode(w)
            ), name
        elif dtype.is_floating:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-6, err_msg=name)
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("tile_rows", [1 << 10, 1 << 20])
@pytest.mark.parametrize("which", list(_PLANS))
def test_sort_agg_plan_matches_reference(which, tile_rows):
    ref_t, port_t = _tables()
    ref = RefExecutor(_plan(RefBuilder, ref_t, which), tile_rows=tile_rows)
    port = PortExecutor(_plan(PortBuilder, port_t, which), tile_rows=tile_rows, device="cpu")
    assert port.kind == ref.kind == "sort_agg_device"
    assert port.agg_exec.mode == ref.agg_exec.mode == "sort"
    assert [k.name for k in port.agg_exec.key_infos] == [k.name for k in ref.agg_exec.key_infos]
    assert [(k.bounds, k.nullable) for k in port.agg_exec.key_infos] == [
        (k.bounds, k.nullable) for k in ref.agg_exec.key_infos
    ]
    packed = port.agg_exec.grouping.pack_plan(port.capacity) is not None
    assert packed == (which != "fallback_nullbits")
    assert (port.agg_exec.key_infos[-1].name == "__nullbits__") == (not packed)
    _same_table(port.run(), ref.run())


@pytest.mark.parametrize("which", list(_PLANS))
def test_one_tile_equals_many_tiles(which):
    _, port_t = _tables()
    plan = _plan(PortBuilder, port_t, which)
    one = PortExecutor(plan, tile_rows=1 << 20, device="cpu")
    many = PortExecutor(plan, tile_rows=1 << 10, device="cpu")
    assert one.source_table.num_tiles(one.capacity) == 1
    assert many.source_table.num_tiles(many.capacity) == 6
    a, b = one.run(), many.run()
    assert one.carry_groups is None and many.carry_groups is not None
    # 240 groups fit the carry; the plans with thousands overflow it and are
    # merged on the host
    assert many.carry_overflowed == (which != "packed_small")
    _same_table(b, a)


@pytest.mark.parametrize("which", ["packed_nullable", "fallback_nullbits"])
def test_host_merge_kind_gives_the_same_rows(which):
    ref_t, port_t = _tables()
    device_kind = PortExecutor(_plan(PortBuilder, port_t, which), tile_rows=1 << 10, device="cpu")
    host_kind = PortExecutor(
        _plan(PortBuilder, port_t, which), tile_rows=1 << 10, device="cpu",
        config=PortConfig(device_agg_merge=False),
    )
    ref_host = RefExecutor(
        _plan(RefBuilder, ref_t, which), tile_rows=1 << 10,
        config=RefConfig(device_agg_merge=False),
    )
    assert host_kind.kind == ref_host.kind == "sort_agg"
    want = device_kind.run()
    _same_table(host_kind.run(), want)
    _same_table(host_kind.run(), ref_host.run())


def test_carry_overflow_falls_back_to_host_merge():
    """Tile 0 holds few groups, later tiles many: the carry sized from tile 0
    overflows, the device flags it, and the host merge gives the same rows."""
    n = 8192
    rng = np.random.default_rng(3)
    k = np.concatenate([rng.integers(0, 4, 1024), rng.integers(0, 3000, n - 1024)]).astype(np.int64)
    u = rng.integers(-1000, 1000, n).astype(np.int64)
    port_t = table_from_numpy(["k", "u"], ["BIGINT", "BIGINT"], {"k": k, "u": u})
    ref_t = RefTable(vt.RowType(["k", "u"], [vt.BIGINT, vt.BIGINT]), {"k": k, "u": u})

    def plan(builder, t):
        return builder().table_scan(t).aggregation(["k"], ["sum(u) as s", "count(*) as n"]).orderby(["k"]).build()

    port = PortExecutor(plan(PortBuilder, port_t), tile_rows=1024, device="cpu")
    calls = []
    orig = port._run_sort_agg_host
    port._run_sort_agg_host = lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1]
    got = port.run()
    assert calls == [1] and port.carry_groups == 16
    # the fallback reports its own group count, and nothing stays reserved
    assert port.carry_overflowed and port.groups_out == got.num_rows == len(np.unique(k))
    assert port.pool.reserved == 0
    want = RefExecutor(plan(RefBuilder, ref_t), tile_rows=1024).run()
    _same_table(got, want)
    expect = {key: (u[k == key].sum(), (k == key).sum()) for key in np.unique(k)}
    assert {
        int(a): (int(b), int(c))
        for a, b, c in zip(got.columns["k"], got.columns["s"], got.columns["n"])
    } == {int(a): (int(b), int(c)) for a, (b, c) in expect.items()}


def test_failing_tile_leaves_nothing_reserved(monkeypatch):
    """An error inside the merge loop releases the carry's reservation, and
    the next run starts from clean run facts."""
    _, port_t = _tables()
    ex = PortExecutor(_plan(PortBuilder, port_t, "packed_small"), tile_rows=1 << 10, device="cpu")
    want = ex.run()
    assert ex.groups_out == want.num_rows and ex.pool.reserved == 0
    real = ex.agg_exec.merge_partial_into_carry
    seen = []

    def failing(state, partial):
        seen.append(ex.pool.reserved)
        if len(seen) == 3:
            raise RuntimeError("tile failed")
        return real(state, partial)

    monkeypatch.setattr(ex.agg_exec, "merge_partial_into_carry", failing)
    with pytest.raises(RuntimeError, match="tile failed"):
        ex.run()
    assert all(r > 0 for r in seen) and ex.pool.reserved == 0
    assert ex.groups_out is None
    monkeypatch.undo()
    _same_table(ex.run(), want)
    assert ex.groups_out == want.num_rows and ex.pool.reserved == 0


def test_no_host_read_inside_the_tile_loop(monkeypatch):
    """The sorted-carry path reads the device three times whatever the tile
    count: tile 0's run count, the final scalars, the live prefix."""
    reads = []
    real = port_runner.fetch_tree

    def counting(tree):
        reads.append(1)
        return real(tree)

    monkeypatch.setattr(port_runner, "fetch_tree", counting)

    def counting_prefix(arrays, n):
        reads.append(1)
        return [real(a[:n]) for a in arrays]

    monkeypatch.setattr(port_runner, "fetch_prefix", counting_prefix)
    counts = {}
    for n_rows in (6000, 12000):
        _, port_t = _tables(n=n_rows)
        ex = PortExecutor(_plan(PortBuilder, port_t, "packed_small"), tile_rows=1 << 10, device="cpu")
        reads.clear()
        ex.run()
        assert not ex.carry_overflowed
        counts[ex.source_table.num_tiles(ex.capacity)] = len(reads)
    tiles = sorted(counts)
    assert tiles == [6, 12]
    assert counts[6] == counts[12] == 3


def test_wide_sum_limbs_through_the_carry():
    """Sums that pass int64 keep exact (hi, lo, count) limbs through run
    reductions and carry merges: the first two of four tiles hold values
    near 2^62 whose partial sums a group pass int64 in the carry, the last
    two their negations plus a small remainder, so every total is back in
    range and comes out exact.  A total past int64 is Presto's overflow
    error (``NUMERIC_VALUE_OUT_OF_RANGE``) where the sum is finalised; until
    that check the port kept order and rounded such a total to float64."""
    n = 4096
    rng = np.random.default_rng(8)
    k_half = rng.integers(0, 600, n // 2).astype(np.int64)
    u_half = rng.integers((1 << 62) - 1000, 1 << 62, n // 2).astype(np.int64)
    k = np.concatenate([k_half, k_half])
    u = np.concatenate([u_half, -u_half + rng.integers(-50, 50, n // 2)])
    port_t = table_from_numpy(["k", "u"], ["BIGINT", "BIGINT"], {"k": k, "u": u})
    plan = PortBuilder().table_scan(port_t).aggregation(["k"], ["sum(u) as s"]).orderby(["k"]).build()
    ex = PortExecutor(plan, tile_rows=1024, device="cpu")
    assert ex.agg_exec.aggs[0].acc_ops == ("sum", "sum", "sum")
    got = ex.run()
    assert ex.carry_groups and not ex.carry_overflowed  # merged through the device carry
    partial = [sum(int(v) for v in u_half[k_half == key]) for key in np.unique(k_half)]
    assert max(partial) > np.iinfo(np.int64).max  # the carry held sums past int64
    exact = [sum(int(v) for v in u[k == key]) for key in np.unique(k)]
    np.testing.assert_array_equal(np.asarray(got.columns["s"]), np.asarray(exact, dtype=np.int64))
    one = PortExecutor(plan, tile_rows=1 << 20, device="cpu").run()
    np.testing.assert_array_equal(np.asarray(one.columns["s"]), np.asarray(got.columns["s"]))
    past = table_from_numpy(["k", "u"], ["BIGINT", "BIGINT"], {"k": k_half, "u": u_half})
    plan = PortBuilder().table_scan(past).aggregation(["k"], ["sum(u) as s"]).orderby(["k"]).build()
    with pytest.raises(PortQueryError, match="NUMERIC_VALUE_OUT_OF_RANGE"):
        PortExecutor(plan, tile_rows=1024, device="cpu").run()


def test_tile_partial_and_carry_merge_match_reference():
    """AggExecutor level: one tile's partial groups, then two partials merged
    into a carry of 2048 slots, against the JAX package's functions."""
    ref_t, port_t = _tables(n=2048, n_groups=300)

    def node(builder, t):
        return (
            builder().table_scan(t)
            .aggregation(["k", "dt"], ["sum(d) as sd", "min(u) as lo", "count(*) as n"])
            .build()
        )

    r_ex = RefAgg(node(RefBuilder, ref_t), 1024)
    p_ex = PortAgg(node(PortBuilder, port_t), 1024)
    r_state, p_state = r_ex.init_sorted_carry(2048), p_ex.init_sorted_carry(2048, "cpu")
    for i in range(2):
        rp = r_ex.tile_partial(ref_t.tile(i, 1024))
        pp = p_ex.tile_partial(port_t.tile(i, 1024, "cpu"))
        n = int(pp[2])
        assert n == int(rp[2])
        for g, w in zip(list(pp[0]) + [a for acc in pp[1] for a in acc],
                        list(rp[0]) + [a for acc in rp[1] for a in acc]):
            np.testing.assert_array_equal(_np(g)[:n], np.asarray(w)[:n])
        r_state = r_ex.merge_partial_into_carry(r_state, rp)
        p_state = p_ex.merge_partial_into_carry(p_state, pp)
        n = int(p_state[2])
        assert n == int(r_state[2]) and int(p_state[3]) == int(r_state[3]) == 0
        for g, w in zip(list(p_state[0]) + [a for acc in p_state[1] for a in acc],
                        list(r_state[0]) + [a for acc in r_state[1] for a in acc]):
            np.testing.assert_array_equal(_np(g)[:n], np.asarray(w)[:n])
