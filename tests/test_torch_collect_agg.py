"""Collect aggregates of the port against the JAX package's: the cases of
``tests/test_collect_agg.py`` — array_agg, set_agg, map_agg, histogram and
map_union beside classic aggregates, global and NULL inputs, several tiles,
after a filter, entropy, multimap_agg, reduce_agg and the lowering of
approx_most_frequent, and approx_percentile beside them (a mixed node the
sketch rewrite splits, each percentile through the KLL rewrite) — on the
same rows, with the reference test's expected rows.  Grouping keys that hold NULLs are held to expected rows: the
JAX package assembles the groups by the raw key values and merges a NULL key
into the group of the value under it (ROADMAP Queue 3)."""

import numpy as np
import pytest

from test_torch_complex import PORT, REF
from velox_tpu_torch.testing import assert_same_values, python_rows


def make_table(k):
    st, st2 = k.Strings(), k.Strings()
    return k.Table(
        k.t.RowType(["g", "x", "k"], [k.t.VARCHAR, k.t.BIGINT, k.t.VARCHAR]),
        {
            "g": st.intern_all(["a", "b", "a", "b", "a"]),
            "x": np.array([3, 1, 2, 4, 2], np.int64),
            "k": st2.intern_all(["p", "q", "r", "q", "p"]),
        },
        {"g": st, "k": st2},
    )


def _both(make, key, tile_rows=1 << 20):
    """The plan ``make(k)`` through both packages, rows sorted by ``key``;
    asserts they agree and returns the port's."""
    def rows(k):
        out = python_rows(k.run(make(k), tile_rows))
        order = sorted(range(len(out[key])), key=lambda i: repr(out[key][i]))
        return {c: [v[i] for i in order] for c, v in out.items()}

    got, want = rows(PORT), rows(REF)
    assert list(got) == list(want)
    for col in want:
        assert_same_values(got[col], want[col], path=col)
    return got


def test_collect_aggregates_grouped():
    out = _both(lambda k: k.B().table_scan(make_table(k)).aggregation(["g"], [
        "array_agg(x) as ax", "set_agg(x) as sx", "map_agg(k, x) as mk", "histogram(x) as h",
        "count(x) as c", "sum(x) as s", "min(k) as mnk", "max(x) as mx", "avg(x) as av",
    ]).build(), "g")
    assert out["g"] == ["a", "b"]
    assert out["ax"] == [[3, 2, 2], [1, 4]]
    assert out["sx"] == [[2, 3], [1, 4]]
    assert out["mk"] == [{"p": 3, "r": 2}, {"q": 1}]
    assert out["h"] == [{2: 2, 3: 1}, {1: 1, 4: 1}]
    assert out["c"] == [3, 2]
    assert out["s"] == [7, 5]
    assert out["mnk"] == ["p", "q"]
    assert out["mx"] == [3, 4]
    assert out["av"] == [7 / 3, 2.5]


def test_collect_aggregates_global_and_nulls():
    def make(k):
        t = k.Table(
            k.t.RowType(["x"], [k.t.BIGINT]), {"x": np.array([5, 7, 5], np.int64)},
            validities={"x": np.array([True, True, False])},
        )
        return k.B().table_scan(t).aggregation([], ["array_agg(x) as ax", "set_agg(x) as sx"]).build()

    out = _both(make, "ax")
    # Presto array_agg keeps NULLs; set_agg keeps one NULL
    assert out["ax"] == [[5, 7, None]]
    assert out["sx"] == [[5, 7, None]]


def test_map_union():
    def make(k):
        mt = k.t.map_(k.t.VARCHAR, k.t.BIGINT)
        seg, _ = k.Seg.from_pylist([{"a": 1}, {"b": 2}, {"a": 9, "c": 3}], mt)
        t = k.Table(k.t.RowType(["g", "m"], [k.t.BIGINT, mt]),
                    {"g": np.array([1, 1, 2], np.int64), "m": seg})
        return k.B().table_scan(t).aggregation(["g"], ["map_union(m) as mu"]).build()

    assert _both(make, "g")["mu"] == [{"a": 1, "b": 2}, {"a": 9, "c": 3}]


@pytest.mark.parametrize("tile_rows", [1024, 1 << 14])
def test_collect_agg_multi_tile(tile_rows):
    rng = np.random.default_rng(0)
    g = rng.integers(0, 7, 5000)
    x = rng.integers(0, 100, 5000)

    def make(k):
        t = k.Table(k.t.RowType(["g", "x"], [k.t.BIGINT, k.t.BIGINT]), {"g": g, "x": x})
        return k.B().table_scan(t).aggregation(["g"], ["array_agg(x) as ax", "sum(x) as s"]).build()

    out = _both(make, "g", tile_rows)
    assert out["g"] == sorted(set(g.tolist()))
    for gid, ax, s in zip(out["g"], out["ax"], out["s"]):
        # each group keeps the input order of its rows
        assert ax == x[g == gid].tolist() and s == x[g == gid].sum()


def test_most_frequent_and_percentile():
    def make(k, aggs):
        st = k.Strings()
        t = k.Table(
            k.t.RowType(["g", "x", "s"], [k.t.BIGINT, k.t.BIGINT, k.t.VARCHAR]),
            {
                "g": np.array([1, 1, 1, 1, 2, 2], np.int64),
                "x": np.array([10, 20, 30, 40, 5, 7], np.int64),
                "s": st.intern_all(["a", "a", "b", "a", "c", "c"]),
            },
            {"s": st},
        )
        return k.B().table_scan(t).aggregation(["g"], aggs).build()

    out = _both(lambda k: make(k, [
        "approx_percentile(x, 0.5) as p50", "approx_percentile(x, 0.99) as p99",
        "approx_most_frequent(1, s, 10) as top1", "approx_most_frequent(2, x, 10) as top2",
    ]), "g")
    # a few rows a group: the rank-compressed ECDF keeps every row, exact
    assert out["p50"] == [30, 7]
    assert out["p99"] == [40, 7]
    assert out["top1"] == [{"a": 3}, {"c": 2}]
    assert out["top2"] == [{10: 1, 20: 1}, {5: 1, 7: 1}]


def test_right_join_rewrite():
    def make(k):
        left = k.Table(k.t.RowType(["k", "lx"], [k.t.BIGINT, k.t.BIGINT]),
                       {"k": np.array([1, 2], np.int64), "lx": np.array([10, 20], np.int64)})
        right = k.Table(k.t.RowType(["rk", "ry"], [k.t.BIGINT, k.t.BIGINT]),
                        {"rk": np.array([2, 3], np.int64), "ry": np.array([200, 300], np.int64)})
        return (
            k.B().table_scan(left)
            .hash_join(k.B().table_scan(right).build(), ["k"], ["rk"],
                       output=["lx", "rk", "ry"], join_type="right")
            .build()
        )

    out = _both(make, "ry")
    assert out["ry"] == [200, 300] and out["lx"] == [20, None]


def test_array_agg_after_filter():
    out = _both(lambda k: (
        k.B().table_scan(make_table(k)).filter("x >= 2")
        .aggregation(["g"], ["array_agg(x) as ax"]).build()
    ), "g")
    assert out["ax"] == [[3, 2, 2], [4]]


def _gx(k, g, x):
    return k.Table(k.t.RowType(["g", "x"], [k.t.BIGINT, k.t.BIGINT]),
                   {"g": np.array(g, np.int64), "x": np.array(x, np.int64)})


def test_entropy():
    out = _both(lambda k: (
        k.B().table_scan(_gx(k, [1, 1, 1, 1, 2, 2], [1, 1, 2, 2, 5, 5]))
        .aggregation(["g"], ["entropy(x) as e"]).build()
    ), "g")
    # group 1: two values 50/50 -> 1 bit; group 2: one value -> 0 bits
    assert out["e"] == [1.0, 0.0]


def test_reduce_agg():
    out = _both(lambda k: (
        k.B().table_scan(_gx(k, [1, 1, 2, 2, 2], [3, 4, 5, 6, 7]))
        .aggregation(["g"], [
            "reduce_agg(x, 1, (s, e) -> s * e, (a, b) -> a * b) as prod", "sum(x) as s",
        ]).build()
    ), "g")
    assert out["prod"] == [12, 210] and out["s"] == [7, 18]


def test_multimap_agg():
    def make(k):
        st = k.Strings()
        t = k.Table(
            k.t.RowType(["g", "k", "v"], [k.t.BIGINT, k.t.VARCHAR, k.t.BIGINT]),
            {"g": np.array([1, 1, 1, 2], np.int64), "k": st.intern_all(["a", "a", "b", "c"]),
             "v": np.array([10, 11, 20, 30], np.int64)},
            {"k": st},
        )
        return k.B().table_scan(t).aggregation(["g"], ["multimap_agg(k, v) as mm"]).build()

    assert _both(make, "g")["mm"] == [{"a": [10, 11], "b": [20]}, {"c": [30]}]


def test_approx_most_frequent_bounded_lowering():
    """The lone approx_most_frequent lowers onto count -> windowed top-k ->
    map_agg, so the host assembles groups x buckets rows (the cut is exact)."""
    from velox_tpu_torch.plan.nodes import AggregationNode

    rng = np.random.default_rng(5)
    n = 20_000
    v = np.where(rng.random(n) < 0.5, rng.integers(0, 5, n), rng.integers(5, 5_000, n))
    g = rng.integers(0, 4, n)

    def make(k):
        t = k.Table(k.t.RowType(["g", "v"], [k.t.BIGINT, k.t.BIGINT]),
                    {"g": g.astype(np.int64), "v": v.astype(np.int64)})
        return k.B().table_scan(t).aggregation(["g"], ["approx_most_frequent(3, v, 100) as m"]).build()

    plan = make(PORT)
    assert isinstance(plan, AggregationNode) and plan.aggregates[0].name == "map_agg"
    out = _both(make, "g")
    for gid, got in zip(out["g"], out["m"]):
        vals, counts = np.unique(v[g == gid], return_counts=True)
        top = sorted(zip(vals.tolist(), counts.tolist()), key=lambda kv: (-kv[1], kv[0]))[:3]
        assert got == dict(top), (gid, got, top)


@pytest.mark.parametrize("tile_rows", [2, 1 << 20])
def test_null_grouping_keys_form_their_own_group(tile_rows):
    """A NULL key is one group, apart from the group of the value 0 under
    it: expected rows.  The JAX package merges it (known to differ)."""
    k_vals = np.array([0, 1, 0, 5, 1, 0], np.int64)
    k_valid = np.array([True, True, False, True, False, True])

    def run(k):
        t = k.Table(k.t.RowType(["k", "v"], [k.t.BIGINT, k.t.BIGINT]),
                    {"k": k_vals, "v": np.arange(6, dtype=np.int64)}, {}, {"k": k_valid})
        plan = k.B().table_scan(t).aggregation(
            ["k"], ["array_agg(v) as a", "count(*) as c", "histogram(v) as h"]
        ).build()
        out = python_rows(k.run(plan, tile_rows))
        return sorted(zip(out["k"], out["a"], out["c"]), key=repr)

    assert run(PORT) == [(0, [0, 5], 2), (1, [1], 1), (5, [3], 1), (None, [2, 4], 2)]
    assert run(REF) == [(0, [0, 2, 5], 3), (1, [1, 4], 2), (5, [3], 1)]
