"""FULL joins (plain and filtered), the filtered null-aware anti join,
nested-loop joins of every type, UNION ALL and MergeExchange: the port
against the JAX package on the same numpy tables, and against the oracles of
the tests it mirrors (``tests/test_exec.py`` ``test_full_join_with_filter``,
``test_null_aware_anti_join_with_filter``, ``test_nested_loop_join_non_equi``;
``tests/test_expansion_join.py::test_full_outer_join``; the FULL seeds of
``tests/test_join_fuzzer.py``; ``tests/test_misc_components.py::
test_merge_exchange``).  Joins compare their rows as sorted multisets (the
order of a join's output is not part of its result); MergeExchange compares
the order too.  Every column here is an integer or a string: exact."""

import numpy as np
import pandas as pd
import pytest

import velox_tpu as vt
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.vector.string_table import StringTable as RefStrings
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor
from velox_tpu_torch.plan import PlanBuilder as PortBuilder
from velox_tpu_torch.testing import table_from_numpy

_REF_TYPES = {"BIGINT": vt.BIGINT, "VARCHAR": vt.VARCHAR}


def _pair(cols, types=None, strings=None, validities=None):
    names = list(cols)
    types = types or ["BIGINT"] * len(names)
    port = table_from_numpy(names, types, cols, strings, validities)
    ref = RefTable(
        vt.RowType(names, [_REF_TYPES[t] for t in types]), dict(cols),
        {k: RefStrings.from_values(v) for k, v in (strings or {}).items()},
        dict(validities or {}),
    )
    return ref, port


def _rows(table):
    """Sorted row tuples, NULL as None, strings decoded."""
    df = table.to_pandas()
    out = [tuple(None if (v is None or v != v) else (v if isinstance(v, str) else int(v))
                 for v in r) for r in df.itertuples(index=False)]
    return _rows_of(out)


def _rows_of(tuples):
    return sorted(tuples, key=lambda r: tuple((v is None, v if v is not None else 0) for v in r))


def _both(make, left, right=None, tile_rows=256):
    """(port Table, JAX Table) of ``make(builder, left, right)``."""
    args_ref = [left[0]] + ([right[0]] if right else [])
    args_port = [left[1]] + ([right[1]] if right else [])
    want = RefExecutor(make(RefBuilder, *args_ref).build(), tile_rows=tile_rows).run()
    got = PortExecutor(make(PortBuilder, *args_port).build(), tile_rows=tile_rows,
                       device="cpu").run()
    return got, want


# ---- FULL joins -------------------------------------------------------------


def test_full_join_with_filter():
    """FULL join + non-equi filter (``rewrite_full_filter``): failing matches
    null-extend BOTH sides; the oracle is a pandas outer merge with the
    filter applied to matched pairs."""
    rng = np.random.default_rng(6)
    n, m = 300, 200
    probe = _pair({"k": rng.integers(0, 25, n), "x": rng.integers(0, 100, n)})
    build = _pair({"bk": rng.integers(0, 25, m), "y": rng.integers(0, 100, m)})

    def make(builder, p, b):
        return builder().table_scan(p).hash_join(
            builder().table_scan(b), ["k"], ["bk"], output=["x", "y"], join_type="full",
            filter="x < y",
        )

    got, want = _both(make, probe, build, tile_rows=128)
    assert _rows(got) == _rows(want)
    dfp = pd.DataFrame({c: np.asarray(probe[1].columns[c]) for c in ("k", "x")}).reset_index(names="pi")
    dfb = pd.DataFrame({c: np.asarray(build[1].columns[c]) for c in ("bk", "y")}).reset_index(names="bi")
    mm = dfp.merge(dfb, left_on="k", right_on="bk")
    mm = mm[mm.x < mm.y]
    expect = sorted(
        [(int(r.x), int(r.y)) for r in mm.itertuples()]
        + [(int(r.x), -1) for r in dfp[~dfp.pi.isin(mm.pi)].itertuples()]
        + [(-1, int(r.y)) for r in dfb[~dfb.bi.isin(mm.bi)].itertuples()]
    )
    assert sorted((-1 if a is None else a, -1 if b is None else b) for a, b in _rows(got)) == expect


def test_full_outer_join():
    """Unmatched rows of both sides, and the tail flowing through the
    aggregation above the join."""
    left = _pair({"k": np.array([1, 2, 5]), "lx": np.array([10, 20, 50])})
    right = _pair({"rk": np.array([2, 2, 3]), "ry": np.array([200, 201, 300])})

    def joined(builder, left_t, right_t):
        return builder().table_scan(left_t).hash_join(
            builder().table_scan(right_t), ["k"], ["rk"], output=["k", "lx", "rk", "ry"],
            join_type="full",
        )

    got, want = _both(joined, left, right)
    assert _rows(got) == _rows(want) == sorted(
        [(1, 10, None, None), (2, 20, 2, 200), (2, 20, 2, 201), (5, 50, None, None),
         (None, None, 3, 300)], key=lambda r: tuple((v is None, v or 0) for v in r))

    def counted(builder, left_t, right_t):
        return builder().table_scan(left_t).hash_join(
            builder().table_scan(right_t), ["k"], ["rk"], output=["lx", "ry"], join_type="full",
        ).aggregation([], ["count(lx) as cl", "count(ry) as cr", "sum(ry) as s"])

    got, want = _both(counted, left, right)
    assert _rows(got) == _rows(want) == [(4, 3, 701)]


def _fuzz_tables(seed, n_left=500, n_right=300, key_range=40, null_ratio=0.1):
    rng = np.random.default_rng(seed)
    sides = []
    for n, names in ((n_left, ("k", "lx")), (n_right, ("rk", "ry"))):
        keys, payload = rng.integers(0, key_range, n), rng.integers(0, 1000, n)
        valid = rng.random(n) >= null_ratio
        sides.append(_pair({names[0]: keys, names[1]: payload}, validities={names[0]: valid}))
    return sides


@pytest.mark.parametrize("tile_rows", [64, 1024])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_fuzz_full(seed, tile_rows):
    """The FULL seeds of the JAX package's join fuzzer (NULL keys match
    nothing and survive on both sides), over several tiles and one."""
    left, right = _fuzz_tables(seed)

    def make(builder, left_t, right_t):
        return builder().table_scan(left_t).hash_join(
            builder().table_scan(right_t), ["k"], ["rk"], output=["k", "lx", "rk", "ry"],
            join_type="full",
        )

    got, want = _both(make, left, right, tile_rows=tile_rows)
    assert _rows(got) == _rows(want)
    lk, lv = np.asarray(left[1].columns["k"]), left[1].validities["k"]
    rk, rv = np.asarray(right[1].columns["rk"]), right[1].validities["rk"]
    pairs = sum(int(((rk == k) & rv).sum()) for k, ok in zip(lk, lv) if ok)
    lonely_left = sum(1 for k, ok in zip(lk, lv) if not ok or not ((rk == k) & rv).any())
    lonely_right = sum(1 for k, ok in zip(rk, rv) if not ok or not ((lk == k) & lv).any())
    assert got.num_rows == pairs + lonely_left + lonely_right


def test_full_join_edge_shapes():
    """An empty build side, an empty probe side, a build side of NULL keys
    only, a two-column key, a string payload on both sides, and a FULL join
    feeding a grouping by a probe key (the tail's NULL keys form one
    group)."""
    rng = np.random.default_rng(4)
    names = ["", "ash", "birch", "cedar"]
    left = _pair({"k": rng.integers(0, 6, 40), "k2": rng.integers(0, 2, 40),
                  "ls": rng.integers(1, 4, 40).astype(np.int32)},
                 ["BIGINT", "BIGINT", "VARCHAR"], strings={"ls": names},
                 validities={"k": rng.random(40) < 0.9})
    right = _pair({"rk": rng.integers(3, 9, 30), "rk2": rng.integers(0, 2, 30),
                   "rs": rng.integers(1, 4, 30).astype(np.int32)},
                  ["BIGINT", "BIGINT", "VARCHAR"], strings={"rs": names})
    empty = _pair({"rk": np.zeros(0, np.int64), "rk2": np.zeros(0, np.int64),
                   "rs": np.zeros(0, np.int32)}, ["BIGINT", "BIGINT", "VARCHAR"],
                  strings={"rs": [""]})
    nulls = _pair({"rk": np.arange(5), "rk2": np.zeros(5, np.int64),
                   "rs": np.ones(5, np.int32)}, ["BIGINT", "BIGINT", "VARCHAR"],
                  strings={"rs": names}, validities={"rk": np.zeros(5, bool)})

    def one_key(builder, left_t, right_t):
        return builder().table_scan(left_t).hash_join(
            builder().table_scan(right_t), ["k"], ["rk"], output=["k", "ls", "rk", "rs"],
            join_type="full",
        )

    def two_keys(builder, left_t, right_t):
        return builder().table_scan(left_t).hash_join(
            builder().table_scan(right_t), ["k", "k2"], ["rk", "rk2"],
            output=["k", "k2", "ls", "rs"], join_type="full",
        )

    def grouped(builder, left_t, right_t):
        return one_key(builder, left_t, right_t).aggregation(["k"], ["count(rk) as c"])

    no_rows = _pair({"k": np.zeros(0, np.int64), "k2": np.zeros(0, np.int64),
                     "ls": np.zeros(0, np.int32)}, ["BIGINT", "BIGINT", "VARCHAR"],
                    strings={"ls": [""]})
    for make, l_side, r_side in (
        (one_key, left, right), (one_key, left, nulls), (one_key, no_rows, right),
        (two_keys, left, right), (grouped, left, right),
    ):
        got, want = _both(make, l_side, r_side, tile_rows=16)
        assert _rows(got) == _rows(want), make.__name__
    got, _ = _both(grouped, left, right, tile_rows=16)
    assert sum(1 for r in _rows(got) if r[0] is None) == 1  # one NULL group
    # an empty build side: every probe row, the build side NULL (the JAX
    # package's probe cannot index an empty build, so this is held against
    # the expected rows)
    got = PortExecutor(one_key(PortBuilder, left[1], empty[1]).build(), tile_rows=16,
                       device="cpu").run()
    ls = left[1].string_tables["ls"].decode(np.asarray(left[1].columns["ls"]))
    lk = np.where(left[1].validities["k"], np.asarray(left[1].columns["k"]), -1)
    assert _rows(got) == _rows_of([(None if k < 0 else int(k), s, None, None)
                                   for k, s in zip(lk, ls)])


# ---- filtered null-aware anti join ------------------------------------------


def test_null_aware_anti_join_with_filter():
    """NOT IN + a non-equi filter (``rewrite_null_aware_anti_filter``): a
    probe row survives iff no build row with (keys equal OR either key NULL)
    passes the filter; brute force over every pair, NULL keys on both sides,
    with and without the NULL-key build row."""
    pk, pkv = np.array([1, 2, 3, 0, 5]), np.array([True, True, True, False, True])
    pv = np.array([10, 20, 30, 40, 50])
    bk, bkv = np.array([2, 3, 0, 5]), np.array([True, True, False, True])
    bv = np.array([25, 15, 45, 99])
    probe = _pair({"k": pk, "pv": pv}, validities={"k": pkv})
    for keep in (np.ones(4, bool), bkv):
        build = _pair({"k2": bk[keep], "bv": bv[keep]}, validities={"k2": bkv[keep]})

        def make(builder, p, b):
            return builder().table_scan(p).hash_join(
                builder().table_scan(b), ["k"], ["k2"], output=["k", "pv"], join_type="anti",
                null_aware=True, filter="pv < bv",
            )

        got, want = _both(make, probe, build)
        assert _rows(got) == _rows(want)
        expect = [
            int(pv[i]) for i in range(len(pk))
            if not any(((not pkv[i]) or (not v) or pk[i] == k) and pv[i] < b
                       for k, v, b in zip(bk[keep], bkv[keep], bv[keep]))
        ]
        assert sorted(r[1] for r in _rows(got)) == sorted(expect)


# ---- nested-loop joins ------------------------------------------------------


@pytest.mark.parametrize("jt", ["inner", "left", "right", "full"])
def test_nested_loop_join_non_equi(jt):
    """A pure inequality condition: the constant-key expansion join with the
    condition as its filter (RIGHT flipped to LEFT), against the JAX package
    and a pandas cross-product oracle."""
    rng = np.random.RandomState(7)
    a = rng.randint(0, 20, 37).astype(np.int64)
    b = rng.randint(0, 20, 11).astype(np.int64)
    left, right = _pair({"a": a}), _pair({"b": b})

    def make(builder, left_t, right_t):
        return builder().table_scan(left_t).nested_loop_join(
            builder().table_scan(right_t).build(), ["a", "b"], jt, "a > b"
        )

    got, want = _both(make, left, right, tile_rows=16)
    assert _rows(got) == _rows(want)
    hit = [(int(x), int(y)) for x in a for y in b if x > y]
    expect = list(hit)
    if jt in ("left", "full"):
        expect += [(int(x), None) for x in a if not (x > b).any()]
    if jt in ("right", "full"):
        expect += [(None, int(y)) for y in b if not (a > y).any()]
    assert _rows(got) == sorted(expect, key=lambda r: tuple((v is None, v or 0) for v in r))


# ---- UNION ALL and MergeExchange --------------------------------------------


def test_union_all_aligns_by_position_and_merges_strings():
    """Inputs align by position and take the first input's names; a string
    column's dictionaries merge; an aggregation above sees every row."""
    names_a, names_b = ["", "ash", "birch"], ["", "birch", "cedar", "ash"]
    a = _pair({"k": np.array([1, 2, 2]), "s": np.array([1, 2, 1], np.int32)},
              ["BIGINT", "VARCHAR"], strings={"s": names_a})
    b = _pair({"kk": np.array([2, 3]), "ss": np.array([2, 3], np.int32)},
              ["BIGINT", "VARCHAR"], strings={"ss": names_b})

    def make(builder, a_t, b_t):
        return builder().union_all([builder().table_scan(a_t), builder().table_scan(b_t)])

    got, want = _both(make, a, b)
    assert list(got.schema.names) == ["k", "s"]
    assert _rows(got) == _rows(want) == [
        (1, "ash"), (2, "ash"), (2, "birch"), (2, "cedar"), (3, "ash")]

    # grouped by the string: the executor plans the aggregation over the
    # union's rows, whose merged dictionary holds "cedar" (the JAX package
    # sizes the grouping by the first input's dictionary and drops "cedar",
    # so this is held against the expected rows)
    plan = make(PortBuilder, a[1], b[1]).aggregation(["s"], ["count(*) as c", "sum(k) as t"])
    got = PortExecutor(plan.build(), device="cpu").run()
    assert _rows(got) == [("ash", 3, 6), ("birch", 1, 2), ("cedar", 1, 2)]


def test_union_all_nulls_of_a_later_input_form_one_group():
    """A grouping key that only a later UNION ALL input makes NULL: its NULLs
    form one group.  (The JAX package asks the first input whether the
    column may be NULL and groups those rows by their raw values, so this is
    held against the expected rows.)"""
    a = _pair({"k": np.array([1, 2, 2]), "v": np.array([1, 1, 1])})
    b = _pair({"k": np.array([1, 2, 3]), "v": np.array([1, 1, 1])},
              validities={"k": np.array([True, False, False])})
    plan = PortBuilder().union_all([PortBuilder().table_scan(a[1]), PortBuilder().table_scan(b[1])])
    got = PortExecutor(plan.aggregation(["k"], ["count(*) as c"]).build(), device="cpu").run()
    assert _rows(got) == [(1, 2), (2, 2), (None, 2)]


def test_merge_exchange():
    """Sorted inputs merge into one order (ties keep the first input's row
    first), the same rows in the same order as the JAX package."""
    a = _pair({"k": np.array([1, 3, 5]), "v": np.array([10, 30, 50])})
    b = _pair({"k": np.array([2, 3, 6]), "v": np.array([20, 31, 60])})

    def make(builder, a_t, b_t):
        return builder().merge_exchange(
            [builder().table_scan(a_t), builder().table_scan(b_t)], ["k"]
        ).project(["k", "v"])

    got, want = _both(make, a, b)
    for name in ("k", "v"):
        assert list(got.columns[name]) == list(want.columns[name])
    assert list(got.columns["k"]) == [1, 2, 3, 3, 5, 6]
    assert list(got.columns["v"]) == [10, 20, 30, 31, 50, 60]
    # DESC keys over several tiles of each input
    rng = np.random.default_rng(3)
    c = _pair({"k": rng.integers(0, 50, 500), "v": np.arange(500)})
    d = _pair({"k": rng.integers(0, 50, 300), "v": np.arange(500, 800)})

    def desc(builder, c_t, d_t):
        return builder().merge_exchange(
            [builder().table_scan(c_t).orderby(["k desc"]),
             builder().table_scan(d_t).orderby(["k desc"])], ["k desc"]
        )

    got, want = _both(desc, c, d, tile_rows=64)
    for name in ("k", "v"):
        np.testing.assert_array_equal(np.asarray(got.columns[name]), np.asarray(want.columns[name]))
    assert list(np.asarray(got.columns["k"])) == sorted(np.asarray(got.columns["k"]), reverse=True)
