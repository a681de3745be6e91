"""N:M (expansion) hash joins of the port against the JAX package's, on the
same numpy tables: INNER and LEFT, into an aggregation, over several tiles,
with a two-column key, with a filter on an N:M LEFT join, and the constant-key
cross join; the span primitives of ``ops/segpool.py`` against their JAX twins.
Mirrors ``tests/test_expansion_join.py``.  Every column agrees exactly (the
joins move values, they compute none)."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import velox_tpu as vt
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.ops import segpool as ref_segpool
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.vector.string_table import StringTable as RefStrings
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor
from velox_tpu_torch.ops import segpool
from velox_tpu_torch.plan import PlanBuilder as PortBuilder
from velox_tpu_torch.testing import table_from_numpy

_REF_TYPES = {"BIGINT": vt.BIGINT, "VARCHAR": vt.VARCHAR}


def _pair(cols, types, strings=None, validities=None):
    names = list(cols)
    port = table_from_numpy(names, types, cols, strings, validities)
    ref = RefTable(
        vt.RowType(names, [_REF_TYPES[t] for t in types]), dict(cols),
        {k: RefStrings.from_values(v) for k, v in (strings or {}).items()},
        dict(validities or {}),
    )
    return ref, port


def _small():
    left = _pair(
        {"k": np.array([1, 2, 3, 4], np.int64), "lx": np.array([10, 20, 30, 40], np.int64)},
        ["BIGINT", "BIGINT"],
    )
    right = _pair(
        {
            "rk": np.array([1, 1, 1, 3, 5, 5], np.int64),
            "ry": np.array([100, 101, 102, 300, 500, 501], np.int64),
            "rs": np.array([1, 2, 3, 4, 5, 6], np.int32),
        },
        ["BIGINT", "BIGINT", "VARCHAR"],
        {"rs": ["", "a", "b", "c", "d", "e", "f"]},
    )
    return left, right


def _random(n=3000, m=500, seed=7):
    rng = np.random.default_rng(seed)
    left = _pair(
        {"k": rng.integers(0, 200, n), "lx": rng.integers(0, 1000, n)},
        ["BIGINT", "BIGINT"],
        validities={"k": rng.random(n) < 0.95},
    )
    right = _pair(
        {"rk": rng.integers(0, 200, m), "ry": rng.integers(0, 1000, m)},
        ["BIGINT", "BIGINT"],
        validities={"ry": rng.random(m) < 0.9},
    )
    return left, right


def _multi_key():
    left = _pair(
        {
            "a": np.array([1, 1, 2], np.int64),
            "b": np.array([5, 6, 5], np.int64),
            "lx": np.array([10, 20, 30], np.int64),
        },
        ["BIGINT", "BIGINT", "BIGINT"],
    )
    right = _pair(
        {
            "ra": np.array([1, 1, 1, 2], np.int64),
            "rb": np.array([5, 5, 6, 7], np.int64),
            "ry": np.array([100, 101, 102, 103], np.int64),
        },
        ["BIGINT", "BIGINT", "BIGINT"],
    )
    return left, right


def _plan(builder, left, right, case):
    b = builder().table_scan(left)
    if case == "inner":
        return b.hash_join(builder().table_scan(right), ["k"], ["rk"], output=["k", "lx", "ry", "rs"])
    if case == "left":
        return b.hash_join(
            builder().table_scan(right), ["k"], ["rk"], output=["k", "ry"], join_type="left"
        )
    if case == "aggregation":
        return b.hash_join(
            builder().table_scan(right), ["k"], ["rk"], output=["k", "ry"]
        ).aggregation(["k"], ["count(ry) as c", "sum(ry) as s"])
    if case in ("multi_tile_inner", "multi_tile_left"):
        jt = "left" if case.endswith("left") else "inner"
        return b.hash_join(
            builder().table_scan(right), ["k"], ["rk"], output=["k", "lx", "ry"], join_type=jt
        )
    if case == "multi_tile_left_filter":
        return b.hash_join(
            builder().table_scan(right), ["k"], ["rk"], output=["k", "lx", "ry"],
            join_type="left", filter="lx > ry",
        )
    if case == "multi_key":
        return b.hash_join(
            builder().table_scan(right), ["a", "b"], ["ra", "rb"], output=["a", "b", "lx", "ry"]
        )
    if case == "cross_join":
        return b.cross_join(builder().table_scan(right), output=["k", "ry"], filter="k < 3")
    raise AssertionError(case)


DATA = {
    "inner": _small, "left": _small, "aggregation": _small, "cross_join": _small,
    "multi_tile_inner": _random, "multi_tile_left": _random,
    "multi_tile_left_filter": _random, "multi_key": _multi_key,
}


def _same_rows(got, want):
    assert list(got.schema.names) == list(want.schema.names)
    assert got.num_rows == want.num_rows
    for name in want.schema.names:
        np.testing.assert_array_equal(got.columns[name], want.columns[name], err_msg=name)
        gv, wv = got.validities.get(name), want.validities.get(name)
        np.testing.assert_array_equal(
            np.ones(got.num_rows, bool) if gv is None else gv,
            np.ones(want.num_rows, bool) if wv is None else wv,
            err_msg=name,
        )


@pytest.mark.parametrize("case", sorted(DATA))
def test_matches_reference_executor(case):
    (ref_l, port_l), (ref_r, port_r) = DATA[case]()
    tile = 1024
    ref_plan, port_plan = _plan(RefBuilder, ref_l, ref_r, case), _plan(PortBuilder, port_l, port_r, case)
    keys = [f"{n} nulls first" for n in ref_plan.schema.names]
    ref = RefExecutor(ref_plan.orderby(keys).build(), tile_rows=tile)
    port = PortExecutor(port_plan.orderby(keys).build(), tile_rows=tile, device="cpu")
    # same phases: the expansion joins split the pipeline alike
    assert [s[0] for s in port._all_steps] == [s[0] for s in ref._all_steps]
    assert len(port._pre_segments) == len(ref._pre_segments) >= 1
    _same_rows(port.run(), ref.run())
    # one (bucket, rows) a tile and expansion; the bucket is a power of two
    assert port.expansions and all(
        b >= max(r, 1) and b & (b - 1) == 0 for b, r in port.expansions
    )


def test_left_filter_on_a_duplicate_key_build_is_planned_again():
    """A LEFT join's filter over an N:M build cannot null single candidates;
    the executor plans the join again as uid / filtered INNER / LEFT."""
    (_, port_l), (_, port_r) = _random()
    plan = _plan(PortBuilder, port_l, port_r, "multi_tile_left_filter").build()
    ex = PortExecutor(plan, tile_rows=1024, device="cpu")
    assert ex.root.id.endswith("_ljf")
    assert [s[0] for s in ex._all_steps] == ["expand", "xjoin"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segpool_against_reference(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 4, 300)
    sizes[:3] = 0  # empty rows at the head and the tail
    sizes[-3:] = 0
    starts = np.asarray(ref_segpool.dense_starts(jnp.asarray(sizes, jnp.int32)))
    got = segpool.dense_starts(torch.as_tensor(sizes))
    np.testing.assert_array_equal(got.numpy(), starts)
    total = int(sizes.sum())
    for pool_cap in (total, 1 << int(total).bit_length()):
        want = np.asarray(ref_segpool.owner_rows(jnp.asarray(starts), jnp.int32(total), pool_cap))
        got_rows = segpool.owner_rows(torch.as_tensor(starts.copy()), pool_cap).numpy()
        np.testing.assert_array_equal(got_rows, want)
        # positions below the total are owned by the row whose span holds them
        owner = np.repeat(np.arange(len(sizes)), sizes)
        np.testing.assert_array_equal(got_rows[:total], owner)


def test_full_join_raises_by_name():
    """FULL joins no longer raise: an expansion join whose unmatched build
    rows enter the pipeline after the last tile, the same rows as the JAX
    package's (build keys 1 and 3 repeat, 5 matches nothing, probe keys 2 and
    4 match nothing).  With an ORDER BY above it the tail tile's NULL probe
    columns meet tiles that carry them without a validity: the port aligns
    the layouts (the JAX package's rows come out misaligned there, so the
    order is held against the expected rows)."""
    (ref_l, port_l), (ref_r, port_r) = _small()

    def plan(builder, left, right):
        return builder().table_scan(left).hash_join(
            builder().table_scan(right), ["k"], ["rk"], output=["k", "lx", "rk", "ry"],
            join_type="full",
        )

    def rows(table):
        df = table.to_pandas()
        return sorted(tuple(-1 if pd.isna(v) else int(v) for v in r) for r in df.itertuples(index=False))

    port = PortExecutor(plan(PortBuilder, port_l, port_r).build(), tile_rows=1024, device="cpu")
    assert [s[0] for s in port._all_steps] == ["xjoin"]
    got = rows(port.run())
    assert got == rows(RefExecutor(plan(RefBuilder, ref_l, ref_r).build(), tile_rows=1024).run())
    assert len(got) == 3 + 1 + 2 + 2  # k=1 x3, k=3, k=2 and 4 alone, rk=5 x2
    ordered = PortExecutor(
        plan(PortBuilder, port_l, port_r).orderby(["k nulls first", "rk nulls first", "ry"]).build(),
        tile_rows=1024, device="cpu",
    ).run().to_pandas()
    norm = lambda col: [None if pd.isna(v) else int(v) for v in col]  # noqa: E731
    assert norm(ordered["k"]) == [None, None, 1, 1, 1, 2, 3, 4]
    assert norm(ordered["rk"]) == [5, 5, 1, 1, 1, None, 3, None]
    assert norm(ordered["ry"]) == [500, 501, 100, 101, 102, None, 300, None]
    assert norm(ordered["lx"]) == [None, None, 10, 10, 10, 20, 30, 40]
