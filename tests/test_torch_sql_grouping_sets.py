"""SQL GROUPING SETS / ROLLUP / CUBE of the port (lowered through
``GroupIdNode``, ``exec/expand.py apply_groupid``) against the JAX package's:
the cases of ``tests/test_sql.py::TestGroupingSets`` on the same seeded
tables, at two tile sizes, against pandas, plus grouping keys that hold NULLs
(a NULL key and a rolled-up key are different rows)."""

import numpy as np
import pandas as pd
import pytest

import velox_tpu.dtypes as rt
import velox_tpu_torch.dtypes as pt
from velox_tpu.io.table import Table as RefTable
from velox_tpu.sql import run_sql as ref_run_sql
from velox_tpu_torch.io.table import Table
from velox_tpu_torch.sql import run_sql
from velox_tpu_torch.testing import assert_same_values, python_rows


def _tables(n=600, seed=3, nulls=False):
    rng = np.random.default_rng(seed)
    cols = {"a": rng.integers(0, 4, n), "b": rng.integers(0, 3, n), "x": rng.integers(0, 100, n)}
    validities = {"a": rng.random(n) > 0.1} if nulls else {}
    ref = RefTable(rt.RowType(["a", "b", "x"], [rt.BIGINT] * 3), dict(cols), {}, dict(validities))
    port = Table(pt.RowType(["a", "b", "x"], [pt.BIGINT] * 3), dict(cols), {}, dict(validities))
    df = pd.DataFrame(cols)
    if nulls:
        df["a"] = df["a"].where(validities["a"])
    return ref, port, df


def _rows(out):
    rows = python_rows(out)
    order = sorted(range(len(rows["a"])), key=lambda i: tuple(repr(v[i]) for v in rows.values()))
    return {c: [v[i] for i in order] for c, v in rows.items()}


def _both(text, seed, tile_rows, nulls=False):
    ref, port, df = _tables(seed=seed, nulls=nulls)
    got = _rows(run_sql(text, {"t": port}, tile_rows=tile_rows, device="cpu"))
    want = _rows(ref_run_sql(text, {"t": ref}, tile_rows=tile_rows))
    assert list(got) == list(want)
    for col in want:
        assert_same_values(got[col], want[col], path=col)
    return pd.DataFrame(got), df


TILES = [128, 1 << 20]


@pytest.mark.parametrize("tile_rows", TILES)
def test_rollup(tile_rows):
    out, df = _both("select a, b, sum(x) as s from t group by rollup(a, b)", 3, tile_rows)
    ab = df.groupby(["a", "b"]).x.sum()
    a = df.groupby("a").x.sum()
    assert len(out) == len(ab) + len(a) + 1
    lvl_a = out[out.a.notna() & out.b.isna()].set_index("a")["s"]
    for k, v in a.items():
        assert int(lvl_a[k]) == int(v)
    tot = out[out.a.isna() & out.b.isna()]
    assert len(tot) == 1 and int(tot.s.iloc[0]) == int(df.x.sum())


@pytest.mark.parametrize("tile_rows", TILES)
def test_cube(tile_rows):
    out, df = _both("select a, b, count(*) as c from t group by cube(a, b)", 4, tile_rows)
    assert len(out) == len(df.groupby(["a", "b"]).size()) + df.a.nunique() + df.b.nunique() + 1
    lvl_b = out[out.a.isna() & out.b.notna()].set_index("b")["c"]
    for k, v in df.groupby("b").size().items():
        assert int(lvl_b[k]) == int(v)


@pytest.mark.parametrize("tile_rows", TILES)
def test_grouping_sets_explicit(tile_rows):
    out, df = _both(
        "select a, b, sum(x) as s from t group by grouping sets ((a, b), (b), ())", 5, tile_rows
    )
    assert len(out) == len(df.groupby(["a", "b"])) + df.b.nunique() + 1
    lvl_b = out[out.a.isna() & out.b.notna()].set_index("b")["s"]
    for k, v in df.groupby("b").x.sum().items():
        assert int(lvl_b[k]) == int(v)


@pytest.mark.parametrize("tile_rows", TILES)
def test_plain_keys_with_rollup(tile_rows):
    out, df = _both("select a, b, sum(x) as s from t group by a, rollup(b)", 6, tile_rows)
    assert len(out) == len(df.groupby(["a", "b"])) + df.a.nunique()
    lvl_a = out[out.b.isna()].set_index("a")["s"]
    for k, v in df.groupby("a").x.sum().items():
        assert int(lvl_a[k]) == int(v)


@pytest.mark.parametrize("tile_rows", TILES)
def test_mixed_constructs_cross_product(tile_rows):
    """GROUP BY ROLLUP(a), ROLLUP(b): the cross product of the two set lists."""
    out, df = _both("select a, b, sum(x) as s from t group by rollup(a), rollup(b)", 7, tile_rows)
    n_ab = len(df.groupby(["a", "b"]))
    assert len(out) == n_ab + df.a.nunique() + df.b.nunique() + 1
    assert int(out[out.a.isna() & out.b.isna()]["s"].iloc[0]) == int(df.x.sum())
    lvl_b = out[out.a.isna() & ~out.b.isna()].set_index("b")["s"]
    for k, v in df.groupby("b").x.sum().items():
        assert int(lvl_b[k]) == int(v)


@pytest.mark.parametrize("tile_rows", TILES)
def test_rollup_over_a_nullable_key(tile_rows):
    """Rows whose key is NULL form one group of the (a) set, apart from the
    rolled-up total whose key is NULL too; the set id keeps them apart."""
    text = "select a, sum(x) as s, count(*) as c from t group by rollup(a)"
    out, df = _both(text, 8, tile_rows, nulls=True)
    per_a = df.groupby("a", dropna=False).x.agg(["sum", "count"])
    assert len(out) == len(per_a) + 1
    null_rows = out[out.a.isna()].sort_values("c")
    nulls = df[df.a.isna()]
    assert null_rows.c.tolist() == [len(nulls), len(df)]
    assert null_rows.s.tolist() == [int(nulls.x.sum()), int(df.x.sum())]
