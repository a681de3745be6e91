"""Complex-type fuzzing of the port: the cases of ``tests/test_complex_fuzz.py``
(random ARRAY columns with NULL rows and NULL elements through the array and
lambda functions, and unnest + array_agg reconstructing the arrays), run
through both packages on the same seeded rows and held against the JAX
package's rows and a Python oracle."""

import numpy as np
import pytest

from test_torch_complex import PORT, REF, _at
from velox_tpu_torch.testing import assert_same_values, python_rows

EXPRS = [
    "cardinality(a) as card",
    "array_sum(a) as asum",
    "element_at(a, x) as eat",
    "transform(a, e -> e + x) as tr",
    "filter(a, e -> e > 4) as fl",
    "concat(a, b) as cc",
    "reverse(a) as rev",
    "contains(a, 7) as has7",
    "zip_with(a, b, (p, q) -> p + q) as zw",
    "array_sort(a) as srt",
    "array_distinct(a) as dst",
    "array_max(a) as amax",
]


def random_arrays(rng, n, null_ratio=0.15, elem_null_ratio=0.1, max_len=6):
    rows = []
    for _ in range(n):
        if rng.random() < null_ratio:
            rows.append(None)
            continue
        size = int(rng.integers(0, max_len + 1))
        rows.append([
            None if rng.random() < elem_null_ratio else int(rng.integers(-5, 20))
            for _ in range(size)
        ])
    return rows


def _run_exprs(k, rows_a, rows_b, xs):
    a, va = k.Seg.from_pylist(rows_a, _at(k))
    b, vb = k.Seg.from_pylist(rows_b, _at(k))
    validities = {n: v for n, v in (("a", va), ("b", vb)) if v is not None}
    t = k.Table(
        k.t.RowType(["a", "b", "x"], [_at(k), _at(k), k.t.BIGINT]),
        {"a": a, "b": b, "x": xs},
        validities=validities,
    )
    return python_rows(k.run(k.B().table_scan(t).project(EXPRS).build(), 64))


def _sorted_nulls_last(row):
    return sorted((v for v in row if v is not None)) + [None] * row.count(None)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_complex_fuzz_vs_python(seed):
    rng = np.random.default_rng(seed)
    n = 200
    rows_a = random_arrays(rng, n)
    rows_b = random_arrays(rng, n)
    xs = rng.integers(-3, 3, n)
    out = _run_exprs(PORT, rows_a, rows_b, xs)
    want = _run_exprs(REF, rows_a, rows_b, xs)
    for col in want:
        assert_same_values(out[col], want[col], path=col)
    for i in range(n):
        ra, rb, x = rows_a[i], rows_b[i], int(xs[i])
        if ra is None:
            assert all(out[c][i] is None for c in out), i
            continue
        assert out["card"][i] == len(ra)
        assert out["asum"][i] == sum(v for v in ra if v is not None)
        # element_at: 1-based, negative from the end, 0 / out of range -> NULL
        expect = None if x == 0 or abs(x) > len(ra) else (ra[x - 1] if x > 0 else ra[x])
        assert out["eat"][i] == expect, (i, ra, x)
        assert out["tr"][i] == [None if v is None else v + x for v in ra]
        assert out["fl"][i] == [v for v in ra if v is not None and v > 4]
        assert out["rev"][i] == ra[::-1]
        assert out["srt"][i] == _sorted_nulls_last(ra)
        first = []
        for v in ra:
            if v not in first:
                first.append(v)
        assert out["dst"][i] == first
        assert out["amax"][i] == (None if not ra or None in ra else max(ra))
        # contains: TRUE beats NULL beats FALSE
        assert out["has7"][i] == (True if 7 in ra else None if None in ra else False)
        if rb is None:
            assert out["cc"][i] is None and out["zw"][i] is None
            continue
        assert out["cc"][i] == ra + rb
        assert out["zw"][i] == [
            None if (j >= len(ra) or j >= len(rb) or ra[j] is None or rb[j] is None)
            else ra[j] + rb[j]
            for j in range(max(len(ra), len(rb)))
        ]


def _roundtrip(k, rows):
    n = len(rows)
    seg, _ = k.Seg.from_pylist(rows, _at(k))
    t = k.Table(
        k.t.RowType(["rid", "a"], [k.t.BIGINT, _at(k)]),
        {"rid": np.arange(n, dtype=np.int64), "a": seg},
    )
    plan = (
        k.B().table_scan(t).unnest(["rid"], ["a"])
        .aggregation(["rid"], ["array_agg(a) as back"]).build()
    )
    out = python_rows(k.run(plan, 64))
    return dict(zip(out["rid"], out["back"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_complex_fuzz_unnest_roundtrip(seed):
    """unnest + array_agg (grouped by row id) rebuild the arrays, in order."""
    rng = np.random.default_rng(seed)
    rows = random_arrays(rng, 100, null_ratio=0.0, elem_null_ratio=0.0)
    got = _roundtrip(PORT, rows)
    assert got == _roundtrip(REF, rows)
    for i, row in enumerate(rows):
        if row:  # an empty array unnests to no rows, so no group
            assert got[i] == row
        else:
            assert i not in got
