"""The window primitives of the port against their JAX twins on the same
numpy inputs: ``ops/segmented.py`` ``segmented_scan`` (first, min, max, sum),
``sparse_table`` / ``sparse_table_query`` (with a brute-force check of every
in-range query) and ``rank_in_segments`` (against ``np.searchsorted`` too),
and ``exec/grouped.py concat_tables`` (string dictionaries merged, validity
kept).  Integers exactly, DOUBLE sums to rtol 1e-9."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import velox_tpu as vt
from velox_tpu.exec.grouped import concat_tables as ref_concat
from velox_tpu.io.table import Table as RefTable
from velox_tpu.ops import segmented as ref_seg
from velox_tpu.vector.string_table import StringTable as RefStrings
from velox_tpu_torch.exec.grouped import concat_tables
from velox_tpu_torch.ops import segmented as port_seg
from velox_tpu_torch.testing import table_from_numpy

RTOL = 1e-9


def _pair(cols, types, strings=None, validities=None):
    names = list(cols)
    port = table_from_numpy(names, types, cols, strings, validities)
    ref_types = {"BIGINT": vt.BIGINT, "VARCHAR": vt.VARCHAR}
    ref = RefTable(
        vt.RowType(names, [ref_types[t] for t in types]), dict(cols),
        {k: RefStrings.from_values(v) for k, v in (strings or {}).items()},
        dict(validities or {}),
    )
    return ref, port


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize(
    "op,dtype",
    [("first", np.int64), ("min", np.int64), ("max", np.float64), ("sum", np.float64)],
)
def test_segmented_scan(op, dtype):
    rng = np.random.default_rng(5)
    n = 3000
    values = (rng.normal(size=n) * 1e6).astype(dtype) if dtype is np.float64 else rng.integers(
        -(1 << 40), 1 << 40, n
    )
    boundary = rng.random(n) < 0.03
    want = np.asarray(ref_seg.segmented_scan(jnp.asarray(values), jnp.asarray(boundary), op))
    got = _np(port_seg.segmented_scan(torch.from_numpy(values), torch.from_numpy(boundary), op))
    if dtype is np.float64 and op == "sum":
        np.testing.assert_allclose(got, want, rtol=RTOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
@pytest.mark.parametrize("op", ["min", "max"])
def test_sparse_table_and_query(op, n):
    rng = np.random.default_rng(n)
    values = rng.integers(-1000, 1000, n)
    want_table = np.asarray(ref_seg.sparse_table(jnp.asarray(values), op))
    table = port_seg.sparse_table(torch.from_numpy(values), op)
    np.testing.assert_array_equal(_np(table), want_table)
    lo = rng.integers(-2, n + 2, 4 * n)
    hi = lo + rng.integers(-3, 40, 4 * n)  # empty, short and clipped ranges
    ident = port_seg.identity_for(op, torch.int64)
    want = np.asarray(ref_seg.sparse_table_query(
        jnp.asarray(want_table), jnp.asarray(lo.astype(np.int32)), jnp.asarray(hi.astype(np.int32)),
        op, ident,
    ))
    got = _np(port_seg.sparse_table_query(table, torch.from_numpy(lo), torch.from_numpy(hi), op, ident))
    np.testing.assert_array_equal(got, want)
    # op over values[lo..hi] where the range is inside the array
    inside = (lo >= 0) & (hi < n) & (lo <= hi)
    fn = np.min if op == "min" else np.max
    brute = [fn(values[a:b + 1]) for a, b in zip(lo[inside], hi[inside])]
    np.testing.assert_array_equal(got[inside], brute)


@pytest.mark.parametrize("inclusive", [False, True])
def test_rank_in_segments(inclusive):
    rng = np.random.default_rng(9)
    n = 2000
    seg = np.sort(rng.integers(0, 40, n))
    keys = np.empty(n, np.int64)
    for s in np.unique(seg):  # sorted by (segment, key), keys repeat
        at = seg == s
        keys[at] = np.sort(rng.integers(0, 60, at.sum()))
    probe_seg = rng.integers(-1, 42, 700)
    probe_keys = rng.integers(-5, 65, 700)
    want = np.asarray(ref_seg.rank_in_segments(
        jnp.asarray(seg), jnp.asarray(keys), jnp.asarray(probe_seg), jnp.asarray(probe_keys),
        inclusive,
    ))
    got = _np(port_seg.rank_in_segments(
        torch.from_numpy(seg), torch.from_numpy(keys), torch.from_numpy(probe_seg),
        torch.from_numpy(probe_keys), inclusive,
    ))
    np.testing.assert_array_equal(got, want)
    # the position of the first data row at or past the probe in (segment,
    # key) order
    word = seg * 1000 + keys
    probe = probe_seg * 1000 + probe_keys
    np.testing.assert_array_equal(got, np.searchsorted(word, probe, "right" if inclusive else "left"))


def test_concat_tables_merges_string_dictionaries():
    """One merged dictionary: the first table's codes stay, the later tables'
    values are interned after them and their codes remapped; validity is
    kept, all-valid where a table has none; the same as the JAX package's."""
    a = _pair({"s": np.array([1, 2, 1], np.int32), "x": np.array([1, 2, 3])},
              ["VARCHAR", "BIGINT"], strings={"s": ["", "pear", "fig"]},
              validities={"x": np.array([True, False, True])})
    b = _pair({"s": np.array([2, 1, 3], np.int32), "x": np.array([4, 5, 6])},
              ["VARCHAR", "BIGINT"], strings={"s": ["", "fig", "kiwi", "pear"]})
    empty = _pair({"s": np.zeros(0, np.int32), "x": np.zeros(0, np.int64)}, ["VARCHAR", "BIGINT"],
                  strings={"s": [""]})
    want = ref_concat([a[0], empty[0], b[0]])
    got = concat_tables([a[1], empty[1], b[1]])
    assert got.num_rows == want.num_rows == 6
    np.testing.assert_array_equal(np.asarray(got.columns["x"]), np.asarray(want.columns["x"]))
    np.testing.assert_array_equal(got.validities["x"], want.validities["x"])
    np.testing.assert_array_equal(np.asarray(got.columns["s"]), np.asarray(want.columns["s"]))
    assert list(got.string_tables["s"].values()) == list(want.string_tables["s"].values())
    assert list(got.string_tables["s"].decode(np.asarray(got.columns["s"]))) == [
        "pear", "fig", "pear", "kiwi", "fig", "pear"]
    assert list(got.validities["x"]) == [True, False, True, True, True, True]
