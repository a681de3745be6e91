"""SEQUENCE / BIAS columns and the vector fuzzer of the port
(``velox_tpu_torch/vector/column.py``, ``vector/fuzzer.py``) against the JAX
package: the cases of ``tests/test_vector.py`` (SEQUENCE / BIAS) and of
``tests/test_fuzz.py`` run through both packages on the same inputs.  The
fuzzer draws from the same seeded numpy generator in the same order, so one
seed gives the same vectors in both packages (compared value for value).
Integers, validity and error lanes exact; DOUBLE results exact too (the same
IEEE operations on the same inputs)."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import velox_tpu as vt
import velox_tpu_torch as vtt
from velox_tpu.expr import ExprSet as RefExprSet
from velox_tpu.expr import parse_expr as ref_parse
from velox_tpu.vector.column import Column as RefColumn
from velox_tpu.vector.fuzzer import FuzzerOptions as RefOptions
from velox_tpu.vector.fuzzer import VectorFuzzer as RefFuzzer
from velox_tpu_torch.expr.compiler import ExprSet
from velox_tpu_torch.expr.parser import parse_expr
from velox_tpu_torch.vector.column import Batch, Column, Encoding
from velox_tpu_torch.vector.fuzzer import FuzzerOptions, VectorFuzzer
from velox_tpu_torch.vector.string_table import StringTable

CPU = "cpu"


# ---- SEQUENCE / BIAS (tests/test_vector.py:140-233) ---------------------------


def test_sequence_decode():
    base = Column.from_numpy(np.array([10, 20, 30], dtype=np.int64), vtt.BIGINT)
    col = Column.sequence(base, [2, 3, 1], capacity=6)
    assert col.encoding == Encoding.SEQUENCE
    values, validity = col.to_numpy(6)
    np.testing.assert_array_equal(values, [10, 10, 20, 20, 20, 30])
    assert validity is None
    ref = RefColumn.sequence(
        RefColumn.from_numpy(np.array([10, 20, 30], dtype=np.int64), vt.BIGINT),
        [2, 3, 1], capacity=6,
    )
    np.testing.assert_array_equal(values, ref.to_numpy(6)[0])
    with pytest.raises(ValueError, match="no row capacity"):
        col.capacity


def test_sequence_run_nulls():
    vals = np.array([7, 0, 9], dtype=np.int64)
    valid = np.array([True, False, True])
    col = Column.sequence(Column.from_numpy(vals, vtt.BIGINT, validity=valid), [1, 2, 2], 5)
    ref = RefColumn.sequence(RefColumn.from_numpy(vals, vt.BIGINT, validity=valid), [1, 2, 2], 5)
    values, validity = col.to_numpy(5)
    np.testing.assert_array_equal(validity, [True, False, False, True, True])
    np.testing.assert_array_equal(values[[0, 3, 4]], [7, 9, 9])
    r_values, r_validity = ref.to_numpy(5)
    np.testing.assert_array_equal(validity, r_validity)
    np.testing.assert_array_equal(values, r_values)


def test_sequence_gather_composes_to_dictionary():
    base = Column.from_numpy(np.array([5, 6], dtype=np.int64), vtt.BIGINT)
    col = Column.sequence(base, [3, 3], capacity=6)
    g = col.gather(torch.tensor([5, 0, 2, 4], dtype=torch.int32))
    assert g.encoding == Encoding.DICTIONARY  # no materialization
    values, _ = g.to_numpy(4)
    np.testing.assert_array_equal(values, [6, 5, 5, 6])
    ref = RefColumn.sequence(
        RefColumn.from_numpy(np.array([5, 6], dtype=np.int64), vt.BIGINT), [3, 3], 6
    ).gather(jnp.asarray([5, 0, 2, 4], dtype=jnp.int32))
    np.testing.assert_array_equal(values, ref.to_numpy(4)[0])


def test_sequence_varchar():
    table = StringTable()
    codes = table.intern_all(["lo", "hi"])
    base = Column.flat(torch.as_tensor(codes), vtt.VARCHAR, None, table)
    col = Column.sequence(base, [1, 3], capacity=4)
    values, _ = col.to_numpy(4)
    assert list(values) == ["lo", "hi", "hi", "hi"]


def test_sequence_batch_capacity_comes_from_other_columns():
    seq = Column.sequence(Column.from_numpy(np.array([1, 2], np.int64), vtt.BIGINT), [3, 5], 8)
    flat = Column.from_numpy(np.arange(8, dtype=np.int64), vtt.BIGINT)
    b = Batch.make(vtt.RowType(["s", "f"], [vtt.BIGINT, vtt.BIGINT]), [seq, flat], 8)
    assert b.capacity == 8
    assert b.to_pydict()["s"].tolist() == [1, 1, 1, 2, 2, 2, 2, 2]


def test_bias_decode():
    bias = 1 << 40
    deltas = np.array([-3, 0, 7], dtype=np.int8)
    col = Column.bias(bias, deltas, vtt.BIGINT)
    assert col.encoding == Encoding.BIAS
    values, validity = col.to_numpy(3)
    np.testing.assert_array_equal(values, bias + deltas.astype(np.int64))
    assert validity is None
    np.testing.assert_array_equal(
        values, RefColumn.bias(bias, deltas, vt.BIGINT).to_numpy(3)[0]
    )


def test_bias_gather_and_nulls():
    deltas = np.array([1, 2, 3, 4], dtype=np.int16)
    valid = np.array([True, True, False, True])
    col = Column.bias(100, deltas, vtt.BIGINT, validity=torch.as_tensor(valid))
    g = col.gather(torch.tensor([3, 2, 0], dtype=torch.int32))
    assert g.encoding == Encoding.BIAS  # deltas gathered, bias kept
    values, validity = g.to_numpy(3)
    np.testing.assert_array_equal(validity, [True, False, True])
    np.testing.assert_array_equal(values[[0, 2]], [104, 101])
    ref = RefColumn.bias(100, deltas, vt.BIGINT, validity=jnp.asarray(valid)).gather(
        jnp.asarray([3, 2, 0], dtype=jnp.int32)
    )
    r_values, r_validity = ref.to_numpy(3)
    np.testing.assert_array_equal(validity, r_validity)
    np.testing.assert_array_equal(values, r_values)


@pytest.mark.parametrize("runs", [1, 2, 977, 1 << 14])
def test_sequence_decode_is_repeat_interleave(runs):
    """At 2^16 rows (where the JAX package's [rows, runs] compare would hold
    2^30 entries at 2^14 runs) the binary search gives the rows
    ``repeat_interleave`` gives, run nulls and gathers included."""
    rng = np.random.default_rng(runs)
    cap = 1 << 16
    cuts = np.sort(rng.choice(cap - 1, runs - 1, replace=False)) + 1
    lengths = np.diff(np.concatenate([[0], cuts, [cap]])).astype(np.int32)
    vals = rng.integers(-(1 << 40), 1 << 40, runs)
    valid = rng.random(runs) > 0.2
    col = Column.sequence(Column.from_numpy(vals, vtt.BIGINT, validity=valid), lengths, cap)
    values, validity = col.decode(cap)
    lt = torch.as_tensor(lengths).to(torch.int64)
    assert torch.equal(values, torch.repeat_interleave(torch.as_tensor(vals), lt))
    assert torch.equal(validity, torch.repeat_interleave(torch.as_tensor(valid), lt))
    idx = torch.as_tensor(rng.integers(0, cap, 4096))
    g_values, g_validity = col.gather(idx).decode(4096)
    assert torch.equal(g_values, values[idx])
    assert torch.equal(g_validity, validity[idx])


def test_fuzzer_sequence_bias_equivalence():
    """Fuzzed SEQUENCE/BIAS columns decode identically to their flat copy
    (the reference's encoding-equivalence discipline, VectorFuzzer.h:81), and
    to the JAX package's columns for the same seed."""
    opts = dict(sequence_ratio=0.45, bias_ratio=0.45, dictionary_ratio=0.0, constant_ratio=0.0)
    fz = VectorFuzzer(seed=7, options=FuzzerOptions(**opts), device=CPU)
    ref = RefFuzzer(seed=7, options=RefOptions(**opts))
    cap = 64
    seen = set()
    for _ in range(20):
        for dtype, rtype in ((vtt.BIGINT, vt.BIGINT), (vtt.INTEGER, vt.INTEGER),
                             (vtt.VARCHAR, vt.VARCHAR)):
            col = fz.column(dtype, cap)
            rcol = ref.column(rtype, cap)
            assert col.encoding.value == rcol.encoding.value
            seen.add(col.encoding)
            flat = fz.flat_copy(col, cap)
            v1, m1 = col.to_numpy(cap)
            v2, m2 = flat.to_numpy(cap)
            rv, rm = rcol.to_numpy(cap)
            live = np.ones(cap, bool) if m1 is None else np.asarray(m1)
            if m1 is None:
                assert m2 is None and rm is None
            else:
                np.testing.assert_array_equal(m1, m2)
                np.testing.assert_array_equal(m1, rm)
            np.testing.assert_array_equal(v1[live], v2[live])
            np.testing.assert_array_equal(v1[live], np.asarray(rv)[live])
    assert Encoding.SEQUENCE in seen and Encoding.BIAS in seen


@pytest.mark.parametrize("seed", range(6))
def test_fuzzer_vectors_equal_reference(seed):
    """Default options over every scalar type of the fuzzer: the same
    encodings, and the same values, validity and strings row for row."""
    fz = VectorFuzzer(seed, device=CPU)
    ref = RefFuzzer(seed)
    schema = fz.schema(12)
    rschema = ref.schema(12)
    assert [str(t) for t in schema.types] == [str(t) for t in rschema.types]
    cap = 96
    batch = fz.batch(schema, cap)
    rbatch = ref.batch(rschema, cap)
    assert int(batch.length) == int(rbatch.length)
    for c, rc in zip(batch.columns, rbatch.columns):
        assert c.encoding.value == rc.encoding.value
    got = batch.to_pandas()
    want = rbatch.to_pandas()
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


# ---- tests/test_fuzz.py ----------------------------------------------------------

EXPRS = [
    "c0 + c1",
    "c0 * 2 - c1",
    "c0 < c1",
    "c0 = c1 or c0 > 100",
    "if(c0 < c1, c0, c1)",
    "coalesce(c0, c1)",
    "try(c0 / c1)",
    "c0 is null",
    "case when c0 < 0 then 0 - c0 else c0 end",
    "abs(c0) + abs(c1)",
]

MORE_EXPRS = [
    "bitwise_and(c0, c1)",
    "bitwise_xor(c0, 255) + bit_count(c1)",
    "try(c0 % c1)",
    "case when c0 > c1 then c0 - c1 when c0 < c1 then c1 - c0 else 0 end",
    "coalesce(nullif(c0, c1), c1, 0)",
    "c0 between c1 - 5 and c1 + 5",
    "if(c0 is null, -1, c0)",
    "cast(c0 as double) / 3e0",
    "sign(c0) * least(abs(c0), abs(c1))",
]


def _lanes(r, n):
    def lane(x, fill):
        if x is None:
            return np.full(n, fill)
        return (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))[:n]

    return lane(r.values, 0), lane(r.validity, True), lane(r.errors, False)


def _check_encodings(seed, cap, exprs, options=None):
    fz = VectorFuzzer(seed, options, device=CPU)
    ref = RefFuzzer(seed, None if options is None else RefOptions(**vars(options)))
    schema = vtt.RowType(["c0", "c1"], [vtt.BIGINT, vtt.BIGINT])
    rschema = vt.RowType(["c0", "c1"], [vt.BIGINT, vt.BIGINT])
    batch = fz.batch(schema, cap)
    rbatch = ref.batch(rschema, cap)
    flat = Batch.make(schema, [fz.flat_copy(c, cap) for c in batch.columns], batch.length,
                      capacity=cap)
    n = int(batch.length)
    for sql in exprs:
        expr = parse_expr(sql, schema)
        [r1] = ExprSet([expr]).eval(batch)
        [r2] = ExprSet([expr]).eval(flat)
        [rr] = RefExprSet([ref_parse(sql, rschema)]).eval(rbatch)
        v1, valid1, err1 = _lanes(r1, n)
        v2, valid2, err2 = _lanes(r2, n)
        rv, rvalid, rerr = _lanes(rr, n)
        for other_valid, other_err in ((valid2, err2), (rvalid, rerr)):
            np.testing.assert_array_equal(valid1, other_valid, err_msg=sql)
            np.testing.assert_array_equal(err1, other_err, err_msg=sql)
        keep = valid1 & ~err1
        np.testing.assert_array_equal(v1[keep], v2[keep], err_msg=sql)
        np.testing.assert_array_equal(v1[keep], rv[keep], err_msg=sql)


@pytest.mark.parametrize("seed", range(8))
def test_encodings_equivalence(seed):
    """Common path over encoded inputs == flat path == the JAX package."""
    _check_encodings(seed, 64, EXPRS)


@pytest.mark.parametrize("seed", range(6))
def test_more_encodings_equivalence(seed):
    _check_encodings(100 + seed, 128, MORE_EXPRS)


@pytest.mark.parametrize("seed", range(4))
def test_sequence_bias_expression_equivalence(seed):
    """The same expressions over SEQUENCE / BIAS inputs (``chip_smoke.py``
    I7 at 2^24 rows)."""
    opts = FuzzerOptions(sequence_ratio=0.45, bias_ratio=0.45)
    _check_encodings(200 + seed, 256, EXPRS + MORE_EXPRS, opts)


@pytest.mark.parametrize("seed", range(4))
def test_arith_vs_numpy(seed):
    fz = VectorFuzzer(seed, FuzzerOptions(null_ratio=0.0, dictionary_ratio=0.0, constant_ratio=0.0),
                      device=CPU)
    schema = vtt.RowType(["c0", "c1"], [vtt.BIGINT, vtt.BIGINT])
    cap = 128
    batch = fz.batch(schema, cap, length=cap)
    a = batch.columns[0].data.numpy()
    b = batch.columns[1].data.numpy()
    cases = {
        "c0 + c1": a + b,
        "c0 - c1": a - b,
        "c0 * 2": a * 2,
        "c0 < c1": a < b,
        "greatest(c0, c1)": np.maximum(a, b),
        "least(c0, c1)": np.minimum(a, b),
    }
    for sql, expect in cases.items():
        [r] = ExprSet([parse_expr(sql, schema)]).eval(batch)
        np.testing.assert_array_equal(r.values.numpy()[:cap], expect, err_msg=sql)


def _run(plan, tile_rows):
    from velox_tpu_torch.exec import run_plan

    return run_plan(plan, tile_rows=tile_rows, device=CPU).to_pandas()


@pytest.mark.parametrize("seed", range(4))
def test_grouped_agg_fuzz_vs_pandas(seed):
    from velox_tpu_torch.io.table import Table
    from velox_tpu_torch.plan import PlanBuilder

    rng = np.random.default_rng(seed)
    n = 500
    keys = rng.integers(0, 20, n)
    vals = rng.integers(-1000, 1000, n)
    t = Table(vtt.RowType(["k", "v"], [vtt.BIGINT, vtt.BIGINT]), {"k": keys, "v": vals})
    plan = (
        PlanBuilder().table_scan(t)
        .aggregation(["k"], ["sum(v) as s", "min(v) as lo", "max(v) as hi", "count(*) as n"])
        .orderby(["k"]).build()
    )
    expect = (
        pd.DataFrame({"k": keys, "v": vals}).groupby("k")
        .agg(s=("v", "sum"), lo=("v", "min"), hi=("v", "max"), n=("v", "count"))
        .reset_index()
    )
    pd.testing.assert_frame_equal(_run(plan, 128), expect, check_dtype=False)


@pytest.mark.parametrize("seed", range(3))
def test_tiling_invariance_fuzz(seed):
    from velox_tpu_torch.io.table import Table
    from velox_tpu_torch.plan import PlanBuilder

    rng = np.random.default_rng(100 + seed)
    n = 700
    t = Table(
        vtt.RowType(["k", "v"], [vtt.BIGINT, vtt.decimal(12, 2)]),
        {"k": rng.integers(0, 50, n), "v": rng.integers(-10**6, 10**6, n)},
    )
    plan = (
        PlanBuilder().table_scan(t)
        .aggregation(["k"], ["sum(v) as s", "avg(v) as m"]).orderby(["k"]).build()
    )
    pd.testing.assert_frame_equal(_run(plan, 64), _run(plan, 1 << 12))


@pytest.mark.parametrize("seed", range(3))
def test_tiling_never_changes_query_results(seed):
    from velox_tpu_torch.io.table import Table
    from velox_tpu_torch.plan import PlanBuilder

    rng = np.random.default_rng(40 + seed)
    n = 3000
    t = Table(
        vtt.RowType(["a", "b", "g"], [vtt.BIGINT, vtt.BIGINT, vtt.BIGINT]),
        {"a": rng.integers(-100, 100, n), "b": rng.integers(1, 50, n),
         "g": rng.integers(0, 321, n)},
    )
    filters = ["a > 0", "a % b = 0", "a + b < 60", "bitwise_and(a, 1) = 1"]
    plan = (
        PlanBuilder()
        .table_scan(t, filter=filters[seed % len(filters)])
        .project(["g", "a * b as ab", "a - b as amb"])
        .aggregation(["g"], ["sum(ab) as s", "min(amb) as lo", "count(*) as c"])
        .orderby(["g"]).build()
    )
    base = _run(plan, 1 << 12)
    for tile in (256, 1024):
        pd.testing.assert_frame_equal(base, _run(plan, tile))
