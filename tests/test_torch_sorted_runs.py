"""Sorted-run primitives, sort-key packing and compaction of the port against
the JAX package's, on the same numpy inputs (made from a seed).

Integers, masks and positions must agree exactly (the port holds index
tensors as int64 where the JAX package holds int32: values are compared, not
dtypes).  A run sum of DOUBLE values is a prefix sum and a difference in the
JAX package and a scatter-add of the run's own rows in the port: rtol 1e-9,
with an absolute slack of 1e-6 for sums that cancel to nearly nothing."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from velox_tpu.ops import compact as ref_compact
from velox_tpu.ops import segmented as ref_seg
from velox_tpu.ops import sortkey as ref_key
from velox_tpu.vector.column import Batch as RefBatch
from velox_tpu_torch.ops import compact as port_compact
from velox_tpu_torch.ops import segmented as port_seg
from velox_tpu_torch.ops import sortkey as port_key
from velox_tpu_torch.vector.column import Batch as PortBatch

import velox_tpu as vt
import velox_tpu_torch as vtt

N = 2048


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, n=None):
    got, want = _np(got), np.asarray(want)
    if n is not None:
        got, want = got[:n], want[:n]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(want.dtype), want)


def _case(name, seed=0):
    """(keys sorted ascending with dead rows interleaved, live mask)."""
    rng = np.random.default_rng(seed)
    if name == "empty":
        return np.zeros(0, np.int64), np.zeros(0, bool)
    if name == "one_run":
        return np.full(N, 7, np.int64), rng.random(N) < 0.7
    if name == "all_dead":
        return np.sort(rng.integers(0, 50, N)).astype(np.int64), np.zeros(N, bool)
    if name == "all_distinct":
        return np.arange(N, dtype=np.int64), np.ones(N, bool)
    if name == "dead_between":
        keys = np.sort(rng.integers(0, 40, N)).astype(np.int64)
        mask = np.ones(N, bool)
        # kill whole runs and the rows around every key change
        mask[np.isin(keys, [3, 4, 17])] = False
        change = np.flatnonzero(np.diff(keys) != 0)
        mask[change[::2]] = False
        mask[np.minimum(change[1::3] + 1, N - 1)] = False
        return keys, mask
    # "dead_inside": random holes in every run
    keys = np.sort(rng.integers(0, 60, N)).astype(np.int64)
    return keys, rng.random(N) < 0.6


CASES = ["dead_inside", "dead_between", "one_run", "all_dead", "all_distinct"]


def _diff(keys):
    return keys != np.roll(keys, 1)


def _both_runs(keys, mask):
    diff = _diff(keys)
    rb = ref_seg.run_boundaries(jnp.asarray(diff), jnp.asarray(mask))
    pb = port_seg.run_boundaries(torch.from_numpy(diff), torch.from_numpy(mask))
    return (
        ref_seg.SortedRuns(rb, jnp.asarray(mask)),
        port_seg.SortedRuns(pb, torch.from_numpy(mask)),
    )


@pytest.mark.parametrize("case", CASES)
def test_run_boundaries_and_ends(case):
    keys, mask = _case(case)
    diff = _diff(keys)
    want = ref_seg.run_boundaries(jnp.asarray(diff), jnp.asarray(mask))
    got = port_seg.run_boundaries(torch.from_numpy(diff), torch.from_numpy(mask))
    _same(got, want)
    # a boundary is the first live row of each live key
    live_keys = keys[mask]
    assert int(_np(got).sum()) == len(np.unique(live_keys))
    want_end = ref_seg.run_is_end(want, jnp.asarray(mask))
    got_end = port_seg.run_is_end(got, torch.from_numpy(mask))
    _same(got_end, want_end)
    assert int(_np(got_end).sum()) == len(np.unique(live_keys))


@pytest.mark.parametrize("case", CASES)
def test_sorted_runs_structure(case):
    keys, mask = _case(case)
    ref, port = _both_runs(keys, mask)
    n = int(ref.num_runs)
    assert int(port.num_runs) == n == len(np.unique(keys[mask]))
    assert port.num_runs.dtype == torch.int32
    _same(port.run_index, ref.run_index)
    _same(port.is_end, ref.is_end)
    _same(port.end_positions, ref.end_positions)  # whole permutation: stable
    _same(port.start_positions(), ref.start_positions(), n)
    _same(port.run_mask(), ref.run_mask())
    _same(port.first(torch.from_numpy(keys)), ref.first(jnp.asarray(keys)), n)
    np.testing.assert_array_equal(
        _np(port.first(torch.from_numpy(keys)))[:n], np.unique(keys[mask])
    )


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("case", CASES)
def test_run_reduce_int64(case, op):
    keys, mask = _case(case)
    rng = np.random.default_rng(5)
    # near 2^63: prefix sums wrap, the difference at the run ends does not
    values = rng.integers(-(1 << 62), 1 << 62, len(keys)).astype(np.int64)
    vmask = rng.random(len(keys)) < 0.9
    ref, port = _both_runs(keys, mask)
    n = int(ref.num_runs)
    want = ref.reduce(jnp.asarray(values), jnp.asarray(vmask), op)
    got = port.reduce(torch.from_numpy(values), torch.from_numpy(vmask), op)
    _same(got, want, n)
    # and against plain numpy, group by group
    live = mask & vmask
    ident = {"sum": 0, "min": np.iinfo(np.int64).max, "max": np.iinfo(np.int64).min}[op]
    fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
    for r, k in enumerate(np.unique(keys[mask])):
        sel = values[live & (keys == k)]
        expect = fn.reduce(sel) if len(sel) else ident
        assert int(_np(got)[r]) == int(expect)


@pytest.mark.parametrize("case", ["dead_inside", "dead_between", "one_run"])
def test_run_sum_double_holds_rtol_1e9(case):
    keys, mask = _case(case)
    values = np.random.default_rng(9).normal(0, 1e3, len(keys))
    ref, port = _both_runs(keys, mask)
    n = int(ref.num_runs)
    ones = np.ones(len(keys), bool)
    want = np.asarray(ref.reduce(jnp.asarray(values), jnp.asarray(ones), "sum"))[:n]
    got = _np(port.reduce(torch.from_numpy(values), torch.from_numpy(ones), "sum"))[:n]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-6)
    exact = [values[mask & (keys == k)].sum() for k in np.unique(keys[mask])]
    np.testing.assert_allclose(got, exact, rtol=1e-9, atol=1e-6)


def test_empty_tile():
    keys, mask = _case("empty")
    b = port_seg.run_boundaries(torch.from_numpy(keys != keys), torch.from_numpy(mask))
    runs = port_seg.SortedRuns(b, torch.from_numpy(mask))
    assert int(runs.num_runs) == 0 and runs.end_positions.shape == (0,)
    for op in ("sum", "min", "max"):
        assert runs.reduce(torch.from_numpy(keys), torch.from_numpy(mask), op).shape == (0,)
    assert runs.first(torch.from_numpy(keys)).shape == (0,)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_segmented_scan(op, dtype):
    rng = np.random.default_rng(2)
    if dtype is np.int64:
        values = rng.integers(-(1 << 40), 1 << 40, N).astype(dtype)
    else:
        values = rng.normal(0, 10, N)
    boundary = rng.random(N) < 0.05  # row 0 may or may not start a segment
    want = np.asarray(ref_seg.segmented_scan(jnp.asarray(values), jnp.asarray(boundary), op))
    got = _np(port_seg.segmented_scan(torch.from_numpy(values), torch.from_numpy(boundary), op))
    if dtype is np.float64 and op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_unported_scans_raise_by_name():
    """Every op of the JAX package is ported (``band`` / ``bor`` and the
    pair scans are held to it below); an op neither package has raises by
    name."""
    x = torch.zeros(4, dtype=torch.int64)
    b = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="prod"):
        port_seg.segmented_scan(x, b, "prod")
    runs = port_seg.SortedRuns(b, b)
    with pytest.raises(NotImplementedError, match="prod"):
        runs.reduce(x, b, "prod")
    with pytest.raises(NotImplementedError, match="prod"):
        port_seg.masked_reduce(x, b, "prod")


def _bits(n, seed):
    rng = np.random.default_rng(seed)
    # a few set bits a row, so ANDs over a run are not all zero
    return (rng.integers(0, 1 << 62, n) | (1 << 40) | 5).astype(np.int64) & ~(
        rng.integers(0, 1 << 20, n).astype(np.int64)
    )


@pytest.mark.parametrize("op", ["band", "bor"])
@pytest.mark.parametrize("case", ["dead_inside", "dead_between", "one_run", "all_distinct"])
def test_bitwise_run_reduce_and_scan(case, op):
    keys, mask = _case(case)
    values = _bits(len(keys), 11)
    ref, port = _both_runs(keys, mask)
    n = int(ref.num_runs)
    vmask = np.random.default_rng(12).random(len(keys)) < 0.9
    _same(
        port.reduce(torch.from_numpy(values), torch.from_numpy(vmask), op),
        ref.reduce(jnp.asarray(values), jnp.asarray(vmask), op), n,
    )
    boundary = np.random.default_rng(13).random(len(keys)) < 0.05
    _same(
        port_seg.segmented_scan(torch.from_numpy(values), torch.from_numpy(boundary), op),
        ref_seg.segmented_scan(jnp.asarray(values), jnp.asarray(boundary), op),
    )


@pytest.mark.parametrize("op", ["band", "bor"])
@pytest.mark.parametrize("groups", [1, 5, 64])
def test_bitwise_direct_and_masked_reduce(groups, op):
    rng = np.random.default_rng(groups)
    values = _bits(N, groups)
    mask = rng.random(N) < 0.8
    gids = rng.integers(0, groups, N).astype(np.int32)
    if groups > 1:
        gids[gids == 3] = 4  # a group with no rows keeps the identity
    _same(
        port_seg.direct_group_reduce(
            torch.from_numpy(values), torch.from_numpy(mask), torch.from_numpy(gids), groups, op
        ),
        ref_seg.direct_group_reduce(jnp.asarray(values), jnp.asarray(mask), jnp.asarray(gids), groups, op),
    )
    assert int(port_seg.masked_reduce(torch.from_numpy(values), torch.from_numpy(mask), op)) == int(
        ref_seg.masked_reduce(jnp.asarray(values), jnp.asarray(mask), op)
    )


def _pair_inputs(n, seed, dtype):
    rng = np.random.default_rng(seed)
    # few distinct orderings: ties decide by the smaller payload
    y = rng.integers(0, 6, n).astype(dtype)
    x = rng.integers(-50, 50, n).astype(np.int64)
    return y, x


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_pair_scans_and_reductions(op, dtype):
    keys, mask = _case("dead_inside")
    y, x = _pair_inputs(len(keys), 21, dtype)
    vmask = np.random.default_rng(22).random(len(keys)) < 0.9
    ref, port = _both_runs(keys, mask)
    n = int(ref.num_runs)
    got = port.reduce_pair(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(vmask), op)
    want = ref.reduce_pair(jnp.asarray(y), jnp.asarray(x), jnp.asarray(vmask), op)
    for g, w in zip(got, want):
        _same(g, w, n)
    boundary = np.random.default_rng(23).random(len(keys)) < 0.05
    for g, w in zip(
        port_seg.segmented_scan_pair(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(boundary), op),
        ref_seg.segmented_scan_pair(jnp.asarray(y), jnp.asarray(x), jnp.asarray(boundary), op),
    ):
        _same(g, w)
    gids = np.random.default_rng(24).integers(0, 7, len(keys)).astype(np.int32)
    for g, w in zip(
        port_seg.direct_group_reduce_pair(
            torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(vmask), torch.from_numpy(gids), 7, op
        ),
        ref_seg.direct_group_reduce_pair(
            jnp.asarray(y), jnp.asarray(x), jnp.asarray(vmask), jnp.asarray(gids), 7, op
        ),
    ):
        _same(g, w)
    for g, w in zip(
        port_seg.masked_reduce_pair(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(vmask), op),
        ref_seg.masked_reduce_pair(jnp.asarray(y), jnp.asarray(x), jnp.asarray(vmask), op),
    ):
        assert float(g) == float(w)


# ---- ops/sortkey -----------------------------------------------------------

BOUNDS = [
    ([(0, 9), (-5, 5), (100, 100)], 11, (0,), ()),
    ([(-(1 << 31), (1 << 31) - 1), (0, 2555)], 12, (0,), (1,)),
    ([(0, 1), (0, 1), (0, 1)], 4, (0, 1, 2), (0, 2)),
    ([(0, (1 << 40) - 1), (0, (1 << 20))], 10, (0,), (0,)),  # 64 bits: no fit
    ([(5, 5)], 0, (), ()),
]


@pytest.mark.parametrize("bounds,extra,sentinel,nulls", BOUNDS)
def test_pack_plan_fit(bounds, extra, sentinel, nulls):
    want = ref_key.PackPlan.fit(bounds, extra, sentinel, nulls)
    got = port_key.PackPlan.fit(bounds, extra, sentinel, nulls)
    if want is None:
        assert got is None
        return
    assert (got.los, got.bits, got.shifts, got.total_bits, got.null_codes) == (
        want.los, want.bits, want.shifts, want.total_bits, want.null_codes
    )
    for i in range(len(bounds)):
        assert got.sentinel_code(i) == want.sentinel_code(i)
        assert got.null_value(i) == want.null_value(i)


@pytest.mark.parametrize("bounds,extra,sentinel,nulls", [b for b in BOUNDS if b[0] != BOUNDS[3][0]])
def test_pack_unpack_roundtrip(bounds, extra, sentinel, nulls):
    rng = np.random.default_rng(1)
    ref = ref_key.PackPlan.fit(bounds, extra, sentinel, nulls)
    port = port_key.PackPlan.fit(bounds, extra, sentinel, nulls)
    # edge values of every field first, then random ones
    vals = []
    for lo, hi in bounds:
        v = rng.integers(lo, hi + 1, N).astype(np.int64)
        v[0], v[1] = lo, hi
        vals.append(v)
    valids = [rng.random(N) < 0.8 if i in nulls else None for i in range(len(bounds))]
    dead = rng.random(N) < 0.1
    want = ref.pack_with_sentinel(
        [jnp.asarray(v) for v in vals], jnp.asarray(dead),
        [None if v is None else jnp.asarray(v) for v in valids],
    )
    got = port.pack_with_sentinel(
        [torch.from_numpy(v) for v in vals], torch.from_numpy(dead),
        [None if v is None else torch.from_numpy(v) for v in valids],
    )
    _same(got, want)
    assert int(_np(got).min()) >= 0  # at most 63 bits: shifts stay logical
    for i in range(len(bounds)):
        _same(port.unpack(got, i), ref.unpack(want, i))
        live = ~dead if valids[i] is None else (~dead & valids[i])
        np.testing.assert_array_equal(_np(port.unpack(got, i))[live], vals[i][live])
        if valids[i] is not None:
            null_rows = ~dead & ~valids[i]
            assert (_np(port.unpack(got, i))[null_rows] == port.null_value(i)).all()
    _same(port.key_part(got), ref.key_part(want))
    # every dead row packs to one word above every live word
    if dead.any() and (~dead).any() and sentinel:
        assert _np(got)[dead].min() > _np(got)[~dead].max()


def test_packed_sort_with_index():
    rng = np.random.default_rng(3)
    bounds = [(0, 30), (-3, 3)]
    vals = [rng.integers(lo, hi + 1, N).astype(np.int64) for lo, hi in bounds]
    dead = rng.random(N) < 0.2
    args = (bounds, ref_key.index_bits(N), (0,), ())
    assert port_key.index_bits(N) == ref_key.index_bits(N)
    assert [port_key.index_bits(n) for n in (0, 1, 2, 3, 1 << 24)] == [
        ref_key.index_bits(n) for n in (0, 1, 2, 3, 1 << 24)
    ]
    want = ref_key.packed_sort_with_index(
        ref_key.PackPlan.fit(*args), [jnp.asarray(v) for v in vals], jnp.asarray(dead), N
    )
    got = port_key.packed_sort_with_index(
        port_key.PackPlan.fit(*args), [torch.from_numpy(v) for v in vals],
        torch.from_numpy(dead), N,
    )
    for g, w in zip(got, want):
        _same(g, w)
    # live rows first, in (field 0, field 1, row) order
    perm = _np(got[2])
    n_live = int((~dead).sum())
    expect = np.lexsort((np.arange(N), vals[1], vals[0], dead))
    np.testing.assert_array_equal(perm[:n_live], expect[:n_live])


@pytest.mark.parametrize("num_keys", [1, 2, 3])
def test_sort_operands_is_lax_sort(num_keys):
    """``sort_operands`` stands for ``jax.lax.sort`` with several operands:
    lexicographic on the first ``num_keys``, stable (ties keep input order)."""
    rng = np.random.default_rng(4)
    ops = [
        rng.random(N) < 0.5,  # a bool key: False first
        rng.integers(0, 5, N).astype(np.int64),
        rng.integers(0, 3, N).astype(np.int32),
        np.arange(N, dtype=np.int64),
        rng.normal(size=N),
    ]
    want = jax.lax.sort([jnp.asarray(o) for o in ops], num_keys=num_keys, is_stable=True)
    got = port_key.sort_operands([torch.from_numpy(o) for o in ops], num_keys=num_keys)
    for g, w in zip(got, want):
        _same(g, w)


# ---- ops/compact -------------------------------------------------------------


@pytest.mark.parametrize("case", ["some", "none", "all"])
def test_compaction(case):
    rng = np.random.default_rng(6)
    mask = {"some": rng.random(N) < 0.3, "none": np.zeros(N, bool), "all": np.ones(N, bool)}[case]
    want_perm, want_n = ref_compact.compaction_indices(jnp.asarray(mask))
    got_perm, got_n = port_compact.compaction_indices(torch.from_numpy(mask))
    _same(got_perm, want_perm)
    assert int(got_n) == int(want_n) == int(mask.sum())

    a = rng.integers(-100, 100, N).astype(np.int64)
    b = rng.normal(size=N)
    bv = rng.random(N) < 0.9
    r_schema = vt.RowType(["a", "b"], [vt.BIGINT, vt.DOUBLE])
    p_schema = vtt.RowType(["a", "b"], [vtt.BIGINT, vtt.DOUBLE])
    rb = RefBatch.from_numpy(r_schema, [a, b], [None, bv]).with_selection(jnp.asarray(mask))
    pb = PortBatch.from_numpy(p_schema, [a, b], [None, bv], device="cpu").with_selection(
        torch.from_numpy(mask)
    )
    rc, pc = ref_compact.compact(rb), port_compact.compact(pb)
    n = int(pc.length)
    assert n == int(rc.length) and pc.selection is None and pc.capacity == N
    for name in ("a", "b"):
        gv, gval = pc.column(name).decode(N)
        wv, wval = rc.column(name).decode(N)
        _same(gv, wv, n)
        if wval is not None:
            _same(gval, wval, n)
    np.testing.assert_array_equal(_np(pc.column("a").data)[:n], a[mask])
