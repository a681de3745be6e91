"""Direct-mode grouping primitives, aggregate accumulators and array grouping
of the port against the JAX package's, on the same numpy inputs.  Integer
accumulators must agree bit for bit; float64 sums to rtol 1e-12 (the two
frameworks add in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import velox_tpu as vt
import velox_tpu_torch as vtt
from velox_tpu.exec import aggregates as ref_agg
from velox_tpu.exec import grouping as ref_grp
from velox_tpu.ops import segmented as ref_seg
from velox_tpu.vector.column import Batch as RefBatch
from velox_tpu_torch.exec import aggregates as port_agg
from velox_tpu_torch.exec import grouping as port_grp
from velox_tpu_torch.ops import segmented as port_seg
from velox_tpu_torch.vector.column import Batch as PortBatch

N, G = 4096, 7


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        values = rng.normal(0, 100, N).astype(dtype)
    else:
        values = rng.integers(-(1 << 40), 1 << 40, N).astype(dtype)
    mask = rng.random(N) < 0.8
    gids = rng.integers(0, G, N).astype(np.int32)
    gids[rng.random(N) < 0.05] = G + 3  # out of range: contributes nowhere
    return values, mask, gids


def _close(got, want, floating):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if floating:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_masked_reduce(op, dtype):
    values, mask, _ = _inputs(dtype)
    want = ref_seg.masked_reduce(jnp.asarray(values), jnp.asarray(mask), op)
    got = port_seg.masked_reduce(torch.from_numpy(values), torch.from_numpy(mask), op)
    _close(got, want, dtype is np.float64 and op == "sum")
    empty = port_seg.masked_reduce(
        torch.from_numpy(values), torch.zeros(N, dtype=torch.bool), op
    )
    want_empty = ref_seg.masked_reduce(jnp.asarray(values), jnp.zeros(N, bool), op)
    _close(empty, want_empty, False)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_direct_group_reduce(op, dtype):
    values, mask, gids = _inputs(dtype, seed=1)
    want = ref_seg.direct_group_reduce(
        jnp.asarray(values), jnp.asarray(mask), jnp.asarray(gids), G, op
    )
    got = port_seg.direct_group_reduce(
        torch.from_numpy(values), torch.from_numpy(mask), torch.from_numpy(gids), G, op
    )
    _close(got, want, dtype is np.float64 and op == "sum")


def test_direct_group_reduce_batch_and_identities():
    values, mask, gids = _inputs(np.int64, seed=2)
    other = np.abs(values) % 1000
    items = [("sum", values), ("min", other), ("max", other)]
    want = ref_seg.direct_group_reduce_batch(
        [(jnp.asarray(v), op) for op, v in items], jnp.asarray(mask), jnp.asarray(gids), G
    )
    got = port_seg.direct_group_reduce_batch(
        [(torch.from_numpy(v), op) for op, v in items],
        torch.from_numpy(mask), torch.from_numpy(gids), G,
    )
    for g, w in zip(got, want):
        _close(g, w, False)
    for op in ("sum", "min", "max", "band", "bor"):
        for pd_, rd in ((torch.int64, jnp.int64), (torch.float64, jnp.float64)):
            if op in ("band", "bor") and pd_ is torch.float64:
                continue
            assert port_seg.identity_for(op, pd_) == ref_seg.identity_for(op, rd)


def _index_add_sum(values, mask, gids, num_groups):
    """direct_group_reduce's sum as it reads with ``index_add_``."""
    gid = gids.to(torch.int64)
    live = mask & (gid >= 0) & (gid < num_groups)
    index = torch.where(live, gid, torch.zeros_like(gid))
    v = torch.where(live, values, torch.zeros_like(values))
    return torch.zeros((num_groups,), dtype=values.dtype).index_add_(0, index, v)


@pytest.fixture(params=["contiguous", "strided"])
def layout(request, monkeypatch):
    """The operands as they come (contiguous) or as every other element of
    twice as many (strided views, which the kernel's route makes contiguous).
    Yields a function that lays out (values, mask, gids) and the calls that
    reached the kernel's wrapper (its plain version on the CPU)."""
    from velox_tpu_torch.ops import group_sum

    calls = []
    real = group_sum.grouped_int64_sums

    def counted(cols, gids, mask, num_groups):
        assert all(t.is_contiguous() for t in (*cols, gids, mask))
        calls.append((tuple(c.dtype for c in cols), gids.dtype, num_groups))
        return real(cols, gids, mask, num_groups)

    monkeypatch.setattr(group_sum, "grouped_int64_sums", counted)

    def lay_out(*tensors):
        if request.param == "contiguous":
            return tensors
        return tuple(torch.repeat_interleave(t, 2)[::2] for t in tensors)

    return lay_out, calls


def _sum_case(case, n=N):
    rng = np.random.default_rng(21)
    groups = G
    values = rng.integers(-(1 << 40), 1 << 40, n)
    mask = rng.random(n) < 0.8
    gids = rng.integers(0, G, n).astype(np.int32)
    if case == "99% dead":
        mask = rng.random(n) < 0.01
    elif case == "ids out of range":
        gids = rng.integers(-4, G + 4, n).astype(np.int32)
    elif case == "sums wrap past 2**63":
        values = rng.integers((1 << 62) - (1 << 40), 1 << 62, n)
    elif case == "int64 ids past int32":
        gids = rng.integers(0, G, n) + (rng.random(n) < 0.3) * (1 << 32)  # 2**32 + g: no group
    elif case == "int8 ids":
        gids = rng.integers(-1, G, n).astype(np.int8)
    elif case == "6144 groups":
        groups = 6144
        gids = rng.integers(-1, groups + 1, n).astype(np.int32)
    elif case == "6145 groups":
        groups = 6145
        gids = rng.integers(-1, groups + 1, n).astype(np.int32)
    return torch.from_numpy(values), torch.from_numpy(mask), torch.from_numpy(gids), groups


@pytest.mark.parametrize("case", [
    "99% dead", "ids out of range", "sums wrap past 2**63", "int64 ids past int32",
    "int8 ids", "6144 groups", "6145 groups",
])
def test_direct_int64_sum_equals_index_add(layout, case):
    """Bit for bit the ``index_add_`` formula; a table of one int64 a group
    takes the kernel's route up to 48 KB (6 144 groups) and keeps
    ``index_add_`` past it."""
    lay_out, calls = layout
    values, mask, gids, groups = _sum_case(case)
    values, mask, gids = lay_out(values, mask, gids)
    got = port_seg.direct_group_reduce(values, mask, gids, groups, "sum")
    want = _index_add_sum(values, mask, gids, groups)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    # the exact sums, wrapped mod 2**64
    v, m, g = values.numpy(), mask.numpy(), gids.numpy().astype(np.int64)
    live = m & (g >= 0) & (g < groups)
    exact = np.zeros(groups, dtype=object)
    np.add.at(exact, g[live], v[live].astype(object))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), (exact % (1 << 64)).astype(np.uint64))
    if case == "sums wrap past 2**63":
        assert any(x >= 1 << 63 for x in exact)
    taken = groups * 8 <= 48 * 1024
    assert calls == ([((torch.int64,), torch.int32, groups)] if taken else [])


@pytest.mark.parametrize("op,dtype", [
    ("sum", np.float64), ("min", np.int64), ("max", np.int64), ("min", np.float64),
    ("max", np.float64), ("sum", np.int32),
])
def test_direct_group_reduce_other_ops_keep_their_code(layout, op, dtype):
    """Float sums, min / max and narrower sums take no kernel and return
    what the JAX package does (an int32 sum, which the JAX package widens,
    what ``index_add_`` does)."""
    lay_out, calls = layout
    values, mask, gids = lay_out(*(torch.from_numpy(a) for a in _inputs(dtype, seed=9)))
    got = port_seg.direct_group_reduce(values, mask, gids, G, op)
    if dtype is np.int32:
        want = _index_add_sum(values, mask, gids, G)
    else:
        want = ref_seg.direct_group_reduce(
            jnp.asarray(values.numpy()), jnp.asarray(mask.numpy()), jnp.asarray(gids.numpy()), G, op
        )
    _close(got, want, dtype is np.float64 and op == "sum")
    assert calls == []


def _types(mod):
    return {
        "bigint": mod.BIGINT, "double": mod.DOUBLE,
        "dec": mod.decimal(12, 2), "date": mod.DATE,
    }


_CASES = [
    ("count", None), ("count", "bigint"), ("sum", "bigint"), ("sum", "dec"),
    ("sum", "double"), ("avg", "dec"), ("avg", "bigint"), ("avg", "double"),
    ("min", "bigint"), ("max", "dec"), ("min", "double"), ("max", "date"),
]


@pytest.mark.parametrize("name,tname", _CASES)
@pytest.mark.parametrize("groups", [1, G])
def test_bound_aggregate_update_merge_extract(name, tname, groups):
    rt = None if tname is None else _types(vt)[tname]
    pt = None if tname is None else _types(vtt)[tname]
    r = ref_agg.bind_aggregate(name, rt)
    p = port_agg.bind_aggregate(name, pt)
    assert str(p.result_type) == str(r.result_type)
    assert p.acc_ops == r.acc_ops and p.arg_roles == r.arg_roles
    assert [str(d).replace("torch.", "") for d in p.acc_dtypes] == [
        np.dtype(d).name for d in r.acc_dtypes
    ]
    floating = tname == "double"
    dtype = np.float64 if floating else (np.int32 if tname == "date" else np.int64)
    r_state, p_state = r.acc_init(groups), p.acc_init(groups, "cpu")
    halves = []
    for seed in (3, 4):  # two tiles, then a merge of two partial states
        values, mask, gids = _inputs(dtype, seed)
        gids = gids % groups
        rv = () if tname is None else (jnp.asarray(values),)
        pv = () if tname is None else (torch.from_numpy(values),)
        r_state = r.update(r_state, rv, jnp.asarray(mask), jnp.asarray(gids), groups)
        p_state = p.update(p_state, pv, torch.from_numpy(mask), torch.from_numpy(gids), groups)
        halves.append((r_state, p_state))
    for ra, pa in zip(r_state, p_state):
        _close(pa, ra, floating)
    r_m = r.merge(halves[0][0], halves[1][0])
    p_m = p.merge(halves[0][1], halves[1][1])
    for ra, pa in zip(r_m, p_m):
        _close(pa, ra, floating)
    r_vals, r_valid = r.extract(tuple(np.asarray(a) for a in r_state))
    p_vals, p_valid = p.extract(tuple(a.numpy() for a in p_state))
    np.testing.assert_allclose(
        np.asarray(p_vals, dtype=np.float64), np.asarray(r_vals, dtype=np.float64),
        rtol=1e-12 if floating or name == "avg" else 0,
    )
    assert (p_valid is None) == (r_valid is None)
    if p_valid is not None:
        np.testing.assert_array_equal(p_valid, r_valid)


def test_wide_sum_is_exact_past_int64():
    """Three 96-bit limb accumulators: values near 2**62 summed over a tile
    overflow int64 but not the limbs."""
    values = np.full(N, (1 << 62) - 5, dtype=np.int64)
    mask = np.ones(N, bool)
    gids = np.zeros(N, np.int32)
    p = port_agg.bind_aggregate("sum", vtt.BIGINT)
    r = ref_agg.bind_aggregate("sum", vt.BIGINT)
    assert len(p.acc_dtypes) == 3 and p.post_combine is not None
    ps = p.update(p.acc_init(1, "cpu"), (torch.from_numpy(values),), torch.from_numpy(mask), torch.from_numpy(gids), 1)
    rs = r.update(r.acc_init(1), (jnp.asarray(values),), jnp.asarray(mask), jnp.asarray(gids), 1)
    for pa, ra in zip(ps, rs):
        _close(pa, ra, False)
    hi, lo = int(ps[0][0]), int(ps[1][0])
    assert hi * (1 << 32) + lo == N * ((1 << 62) - 5)


@pytest.mark.parametrize("which", ["sum", "avg"])
def test_narrow_rebinding_accumulators(which):
    if which == "sum":
        p, r = port_agg.narrow_int_sum(vtt.decimal(18, 2)), ref_agg.narrow_int_sum(vt.decimal(18, 2))
    else:
        p, r = port_agg.narrow_int_avg(2), ref_agg.narrow_int_avg(2)
    values, mask, gids = _inputs(np.int64, seed=6)
    ps = p.update(p.acc_init(G, "cpu"), (torch.from_numpy(values),), torch.from_numpy(mask), torch.from_numpy(gids), G)
    rs = r.update(r.acc_init(G), (jnp.asarray(values),), jnp.asarray(mask), jnp.asarray(gids), G)
    assert p.acc_ops == r.acc_ops == ("sum", "sum")
    for pa, ra in zip(ps, rs):
        _close(pa, ra, False)
    pv, _ = p.extract(tuple(a.numpy() for a in ps))
    rv, _ = r.extract(tuple(np.asarray(a) for a in rs))
    np.testing.assert_allclose(np.asarray(pv, float), np.asarray(rv, float), rtol=1e-12)


def test_unported_aggregate_raises_by_name():
    # every aggregate of the JAX package is ported now, the sketches included
    # (test_torch_aggregates_extended.py); a name neither package knows
    # raises by name
    assert port_agg.bind_aggregate("approx_distinct", vtt.DOUBLE).name == "approx_distinct"
    with pytest.raises(KeyError, match="no_such_aggregate"):
        port_agg.bind_aggregate("no_such_aggregate", vtt.DOUBLE)


def _key_batches():
    rng = np.random.default_rng(7)
    n = 200
    flag = np.asarray(rng.choice(["A", "N", "R"], n), dtype=object)
    day = rng.integers(9000, 9010, n).astype(np.int32)
    yes = rng.random(n) < 0.5
    day_valid = rng.random(n) < 0.9
    names = ["flag", "day", "yes"]
    rb = RefBatch.from_numpy(
        vt.RowType(names, [vt.VARCHAR, vt.DATE, vt.BOOLEAN]), [flag, day, yes],
        [None, day_valid, None], capacity=256,
    )
    pb = PortBatch.from_numpy(
        vtt.RowType(names, [vtt.VARCHAR, vtt.DATE, vtt.BOOLEAN]), [flag, day, yes],
        [None, day_valid, None], capacity=256, device="cpu",
    )
    return rb, pb


def test_key_info_and_array_grouping():
    rb, pb = _key_batches()
    r_infos = [
        ref_grp.key_info("flag", vt.VARCHAR, rb.column("flag").strings),
        ref_grp.key_info("day", vt.DATE, None, (9000, 9009), nullable=True),
        ref_grp.key_info("yes", vt.BOOLEAN, None),
    ]
    p_infos = [
        port_grp.key_info("flag", vtt.VARCHAR, pb.column("flag").strings),
        port_grp.key_info("day", vtt.DATE, None, (9000, 9009), nullable=True),
        port_grp.key_info("yes", vtt.BOOLEAN, None),
    ]
    for p, r in zip(p_infos, r_infos):
        assert (p.radix, p.bounds, p.nullable) == (r.radix, r.bounds, r.nullable)
    unbounded = port_grp.key_info("x", vtt.BIGINT, None, (0, 1 << 20))
    assert unbounded.radix is None
    rg, pg = ref_grp.ArrayGrouping(r_infos), port_grp.ArrayGrouping(p_infos)
    assert (pg.num_groups, pg.strides, pg.radixes) == (rg.num_groups, rg.strides, rg.radixes)
    np.testing.assert_array_equal(pg.group_ids(pb).numpy()[:200], np.asarray(rg.group_ids(rb))[:200])
    for p, r in zip(pg.key_arrays(), rg.key_arrays()):
        assert p.dtype == r.dtype
        np.testing.assert_array_equal(p, r)
    for p, r in zip(pg.key_validities(), rg.key_validities()):
        assert (p is None) == (r is None)
        if p is not None:
            np.testing.assert_array_equal(p, r)
    # sort mode takes the same keys: a packed word when they all have bounds
    sg, rsg = port_grp.SortGrouping(p_infos), ref_grp.SortGrouping(r_infos)
    plan, rplan = sg.pack_plan(1 << 14), rsg.pack_plan(1 << 14)
    assert (plan.bits, plan.shifts, plan.null_codes) == (rplan.bits, rplan.shifts, rplan.null_codes)
