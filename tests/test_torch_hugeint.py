"""Long decimals of the port (exec/hugeint.py + ops/int128.py) against the JAX
package's and against Python's arbitrary-precision ints: the cases of
``tests/test_hugeint.py`` but its Arrow / parquet / distributed ones (those
formats and the distributed executor come with later slices).

Every long-decimal result is compared exactly, limb pair for limb pair;
DOUBLE results (avg, casts to DOUBLE) to rtol 1e-9."""

import math
from decimal import Context, Decimal, localcontext

import numpy as np
import pytest
import torch

import velox_tpu as vt
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.ops import int128 as ref_i128
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu_torch.exec.runner import LocalExecutor, QueryError
from velox_tpu_torch.expr.registry import DEFAULT_REGISTRY as PORT_REGISTRY
from velox_tpu_torch.ops import int128 as port_i128
from velox_tpu_torch.ops.int128 import np_div_round, np_from_int, np_to_int
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import assert_same_rows, table_from_numpy

CX = Context(prec=60)
RNG = np.random.default_rng(7)


def rand_ints(n, seed=1, digits=30):
    """Random ints spanning ``digits`` decimal digits (beyond int64)."""
    rng = np.random.default_rng(seed)
    half = 10 ** (digits // 2)
    return [
        int(rng.integers(-half, half)) * int(rng.integers(1, half)) + int(rng.integers(0, 1000))
        for _ in range(n)
    ]


def _packed(vals):
    hi, lo = np_from_int(vals)
    return np.stack([lo, hi], axis=1)


def _tables(cols, types, validities=None):
    """The same columns as a table of each package; ``types`` are SQL type
    strings."""
    port = table_from_numpy(list(cols), types, cols, validities=validities)
    ref_types = [
        vt.decimal(*map(int, t[8:-1].split(","))) if t.startswith("DECIMAL") else getattr(vt, t)
        for t in types
    ]
    ref = RefTable(vt.RowType(list(cols), ref_types), dict(cols), {}, dict(validities or {}))
    return ref, port


def _both(cols, types, build, tile_rows=1 << 20, validities=None):
    """Run ``build(PlanBuilder, table)`` in both packages; assert the same
    rows; return the port's result."""
    ref_t, port_t = _tables(cols, types, validities)
    got = LocalExecutor(build(PlanBuilder, port_t), tile_rows=tile_rows, device="cpu").run()
    want = RefExecutor(build(RefBuilder, ref_t), tile_rows=tile_rows).run()
    assert list(got.schema.names) == list(want.schema.names)
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        gv, wv = got.validities.get(name), want.validities.get(name)
        np.testing.assert_array_equal(
            np.ones(len(g), bool) if gv is None else gv, np.ones(len(w), bool) if wv is None else wv
        )
        if dtype.is_floating:
            np.testing.assert_allclose(g, w, rtol=1e-9)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def _ints(col):
    return np_to_int(col[:, 1], col[:, 0])


# ---- ops/int128.py ---------------------------------------------------------


def _dev(name, *args):
    port_i128.register_i128_functions()
    sig = PORT_REGISTRY.signatures(name)[0]
    out = sig.impl(None, None, None, *[torch.from_numpy(np.asarray(a, np.int64)) for a in args])
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def test_limbs_roundtrip_and_numpy_twins_are_the_reference():
    vals = rand_ints(500, seed=3, digits=36)
    hi, lo = np_from_int(vals)
    assert np_to_int(hi, lo) == vals
    rh, rl = ref_i128.np_from_int(vals)
    np.testing.assert_array_equal(hi, rh)
    np.testing.assert_array_equal(lo, rl)


def test_device_functions_match_numpy_and_python_ints():
    a = rand_ints(300, seed=4, digits=34) + [0, -1, 1, -(2**127), 2**127 - 1, 2**64, -(2**64)]
    b = rand_ints(300, seed=5, digits=34) + [5, -1, 2**63, 1, -1, 2**64 - 1, 3]
    ah, al = np_from_int(a)
    bh, bl = np_from_int(b)
    exp_hi, exp_lo = port_i128.np_add(ah, al, bh, bl)
    np.testing.assert_array_equal(_dev("__i128_add_lo", al, bl), exp_lo)
    np.testing.assert_array_equal(_dev("__i128_add_hi", ah, al, bh, bl), exp_hi)
    np.testing.assert_array_equal(_dev("__i128_lt", ah, al, bh, bl), port_i128.np_lt(ah, al, bh, bl))
    np.testing.assert_array_equal(_dev("__i128_lte", ah, al, bh, bl), [x <= y for x, y in zip(a, b)])
    nh, nl = port_i128.np_neg(ah, al)
    np.testing.assert_array_equal(_dev("__i128_neg_hi", ah, al), nh)
    np.testing.assert_array_equal(_dev("__i128_neg_lo", al), nl)
    # hi * 2^64 + uint64(lo), rounded as the reference's numpy twin rounds it
    np.testing.assert_array_equal(_dev("__i128_to_double", ah, al), port_i128.np_to_double(ah, al))
    # 64 x 64 -> 128 from 32-bit half-limb products, edges included
    x = np.concatenate([RNG.integers(-(2**62), 2**62, 400), [-(2**63), 2**63 - 1, -1, 0, 1 << 32]])
    y = np.concatenate([RNG.integers(-(2**62), 2**62, 400), [-(2**63), -(2**63), -1, 7, 1 << 32]])
    eh, el = port_i128.np_mul_i64(x, y)
    np.testing.assert_array_equal(_dev("__i128_mul64_hi", x, y), eh)
    np.testing.assert_array_equal(_dev("__i128_mul64_lo", x, y), el)
    assert np_to_int(eh, el) == [int(p) * int(q) for p, q in zip(x, y)]
    # 128 x 128 truncated and checked products
    ma, mb = rand_ints(300, seed=6, digits=18), rand_ints(300, seed=7, digits=18)
    mah, mal = np_from_int(ma)
    mbh, mbl = np_from_int(mb)
    th, tl = port_i128.np_mul(mah, mal, mbh, mbl)
    np.testing.assert_array_equal(_dev("__i128_mul_hi", mah, mal, mbh, mbl), th)
    chk, over = _dev("__i128_mul_chk_hi", mah, mal, mbh, mbl)
    np.testing.assert_array_equal(chk, th)
    assert not over.any()
    big = [2 * 10**21, -(2**64), 2**63, -(2**63) * 2**0]
    bh2, bl2 = np_from_int(big)
    _, over = _dev("__i128_mul_chk_hi", bh2, bl2, bh2, bl2)
    assert over.tolist() == [v * v > 2**127 - 1 for v in big] == [True, True, False, False]
    # rounded division
    num, den = rand_ints(200, seed=8, digits=30), [v or 3 for v in rand_ints(200, seed=9, digits=12)]
    nh2, nl2 = np_from_int(num)
    dh2, dl2 = np_from_int(den)
    qh = _dev("__i128_div_hi", nh2, nl2, dh2, dl2)
    ql, err = _dev("__i128_div_lo", nh2, nl2, dh2, dl2)
    assert np_to_int(qh, ql) == np_div_round(num, den) and not err.any()


@pytest.mark.parametrize("which", ["hi", "lo"])
def test_from_double_matches_reference(which):
    import jax.numpy as jnp

    from velox_tpu.expr.registry import DEFAULT_REGISTRY as REF_REGISTRY

    xs = np.array([1.5e10, -2.25e10, 1e30, 0.0, 1.23456789123456789e18, -(2.0**80), 2.0**26 + 0.5, 0.1, -0.5])
    ref_i128.register_i128_functions()
    port_i128.register_i128_functions()
    name = f"__i128_from_double_{which}"
    want = REF_REGISTRY.signatures(name)[0].impl(None, None, None, jnp.asarray(xs))
    got = PORT_REGISTRY.signatures(name)[0].impl(None, None, None, torch.from_numpy(xs))
    if which == "hi":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- queries -----------------------------------------------------------------


def _long_cols(n=3000, seed=1, with_group=True):
    vals = rand_ints(n, seed)
    cols = {"v": _packed(vals)}
    types = ["DECIMAL(38,2)"]
    if with_group:
        cols["g"] = np.random.default_rng(seed + 1).integers(0, 8, n)
        types.append("BIGINT")
    return cols, types, vals


def test_filter_compare_literal():
    cols, types, vals = _long_cols()
    out = _both(cols, types, lambda B, t: B().table_scan(t).filter("v > 0.00").aggregation([], ["count(*) as c"]).build())
    assert int(out.columns["c"][0]) == sum(v > 0 for v in vals)


def test_project_add_negate_to_double():
    cols, types, vals = _long_cols(500, seed=9, with_group=False)
    out = _both(
        cols, types,
        lambda B, t: B().table_scan(t).project(["v + v as twice", "-v as neg", "cast(v as double) as d"]).build(),
    )
    assert _ints(out.columns["twice"]) == [2 * v for v in vals]
    assert _ints(out.columns["neg"]) == [-v for v in vals]
    np.testing.assert_allclose(out.columns["d"], [float(v) / 100 for v in vals], rtol=1e-12)


@pytest.mark.parametrize("tile_rows", [256, 1 << 16])
def test_sum_count_avg_min_max_grouped(tile_rows):
    cols, types, vals = _long_cols(4000, seed=11)
    g = np.asarray(cols["g"])
    out = _both(
        cols, types,
        lambda B, t: B().table_scan(t).aggregation(
            ["g"], ["sum(v) as s", "count(v) as c", "avg(v) as a", "min(v) as lo", "max(v) as hi"]
        ).build(),
        tile_rows=tile_rows,
    )
    df = out.to_pandas()
    for gid in range(8):
        sel = [v for v, gg in zip(vals, g) if gg == gid]
        row = df[df.g == gid].iloc[0]
        assert row["s"] == Decimal(sum(sel)).scaleb(-2, CX), gid
        assert int(row["c"]) == len(sel)
        np.testing.assert_allclose(float(row["a"]), sum(sel) / len(sel) / 100, rtol=1e-9)
        assert row["lo"] == Decimal(min(sel)).scaleb(-2, CX)
        assert row["hi"] == Decimal(max(sel)).scaleb(-2, CX)


def test_group_by_long_key():
    distinct = rand_ints(5, seed=15)
    rng = np.random.default_rng(16)
    picks = rng.integers(0, 5, 2000)
    cols = {"k": _packed([distinct[i] for i in picks]), "x": rng.integers(0, 100, 2000)}
    out = _both(
        cols, ["DECIMAL(38,2)", "BIGINT"],
        lambda B, t: B().table_scan(t).aggregation(["k"], ["count(*) as c"]).orderby(["k"]).build(),
    )
    got = {k: int(c) for k, c in zip(out.to_pandas()["k"], out.columns["c"])}
    assert got == {Decimal(d).scaleb(-2, CX): int((picks == i).sum()) for i, d in enumerate(distinct)}


def test_widening_multiply_and_nulls():
    rng = np.random.default_rng(17)
    a = rng.integers(10**8, 10**9, 2000)
    b = rng.integers(10**8, 10**9, 2000)
    valid = rng.random(2000) > 0.3
    out = _both(
        {"a": a, "b": b}, ["DECIMAL(18,2)", "DECIMAL(18,2)"],
        lambda B, t: B().table_scan(t).project(["widening_multiply(a, b) as p"]).aggregation(
            [], ["sum(p) as s", "count(p) as c"]
        ).build(),
        validities={"a": valid},
    )
    exact = sum(int(x) * int(y) for x, y, ok in zip(a, b, valid) if ok)
    assert out.to_pandas()["s"].iloc[0] == Decimal(exact).scaleb(-4, CX)
    assert int(out.columns["c"][0]) == int(valid.sum())


def test_long_multiply_and_divide_exact():
    a = rand_ints(700, seed=53, digits=30)
    b = [v or 7 for v in rand_ints(700, seed=54, digits=12)]
    cols = {"a": _packed(a), "b": _packed(b)}
    out = _both(
        cols, ["DECIMAL(38,2)", "DECIMAL(20,2)"],
        lambda B, t: B().table_scan(t).project(["a / b as q", "b * b as p"]).build(),
    )
    assert out.schema.type_of("q").scale == 2 and out.schema.type_of("p").scale == 4
    # rScale=2, k = 2 + 2 - 2 = 2: q = round_half_away(a*100 / b)
    assert _ints(out.columns["q"]) == np_div_round([x * 100 for x in a], b)
    assert _ints(out.columns["p"]) == [x * x for x in b]


def test_rescale_and_narrowing_casts():
    vals = rand_ints(600, seed=55, digits=24)
    out = _both(
        {"v": _packed(vals)}, ["DECIMAL(30,2)"],
        lambda B, t: B().table_scan(t).project(
            ["cast(v as decimal(38, 5)) as up", "cast(v as decimal(38, 0)) as down"]
        ).build(),
    )
    assert _ints(out.columns["up"]) == [v * 1000 for v in vals]
    assert _ints(out.columns["down"]) == np_div_round(vals, [100] * len(vals))
    small = [int(x) for x in RNG.integers(-(10**15), 10**15, 300)]
    out2 = _both(
        {"v": _packed(small)}, ["DECIMAL(30,2)"],
        lambda B, t: B().table_scan(t).project(["cast(v as bigint) as i", "cast(v as decimal(18, 4)) as s"]).build(),
    )
    np.testing.assert_array_equal(out2.columns["i"], np_div_round(small, [100] * len(small)))
    np.testing.assert_array_equal(out2.columns["s"], [v * 100 for v in small])


@pytest.mark.parametrize(
    "vals,types,expr",
    [
        ([10**24], "DECIMAL(30,2)", "cast(v as bigint) as i"),  # narrow overflow
        ([10**36], "DECIMAL(38,0)", "cast(v as decimal(38, 3)) as up"),  # rescale overflow
        ([2 * 10**21], "DECIMAL(38,2)", "v * v as p"),  # past int128
    ],
)
def test_overflow_raises(vals, types, expr):
    t = table_from_numpy(["v"], [types], {"v": _packed(vals)})
    with pytest.raises(QueryError):
        LocalExecutor(PlanBuilder().table_scan(t).project([expr]).build(), device="cpu").run()


def test_try_nulls_overflow_and_divide_by_zero_raises():
    t = table_from_numpy(["a"], ["DECIMAL(38,2)"], {"a": _packed([2 * 10**21])})
    out = LocalExecutor(PlanBuilder().table_scan(t).project(["try(a * a) as p"]).build(), device="cpu").run()
    assert out.to_pandas()["p"].isna().all()
    t2 = table_from_numpy(
        ["a", "b"], ["DECIMAL(38,2)", "DECIMAL(20,2)"],
        {"a": _packed([100, 200]), "b": np.zeros((2, 2), np.int64)},
    )
    with pytest.raises(QueryError):
        LocalExecutor(PlanBuilder().table_scan(t2).project(["a / b as q"]).build(), device="cpu").run()


def test_cast_double_to_long_decimal_exact():
    xs = [1.5, -2.25, 1e20, 0.0, 123456789.123456789, -(2.0**80), 2.0**26 + 0.5, 1e-11]
    out = _both(
        {"x": np.array(xs)}, ["DOUBLE"],
        lambda B, t: B().table_scan(t).project(["cast(x as decimal(38,10)) as d"]).build(),
    )
    with localcontext() as cx:
        cx.prec = 60
        for x, g in zip(xs, out.to_pandas()["d"]):
            raw = int(math.floor(abs(x * 10**10) + 0.5))
            assert g == Decimal(raw if x >= 0 else -raw) / Decimal(10**10), x
    for bad in (float("nan"), float("inf"), 1e38):
        tb = table_from_numpy(["x"], ["DOUBLE"], {"x": np.array([bad])})
        with pytest.raises(QueryError):
            LocalExecutor(PlanBuilder().table_scan(tb).project(["cast(x as decimal(38,2)) as d"]).build(), device="cpu").run()


def test_unsupported_raises():
    cols, types, _ = _long_cols(100, seed=21)
    t = table_from_numpy(list(cols), types, cols)
    with pytest.raises(NotImplementedError, match="long decimal|long-decimal"):
        LocalExecutor(PlanBuilder().table_scan(t).aggregation(["g"], ["arbitrary(v) as m"]).build(), device="cpu")


def test_join_on_long_decimal_key():
    distinct = rand_ints(40, seed=33)
    rng = np.random.default_rng(34)
    picks = rng.integers(0, 40, 3000)
    pv = [distinct[i] for i in picks]
    probe_cols = {"k": _packed(pv), "x": rng.integers(0, 100, 3000)}
    build_cols = {"bk": _packed(distinct[:25]), "y": rng.integers(0, 1000, 25)}
    ref_p, port_p = _tables(probe_cols, ["DECIMAL(38,2)", "BIGINT"])
    ref_b, port_b = _tables(build_cols, ["DECIMAL(38,2)", "BIGINT"])
    present = set(distinct[:25])
    matched = sum(v in present for v in pv)
    for jt, rows in (("inner", matched), ("left", len(pv)), ("left_semi", matched), ("anti", len(pv) - matched)):
        def plan(B, probe, build):
            return B().table_scan(probe).hash_join(
                B().table_scan(build).build(), ["k"], ["bk"],
                output=["x", "y"] if jt in ("inner", "left") else ["x"], join_type=jt,
            ).orderby(["x"] + (["y"] if jt in ("inner", "left") else [])).build()

        got = LocalExecutor(plan(PlanBuilder, port_p, port_b), tile_rows=512, device="cpu").run()
        want = RefExecutor(plan(RefBuilder, ref_p, ref_b), tile_rows=512).run()
        assert got.num_rows == rows
        assert_same_rows(got, want)


def test_order_by_and_topn_long_decimal():
    cols, types, vals = _long_cols(3000, seed=41, with_group=False)
    for clause, reverse in ((["v"], False), (["v desc"], True)):
        out = _both(cols, types, lambda B, t: B().table_scan(t).orderby(clause).build(), tile_rows=512)
        assert _ints(out.columns["v"]) == sorted(vals, reverse=reverse), clause
    out = _both(cols, types, lambda B, t: B().table_scan(t).topn(["v desc"], 7).build(), tile_rows=512)
    assert _ints(out.columns["v"]) == sorted(vals, reverse=True)[:7]
