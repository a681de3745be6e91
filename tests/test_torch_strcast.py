"""String construction of the port (``exec/strcast.py``) against the JAX
package's: the cases of ``tests/test_strcast.py`` — numeric, boolean, date,
timestamp and decimal casts to VARCHAR, NULLs and TRY, array_join over
string and numeric arrays, constructed strings as grouping / DISTINCT keys
and through a join, the gates, a SQL text, string functions chained over a
construction and ORDER BY a constructed string — on the same rows, with the
reference test's expected rows.

``chr`` and ``bin`` are registered by the Spark functions of both packages:
``test_bin_chr`` and ``test_order_by_bool`` (the reference's
``test_order_by_chr_and_bool``) call them by name, and their render specs
are also held against the JAX package's directly.  The JAX
package's distributed case (``test_distributed_matches_local``) waits for
the multi-device slice."""

import numpy as np
import pytest

from test_torch_complex import PORT, REF
from velox_tpu_torch.testing import assert_same_values, python_rows


def _scan(pkg, cols, types, validities=None, **arrays):
    tt = [getattr(pkg.t, t) if isinstance(t, str) else t(pkg) for t in types]
    t = pkg.Table(pkg.t.RowType(cols, tt), arrays, validities=validities or {})
    return pkg.B().table_scan(t)


def _both(make, sort_key=None):
    """``make(k)`` (a plan) through both packages; asserts the same rows
    (in order, or sorted by ``sort_key``) and returns the port's."""
    def rows(k):
        out = python_rows(k.run(make(k)))
        if sort_key is not None:
            order = sorted(range(len(out[sort_key])), key=lambda i: repr(out[sort_key][i]))
            out = {c: [v[i] for i in order] for c, v in out.items()}
        return out

    got, want = rows(PORT), rows(REF)
    assert list(got) == list(want)
    for col in want:
        assert_same_values(got[col], want[col], path=col)
    return got


def _raises_in_both(make, exc):
    for k in (PORT, REF):
        with pytest.raises(exc):
            k.run(make(k))


def _dec(k):
    return k.t.decimal(10, 2)


class TestScalarRender:
    def test_cast_integers(self):
        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], i=np.array([5, -17, 1234567890123]))
                    .project(["cast(i as varchar) as s"]).build())
        assert out["s"] == ["5", "-17", "1234567890123"]

    def test_cast_double_specials(self):
        d = np.array([1.5, -0.25, float("nan"), float("inf"), float("-inf")])
        out = _both(lambda k: _scan(k, ["d"], ["DOUBLE"], d=d)
                    .project(["cast(d as varchar) as s"]).build())
        assert out["s"] == ["1.5", "-0.25", "NaN", "Infinity", "-Infinity"]

    def test_cast_boolean_date_timestamp_decimal(self):
        out = _both(lambda k: _scan(
            k, ["b", "dt", "ts", "dc"], ["BOOLEAN", "DATE", "TIMESTAMP", _dec],
            b=np.array([True, False]), dt=np.array([0, 19000], np.int32),
            ts=np.array([0, 1_600_000_000_123_456], np.int64), dc=np.array([-12345, 700], np.int64),
        ).project([
            "cast(b as varchar) as sb", "cast(dt as varchar) as sd",
            "cast(ts as varchar) as st", "cast(dc as varchar) as sc",
        ]).build())
        assert out["sb"] == ["true", "false"]
        assert out["sd"] == ["1970-01-01", "2022-01-08"]
        assert out["st"] == ["1970-01-01 00:00:00.000", "2020-09-13 12:26:40.123"]
        assert out["sc"] == ["-123.45", "7.00"]

    def test_bin_chr(self):
        """``bin`` / ``chr`` by name (the Spark package registers them) through
        the string-construction rewrite, and their render specs."""
        from velox_tpu.exec.strcast import RenderSpec as RefSpec
        from velox_tpu.exec.strcast import _render_scalar as ref_render
        from velox_tpu_torch.exec.strcast import RenderSpec, _render_scalar

        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], i=np.array([5, -1, 65]))
                    .project(["bin(i) as b", "chr(i % 64 + 60) as c"]).build())
        assert out["b"] == ["101", "1" * 64, "1000001"]
        assert out["c"] == [chr(65), chr(59), chr(61)]
        values = np.array([5, -1, 65], np.int64)
        b = _render_scalar(RenderSpec("bin", PORT.t.BIGINT), values)
        assert b == ref_render(RefSpec("bin", REF.t.BIGINT), values) == ["101", "1" * 64, "1000001"]
        codes = np.array([65, 59, 61], np.int64)  # i % 64 + 60 of the reference case
        c = _render_scalar(RenderSpec("chr", PORT.t.BIGINT), codes)
        assert c == ref_render(RefSpec("chr", REF.t.BIGINT), codes) == ["A", ";", "="]

    def test_null_propagates(self):
        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], i=np.array([5, 0, 7]),
                                    validities={"i": np.array([True, False, True])})
                    .project(["cast(i as varchar) as s"]).build())
        assert out["s"] == ["5", None, "7"]

    def test_try_wrapping_is_transparent(self):
        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], i=np.array([3]))
                    .project(["try(cast(i as varchar)) as s"]).build())
        assert out["s"] == ["3"]

    def test_try_protects_erroring_argument(self):
        out = _both(lambda k: _scan(k, ["a", "b"], ["BIGINT", "BIGINT"],
                                    a=np.array([6, 7]), b=np.array([2, 0]))
                    .project(["try(cast(a / b as varchar)) as s"]).build())
        assert out["s"] == ["3", None]


def _array_table(k):
    st = k.t.array(k.t.VARCHAR)
    seg, val = k.Seg.from_pylist([["x", "y"], [], ["a", None, "b"], None], st)
    return k.Table(k.t.RowType(["a"], [st]), {"a": seg}, validities={"a": val})


class TestArrayJoin:
    def test_join_skips_nulls(self):
        out = _both(lambda k: k.B().table_scan(_array_table(k))
                    .project(["array_join(a, ',') as j"]).build())
        assert out["j"] == ["x,y", "", "a,b", None]

    def test_join_null_replacement(self):
        out = _both(lambda k: k.B().table_scan(_array_table(k))
                    .project(["array_join(a, ',', 'N') as j"]).build())
        assert out["j"][2] == "a,N,b"

    def test_join_numeric_elements(self):
        def make(k):
            seg, _ = k.Seg.from_pylist([[1, 2, 3], [], [7]], k.t.array(k.t.BIGINT))
            t = k.Table(k.t.RowType(["a"], [k.t.array(k.t.BIGINT)]), {"a": seg})
            return k.B().table_scan(t).project(["array_join(a, '-') as j"]).build()

        assert _both(make)["j"] == ["1-2-3", "", "7"]


class TestKeyUses:
    def test_group_by_constructed_key(self):
        out = _both(lambda k: _scan(k, ["x", "v"], ["BIGINT", "DOUBLE"],
                                    x=np.array([1, 2, 1, 3, 2, 1]), v=np.arange(6.0))
                    .project(["cast(x as varchar) as sx", "v"])
                    .aggregation(["sx"], ["sum(v) as s", "count(*) as c"]).build(), "sx")
        assert out["sx"] == ["1", "2", "3"]
        assert out["s"] == [7.0, 5.0, 3.0]
        assert out["c"] == [3, 2, 1]

    def test_distinct_on_constructed(self):
        out = _both(lambda k: _scan(k, ["x"], ["BIGINT"], x=np.array([2, 2, 9, 2, 9]))
                    .project(["cast(x as varchar) as sx"]).aggregation(["sx"], []).build(), "sx")
        assert out["sx"] == ["2", "9"]

    def test_passthrough_join_output(self):
        def make(k):
            left = (_scan(k, ["k", "x"], ["BIGINT", "BIGINT"], k=np.array([1, 2, 3]),
                          x=np.array([10, 20, 30]))
                    .project(["k", "cast(x as varchar) as sx"]).build())
            right = _scan(k, ["k", "y"], ["BIGINT", "DOUBLE"], k=np.array([2, 3, 4]),
                          y=np.array([0.5, 1.5, 2.5])).build()
            return k.B(left).hash_join(right, ["k"], ["k"], output=["k", "sx", "y"]).build()

        assert _both(make, "k")["sx"] == ["20", "30"]


class TestGates:
    def test_order_by_int_cast(self):
        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], i=np.array([5, 10, 9]))
                    .project(["cast(i as varchar) as s"]).orderby(["s"]).build())
        assert out["s"] == ["10", "5", "9"]

    def test_filter_raises(self):
        # the string-function binding refuses it: a constructed column has
        # no dictionary to bind against
        for k in (PORT, REF):
            with pytest.raises((NotImplementedError, ValueError)):
                k.run(_scan(k, ["i"], ["BIGINT"], i=np.array([5]))
                      .project(["cast(i as varchar) as s"]).filter("length(s) > 1").build())

    def test_concat_over_construction(self):
        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], i=np.array([5]))
                    .project(["concat('v=', cast(i as varchar)) as s"]).build())
        assert out["s"] == ["v=5"]

    def test_min_aggregate_raises(self):
        for k in (PORT, REF):
            with pytest.raises((NotImplementedError, ValueError, TypeError)):
                k.run(_scan(k, ["i"], ["BIGINT"], i=np.array([5, 7]))
                      .project(["cast(i as varchar) as s"]).aggregation([], ["min(s) as m"]).build())

    def test_array_join_group_key_raises(self):
        def make(k):
            st = k.t.array(k.t.VARCHAR)
            seg, _ = k.Seg.from_pylist([["x"], ["y"]], st)
            t = k.Table(k.t.RowType(["a"], [st]), {"a": seg})
            return (k.B().table_scan(t).project(["array_join(a, ',') as j"])
                    .aggregation(["j"], []).build())

        for k in (PORT, REF):
            with pytest.raises(NotImplementedError, match="injective|grouping"):
                k.run(make(k))

    def test_join_against_a_scanned_string_raises(self):
        def make(k):
            st = k.Strings()
            left = (_scan(k, ["x"], ["BIGINT"], x=np.array([1, 2]))
                    .project(["cast(x as varchar) as sx"]).build())
            t = k.Table(k.t.RowType(["s"], [k.t.VARCHAR]), {"s": st.intern_all(["1", "3"])}, {"s": st})
            return k.B(left).hash_join(k.B().table_scan(t).build(), ["sx"], ["s"],
                                       output=["sx"]).build()

        for k in (PORT, REF):
            with pytest.raises(NotImplementedError, match="join key"):
                k.run(make(k))


def test_sql_cast_group():
    def make(k):
        t = k.Table(k.t.RowType(["x", "v"], [k.t.BIGINT, k.t.DOUBLE]),
                    {"x": np.array([1, 2, 1]), "v": np.array([1.0, 2.0, 4.0])})
        return k.plan_sql("select cast(x as varchar) as sx, sum(v) as s from t group by 1", {"t": t})

    from velox_tpu.sql.planner import plan_sql as ref_plan_sql
    from velox_tpu_torch.sql.planner import plan_sql

    PORT.plan_sql, REF.plan_sql = plan_sql, ref_plan_sql
    out = _both(make, "sx")
    assert out["sx"] == ["1", "2"] and out["s"] == [5.0, 2.0]


class TestChainedStringFunctions:
    def test_reverse_substr_over_cast(self):
        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], i=np.array([123, -45, 6])).project([
            "reverse(cast(i as varchar)) as r", "substr(cast(i as varchar), 1, 2) as s",
        ]).build())
        assert out["r"] == ["321", "54-", "6"]
        assert out["s"] == ["12", "-4", "6"]

    def test_upper_over_bool_cast_and_concat(self):
        out = _both(lambda k: _scan(k, ["b", "i"], ["BOOLEAN", "BIGINT"],
                                    b=np.array([True, False]), i=np.array([7, 8])).project([
            "upper(cast(b as varchar)) as u", "concat('id-', cast(i as varchar)) as c",
            "concat('[', cast(i as varchar), ']') as c2",
        ]).build())
        assert out["u"] == ["TRUE", "FALSE"]
        assert out["c"] == ["id-7", "id-8"]
        assert out["c2"] == ["[7]", "[8]"]

    def test_nested_chain(self):
        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], i=np.array([9876]))
                    .project(["substr(reverse(cast(i as varchar)), 2) as s"]).build())
        assert out["s"] == ["789"]

    @pytest.mark.parametrize("exprs", [
        ["lpad(cast(i as varchar), 6, '*') as x", "lpad(s, 6, '*') as y"],
        ["replace(cast(i as varchar), '0', 'O') as x", "replace(s, '0', 'O') as y"],
        ["rpad(cast(i as varchar), 5, '.') as x", "rpad(s, 5, '.') as y"],
    ])
    def test_chain_matches_plain_string_fn(self, exprs):
        vals = np.array([120, -3, 4567, 0])

        def make(k):
            st = k.Strings()
            t = k.Table(k.t.RowType(["i", "s"], [k.t.BIGINT, k.t.VARCHAR]),
                        {"i": vals, "s": st.intern_all([str(int(v)) for v in vals])}, {"s": st})
            return k.B().table_scan(t).project(exprs).build()

        out = _both(make)
        assert out["x"] == out["y"]

    def test_chain_null_propagates(self):
        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], validities={"i": np.array([True, False])},
                                    i=np.array([3, 99]))
                    .project(["upper(cast(i as varchar)) as s"]).build())
        assert out["s"] == ["3", None]

    def test_chained_grouping_key_raises(self):
        _raises_in_both(lambda k: _scan(k, ["i"], ["BIGINT"], i=np.array([1, 2, 1]))
                        .project(["substr(cast(i as varchar), 1, 1) as s"])
                        .aggregation(["s"], ["count(*) as c"]).build(), NotImplementedError)


class TestOrderByConstructedString:
    def test_order_by_cast_int_lexicographic(self):
        vals = np.array([5, 100, 21, 3, 1000000, 9, -7, -100, 0, 19])
        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], i=vals)
                    .project(["cast(i as varchar) as s", "i as i"]).orderby(["s"]).build())
        assert out["s"] == sorted(str(int(v)) for v in vals)

    def test_order_by_desc_and_topn(self):
        vals = np.array([12, 2, 120, 1200, 13, 3])
        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], i=vals)
                    .project(["cast(i as varchar) as s"]).topn(["s desc"], 3).build())
        assert out["s"] == sorted((str(int(v)) for v in vals), reverse=True)[:3]

    def test_order_by_bool(self):
        out = _both(lambda k: _scan(k, ["c", "b"], ["BIGINT", "BOOLEAN"],
                                    c=np.array([122, 97, 65]), b=np.array([True, False, True]))
                    .project(["chr(c) as s", "cast(b as varchar) as t"]).orderby(["s"]).build())
        assert out["s"] == ["A", "a", "z"] and out["t"] == ["true", "false", "true"]
        out = _both(lambda k: _scan(k, ["c", "b"], ["BIGINT", "BOOLEAN"],
                                    c=np.array([122, 97, 65]), b=np.array([True, False, True]))
                    .project(["c", "cast(b as varchar) as t"]).orderby(["t", "c"]).build())
        assert out["t"] == ["false", "true", "true"] and out["c"] == [97, 65, 122]

    def test_order_by_int64_extremes(self):
        vals = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 1, 0])
        out = _both(lambda k: _scan(k, ["i"], ["BIGINT"], i=vals)
                    .project(["cast(i as varchar) as s"]).orderby(["s"]).build())
        assert out["s"] == sorted(str(int(v)) for v in vals)

    def test_order_by_double_cast_still_gates(self):
        _raises_in_both(lambda k: _scan(k, ["d"], ["DOUBLE"], d=np.array([1.5, 2.5]))
                        .project(["cast(d as varchar) as s"]).orderby(["s"]).build(),
                        NotImplementedError)


def test_lex_words_match_reference():
    """The ``__strlex_w*`` words (bytes of the decimal rendering, packed
    big-endian) equal the JAX package's on integers of every length and
    sign, INT64_MIN and INT64_MAX included."""
    import jax.numpy as jnp
    import torch

    from velox_tpu.exec.strcast import _register_lex_functions as ref_register
    from velox_tpu.expr.registry import DEFAULT_REGISTRY as REF_REG
    from velox_tpu_torch.exec.strcast import _register_lex_functions
    from velox_tpu_torch.expr.registry import DEFAULT_REGISTRY as REG

    rng = np.random.default_rng(3)
    vals = np.concatenate([
        np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1, 9, 10, -10]),
        rng.integers(-10**18, 10**18, 64), rng.integers(-999, 999, 64),
    ]).astype(np.int64)
    _register_lex_functions()
    ref_register()
    for w in range(3):
        name = f"__strlex_w{w}"
        sig, _, _ = REG.resolve(name, [PORT.t.BIGINT])
        ref_sig, _, _ = REF_REG.resolve(name, [REF.t.BIGINT])
        got = sig.impl(None, PORT.t.BIGINT, [PORT.t.BIGINT], torch.as_tensor(vals))
        want = ref_sig.impl(None, REF.t.BIGINT, [REF.t.BIGINT], jnp.asarray(vals))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
