"""The Presto scalar-function library of the port against the JAX package's:
the cases of ``tests/test_expr.py``, ``test_functions_extended.py`` and
``test_function_tail.py`` that are Presto scalars (the array / map / lambda
cases are in their own files, the Spark ones in
``test_torch_spark_functions.py``), each projected by both packages over
the same seeded rows, in several tiles.

Integers, decimals, dates, booleans and strings agree exactly, DOUBLE to
rtol 1e-9, with an absolute floor of ``ATOL`` = 1e-15 for results that are
zero in exact arithmetic (a Wilson bound at 0 successes is a difference of
two equal terms, and each framework rounds them its own way).  Where the port differs on purpose the test asserts both sides,
named: subnormal results (the port keeps IEEE, XLA on the CPU flushes them
to zero).  The registry test holds the port's registered names and
overloads to the reference's, every one of them."""

import hashlib
import math

import numpy as np
import pytest

import velox_tpu as vt
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.expr.registry import DEFAULT_REGISTRY as REF_REGISTRY
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor
from velox_tpu_torch.expr.registry import DEFAULT_REGISTRY as PORT_REGISTRY
from velox_tpu_torch.plan import PlanBuilder as PortBuilder
from velox_tpu_torch.testing import assert_same_rows, table_from_numpy

N = 240
TILE = 64
ATOL = 1e-15
_RNG = np.random.default_rng(2024)

_WORDS = [
    "", "hello world", "foo bar", "hello tpu", "caresses", "relational", "hopefulness",
    "sky", "motoring", "kitten", "flaw", "éclair", "abcabc", "  padded  ", "Ω",
]
_WORDS2 = ["", "world", "oo", "x", "sitting", "abc", "hello"]
_JSON = ["", '{"a": {"b": 7}, "xs": [1,2,3]}', '{"a": {"b": "hi"}}', "not json", '{"a": [1, 2, 3], "b": {"c": 5}}']
_URLS = [
    "", "https://example.com:8443/a/b?x=1&y=two#frag", "http://host/p?x=%20hi",
    "not a url", "http://foo.io/",
]


def _columns():
    rng = _RNG
    x = rng.normal(0, 30, N)
    x[:8] = [0.5, -0.5, 1.5, -2.5, 2.5, 0.0, 100.0, -0.0]  # rounding ties
    cols = {
        "x": (x, "DOUBLE"),
        "p": (rng.uniform(0.01, 0.99, N), "DOUBLE"),
        "n": (rng.integers(-40, 40, N), "BIGINT"),
        "nn": (rng.integers(-5, 5, N), "BIGINT"),
        "m": (rng.integers(1, 12, N), "BIGINT"),
        "dec": (rng.integers(-100000, 100000, N), "DECIMAL(12, 2)"),
        "d": (rng.integers(-800, 12000, N).astype(np.int32), "DATE"),
        "d2": (rng.integers(8000, 10600, N).astype(np.int32), "DATE"),
        "ts": (rng.integers(-(10**15), 2 * 10**15, N), "TIMESTAMP"),
        "ts2": (rng.integers(0, 2 * 10**15, N), "TIMESTAMP"),
        "s": (rng.integers(1, len(_WORDS), N).astype(np.int32), "VARCHAR"),
        "s2": (rng.integers(1, len(_WORDS2), N).astype(np.int32), "VARCHAR"),
        "j": (rng.integers(1, len(_JSON), N).astype(np.int32), "VARCHAR"),
        "u": (rng.integers(1, len(_URLS), N).astype(np.int32), "VARCHAR"),
    }
    return cols, {"nn": rng.random(N) < 0.75}


_STRINGS = {"s": _WORDS, "s2": _WORDS2, "j": _JSON, "u": _URLS}


def _ref_type(text):
    if text.startswith("DECIMAL"):
        return vt.decimal(12, 2)
    return getattr(vt, text)


def _tables():
    cols, validities = _columns()
    names = list(cols)
    data = {n: np.asarray(c[0]) for n, c in cols.items()}
    port = table_from_numpy(names, [c[1] for c in cols.values()], data, _STRINGS, validities)
    ref = RefTable(
        vt.RowType(names, [_ref_type(c[1]) for c in cols.values()]), dict(data),
        {n: vt.StringTable.from_values(v) for n, v in _STRINGS.items()}, dict(validities),
    )
    return ref, port


_TABLES = []


def _both_tables():
    if not _TABLES:
        _TABLES.extend(_tables())
    return _TABLES


def _project_both(exprs):
    ref_t, port_t = _both_tables()
    named = [f"{e} as c{i}" for i, e in enumerate(exprs)]
    got = PortExecutor(PortBuilder().table_scan(port_t).project(named).build(), tile_rows=TILE, device="cpu").run()
    want = RefExecutor(RefBuilder().table_scan(ref_t).project(named).build(), tile_rows=TILE).run()
    return got, want


# one projection a case (test_expr.py, test_functions_extended.py,
# test_function_tail.py and the rest of the registry)
CASES = {
    "arithmetic": [
        "n + 3", "n * n - nn", "n / 3", "n % 3", "-n", "abs(n)", "abs(x)", "x / 3.0e0",
        "dec * 2", "dec + 1.25", "dec / 3.00", "try(n / nn)", "try(100 % nn)", "mod(x, 7.0e0)",
        "negate(dec)", "date_add_days(d, n)",
    ],
    "comparisons_and_nulls": [
        "n between -3 and 3", "x > p", "d < d2", "ts >= ts2", "s = 'sky'", "s <> 'flaw'",
        "nn is null", "nn is not null", "not (n > 0)", "nullif(n, 0)", "nullif(nn, 3)",
        "is_distinct_from(nn, n)", "is_distinct_from(nn, nn)",
    ],
    "rounding": [
        "round(x)", "round(x, 1)", "round(x, -1)", "round(n)", "round(n, -1)", "round(dec)",
        "floor(x)", "ceil(x)", "ceiling(x)", "floor(dec)", "ceil(dec)", "floor(n)",
        "truncate(x)", "truncate(x, 1)",
    ],
    "math": [
        "sqrt(abs(x))", "cbrt(x)", "exp(x / 100)", "ln(abs(x) + 1)", "log2(abs(x) + 1)",
        "log10(abs(x) + 1)", "sin(x)", "cos(x)", "tan(x)", "asin(p)", "acos(p)", "atan(x)",
        "sinh(x / 100)", "cosh(x / 100)", "tanh(x)", "asinh(x)", "acosh(abs(x) + 1)",
        "atanh(p * 0.9)", "sign(x)", "sign(n)", "sign(dec)", "power(abs(x), 1.5e0)",
        "pow(x, 2.0e0)", "atan2(x, p)", "degrees(x)", "radians(x)", "is_nan(x / x)",
        "is_finite(1.0e0 / x)", "is_infinite(1.0e0 / x)", "e()", "pi()", "infinity()", "nan()",
    ],
    "conditionals": [
        "greatest(n, 2, nn)", "least(x, p)", "greatest(dec, 1.5)", "least(n, m)",
        "greatest(x, n)", "coalesce(nn, n)", "if(n > 0, x, p)",
        "case when n < 0 then 'neg' when n = 0 then 'zero' else s end",
    ],
    "probability": [
        "normal_cdf(0.0e0, 1.0e0, x / 30)", "inverse_normal_cdf(0.0e0, 1.0e0, p)",
        "beta_cdf(2.5e0, 3.5e0, p)", "beta_cdf(1.0e0, 1.0e0, p)", "beta_cdf(40.0e0, 7.5e0, p)",
        "binomial_cdf(20.0e0, p, abs(nn) + 3)", "binomial_cdf(10.0e0, 0.3e0, m)",
        "cauchy_cdf(0.0e0, 1.0e0, x)", "chi_squared_cdf(3.0e0, abs(x))", "poisson_cdf(2.5e0, abs(n))",
        "wilson_interval_lower(abs(n), 50.0e0, 1.96e0)", "wilson_interval_upper(abs(n), 50.0e0, 1.96e0)",
        "width_bucket(x, -60.0e0, 60.0e0, 12)", "width_bucket(dec, -500.00, 500.00, 7)",
    ],
    "date_parts": [
        "year(d)", "quarter(d)", "month(d)", "day(d)", "day_of_month(d)", "day_of_week(d)", "dow(d)",
        "day_of_year(d)", "doy(d)", "week(d)", "week_of_year(d)", "year_of_week(d)", "yow(d)",
        "last_day_of_month(d)",
    ],
    "date_arithmetic": [
        "date_trunc('year', d)", "date_trunc('quarter', d)", "date_trunc('month', d)",
        "date_trunc('week', d)", "date_trunc('day', d)", "date_diff('day', d, d2)",
        "date_diff('week', d, d2)", "date_diff('month', d, d2)", "date_diff('quarter', d, d2)",
        "date_diff('year', d, date '1997-05-19')", "date_add('day', n, d)", "date_add('week', n, d)",
        "date_add('month', n, d)", "date_add('quarter', nn, d)", "date_add('year', 1, d)",
        "d - interval '90' day",
    ],
    "timestamps": [
        "hour(ts)", "minute(ts)", "second(ts)", "millisecond(ts)", "to_unixtime(ts)",
        "from_unixtime(n)", "from_unixtime(x)", "year(ts)", "month(ts)", "day_of_week(ts)",
        "week(ts)", "date_trunc('second', ts)", "date_trunc('minute', ts)",
        "date_trunc('hour', ts)", "date_trunc('day', ts)", "date_add('second', n, ts)",
        "date_add('minute', n, ts)", "date_add('hour', n, ts)", "date_add('day', n, ts)",
        "date_diff('second', ts, ts2)", "date_diff('minute', ts, ts2)",
        "date_diff('hour', ts, ts2)", "date_diff('day', ts, ts2)",
    ],
    "bitwise": [
        "bitwise_and(n, 6)", "bitwise_or(n, 8)", "bitwise_xor(n, 1)", "bitwise_not(n)",
        "bitwise_left_shift(n, 2)", "bitwise_right_shift(n, 3)", "bitwise_right_shift(n, 0)",
        "bitwise_arithmetic_shift_right(n, 3)", "bit_count(n)", "bit_count(n * 1234567891011)",
        "bitwise_left_shift(n, m * 6)", "bitwise_right_shift(n, m * 6)",
        "bitwise_arithmetic_shift_right(n, m * 6)",
    ],
    "strings": [
        "concat(s, '!')", "concat(s, s2)", "concat(s, '-', 'post')", "strpos(s, 'o')",
        "strpos(s, s2)", "strrpos(s, 'bc')", "starts_with(s, 'hello')", "ends_with(s, 'bar')",
        "replace(s, 'hello', 'hi')", "replace(s, 'l')", "split_part(s, ' ', 1)",
        "split_part(s, ' ', 2)", "lpad(s, 13, '*')", "rpad(s, 4)", "rpad(s, 12, '-=')",
        "regexp_like(s, 'w.rld')", "regexp_extract(s, '([a-z]+)$')",
        "regexp_extract(s, '(h)(e)', 2)", "regexp_replace(s, '[aeiou]', '_')",
        "regexp_replace(s, '[aeiou]')", "codepoint(s)", "length(s)", "lower(s)", "upper(s)",
        "trim(s)", "ltrim(s)", "rtrim(s)", "reverse(s)", "substr(s, 2)", "substr(s, 2, 3)",
        "concat_ws('-', s, 'tail')", "s like 'h%'",
    ],
    "string_distances_and_stems": [
        "levenshtein_distance(s, 'sitting')", "levenshtein_distance(s, s2)",
        "hamming_distance(s, 'abc')", "hamming_distance(s, s2)", "word_stem(s)",
        "word_stem(s, 'en')", "normalize(s)", "normalize(s, 'NFD')",
    ],
    "digests_and_codecs": [
        "md5(s)", "sha1(s)", "sha256(s)", "sha512(s)", "to_hex(s)", "from_hex(to_hex(s))",
        "to_base64(s)", "from_base64(to_base64(s))", "to_base64url(s)",
        "from_base64url(to_base64url(s))", "to_utf8(s)", "from_utf8(s)", "char2hexint(s)",
    ],
    "json_and_url": [
        "json_extract_scalar(j, '$.a.b')", "json_extract(j, '$.xs')",
        "json_array_length(json_extract(j, '$.xs'))", "json_size(j, '$.a')", "json_parse(j)",
        "json_format(j)", "url_extract_host(u)", "url_extract_path(u)", "url_extract_protocol(u)",
        "url_extract_query(u)", "url_extract_fragment(u)", "url_extract_port(u)",
        "url_extract_parameter(u, 'y')", "url_decode(url_encode(u))", "url_encode(u)",
    ],
}


@pytest.mark.parametrize("case", list(CASES))
def test_functions_match_reference(case):
    got, want = _project_both(CASES[case])
    assert_same_rows(got, want, atol=ATOL)


def test_oracle_values():
    """A few cases of the reference's tests against their own oracles: the
    port's values, not only its agreement."""
    ref_t, port_t = _both_tables()
    exprs = ["md5(s)", "round(x)", "word_stem(s)", "levenshtein_distance(s, 'sitting')", "week(d)"]
    got = PortExecutor(
        PortBuilder().table_scan(port_t).project([f"{e} as c{i}" for i, e in enumerate(exprs)]).build(),
        tile_rows=TILE, device="cpu",
    ).run()
    words = [_WORDS[c] for c in np.asarray(port_t.columns["s"])]
    md5 = got.string_tables["c0"].decode(np.asarray(got.columns["c0"]))
    assert list(md5) == [hashlib.md5(w.encode()).hexdigest() for w in words]
    x = np.asarray(port_t.columns["x"])
    want_round = [math.copysign(math.floor(abs(v) + 0.5), v) for v in x]
    np.testing.assert_array_equal(np.asarray(got.columns["c1"]), want_round)
    assert list(np.asarray(got.columns["c1"])[:5]) == [1.0, -1.0, 2.0, -3.0, 3.0]  # half away from zero
    stems = dict(zip(["caresses", "relational", "hopefulness", "sky", "motoring"],
                     ["caress", "relat", "hope", "sky", "motor"]))
    got_stems = got.string_tables["c2"].decode(np.asarray(got.columns["c2"]))
    for w, st in zip(words, got_stems):
        if w in stems:
            assert st == stems[w]
    lev = dict(zip(words, np.asarray(got.columns["c3"])))
    assert lev.get("kitten", 3) == 3 and lev.get("flaw", 7) == 7
    import datetime as dt

    days = np.asarray(port_t.columns["d"])
    weeks = [(dt.date(1970, 1, 1) + dt.timedelta(days=int(v))).isocalendar()[1] for v in days]
    np.testing.assert_array_equal(np.asarray(got.columns["c4"]), weeks)


def test_betainc_against_closed_forms():
    """I_x(a, b) in torch against closed forms: I_x(1, 1) = x,
    I_x(a, 1) = x^a, I_x(1, b) = 1 - (1 - x)^b, and the binomial sum."""
    import torch

    from velox_tpu_torch.functions.presto.scalar import _betainc

    x = torch.linspace(0.0, 1.0, 101, dtype=torch.float64)
    ones = torch.ones_like(x)
    np.testing.assert_allclose(_betainc(ones, ones, x).numpy(), x.numpy(), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(_betainc(3.5 * ones, ones, x).numpy(), (x**3.5).numpy(), rtol=1e-11, atol=1e-15)
    np.testing.assert_allclose(
        _betainc(ones, 4.25 * ones, x).numpy(), (1 - (1 - x) ** 4.25).numpy(), rtol=1e-11, atol=1e-15
    )
    # P(K <= k) for K ~ Binomial(n, p) = I_{1-p}(n - k, k + 1)
    n, p = 30, 0.37
    for k in (0, 5, 11, 29):
        want = sum(math.comb(n, i) * p**i * (1 - p) ** (n - i) for i in range(k + 1))
        args = (float(n - k), k + 1.0, 1 - p)
        got = float(_betainc(*(torch.tensor(v, dtype=torch.float64) for v in args)))
        assert abs(got - want) <= 1e-12 + 1e-10 * want
    bad = (torch.tensor(v, dtype=torch.float64) for v in (-1.0, 1.0, 0.5))
    assert torch.isnan(_betainc(*bad))


def test_subnormal_results_keep_ieee():
    """exp(-740) and 2^-1070 are subnormal doubles.  The port keeps them
    (IEEE); the JAX package on the CPU flushes them to zero (XLA's
    flush-to-zero): its value here is known to differ, and is asserted so."""
    t = table_from_numpy(["x"], ["DOUBLE"], {"x": np.array([-740.0, -1070.0 * math.log(2), 1.0])})
    ref_t = RefTable(vt.RowType(["x"], [vt.DOUBLE]), {"x": np.array([-740.0, -1070.0 * math.log(2), 1.0])})
    exprs = ["exp(x) as e"]
    got = PortExecutor(PortBuilder().table_scan(t).project(exprs).build(), device="cpu").run()
    want = RefExecutor(RefBuilder().table_scan(ref_t).project(exprs).build()).run()
    port_e = np.asarray(got.columns["e"])
    ref_e = np.asarray(want.columns["e"])
    np.testing.assert_allclose(port_e, np.exp([-740.0, -1070.0 * math.log(2), 1.0]), rtol=1e-9)
    assert 0 < port_e[0] < np.finfo(np.float64).tiny and 0 < port_e[1] < np.finfo(np.float64).tiny
    # the reference's flushed values (XLA on the CPU), named as known to differ
    assert ref_e[0] == 0.0 and ref_e[1] == 0.0
    np.testing.assert_allclose(port_e[2], ref_e[2], rtol=1e-9)


def test_string_literal_case_raises_in_both_packages():
    """An inherited gap: a CASE whose branches are only string literals has
    no sibling string column to bind its literals against, and raises in
    both packages."""
    ref_t, port_t = _both_tables()
    text = ["case when n > 0 then 'pos' else 'neg' end as c"]
    with pytest.raises(ValueError, match="no sibling string column"):
        PortBuilder().table_scan(port_t).project(text).build()
    with pytest.raises(ValueError, match="no sibling string column"):
        RefBuilder().table_scan(ref_t).project(text).build()


# every name of the JAX package's registry is registered in the port: the
# Spark package (functions/spark/, ROADMAP Queue 1 item 6) and the sketch
# rewrite's device functions (exec/sketch.py) came last; nothing is left
LATER = {}

# registered into each package's registry by its sketch rewrite
# (``exec/sketch.py _register_hll_functions``) the first time a plan uses
# approx_distinct or the DDSketch approx_percentile
SKETCH_FNS = {"hll_bucket64", "hll_rho64", "dd_bucket64"}
SKETCH = set()


def _public(registry):
    # zone-specialised functions (``__tz_...``) are registered on use
    return {n for n in registry._functions if not n.startswith("__")}


def test_registered_names_match_reference():
    """The port registers every name of the JAX package's registry
    (``LATER`` and ``SKETCH`` are empty), each with the same overloads: the
    Spark package's names (``functions/spark/scalar.py``) with their
    signatures, ``date_add`` and ``from_unixtime`` with their Presto and
    Spark overloads side by side, the names of the array / map / lambda
    functions (``functions/presto/complex.py``) all registered, ``concat``
    and ``reverse`` with their ARRAY overloads beside the string ones."""
    from velox_tpu.exec.sketch import _register_hll_functions
    from velox_tpu_torch.exec.sketch import _register_hll_functions as port_register

    _register_hll_functions()  # as after any earlier sketch plan in this process
    port_register()
    assert SKETCH_FNS <= _public(REF_REGISTRY) and SKETCH_FNS <= _public(PORT_REGISTRY)
    assert not LATER and not SKETCH
    assert _public(PORT_REGISTRY) == _public(REF_REGISTRY)
    spark_names = {
        n for n, sigs in REF_REGISTRY._functions.items()
        if all(sig.impl.__module__.endswith("spark.scalar") for sig in sigs)
    }
    assert len(spark_names) == 61
    assert spark_names == {
        n for n, sigs in PORT_REGISTRY._functions.items()
        if all(sig.impl.__module__.endswith("spark.scalar") for sig in sigs)
    }
    complex_names = {
        n for n, sigs in REF_REGISTRY._functions.items()
        if any(sig.impl.__module__.endswith("presto.complex") for sig in sigs)
    }
    assert len(complex_names) == 47 and complex_names <= _public(PORT_REGISTRY)
    for name in _public(REF_REGISTRY):
        ref_kinds = sorted(str(sig.arg_matchers) for sig in REF_REGISTRY._functions[name])
        port_kinds = sorted(str(sig.arg_matchers) for sig in PORT_REGISTRY._functions[name])
        assert port_kinds == ref_kinds, name
