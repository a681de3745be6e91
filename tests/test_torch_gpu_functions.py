"""The function slice on the card against the same calls on the CPU: the
Presto scalar functions, every new aggregate in direct mode, sort mode and
the host merge, the int128 device functions, windows over NULL keys, and
the slice's TPC-H texts (``chip_smoke.py`` ``FUNCTION_SQL``) at SF 0.01
against their numpy oracles.  The CPU tests hold the same code against the
JAX package; what only a CUDA device shows is that every call exists there
and gives the same rows.  Skipped where there is no CUDA device; run with
``python -m pytest tests/test_torch_gpu_functions.py -m gpu``.

Integers, decimals, dates and strings exact; DOUBLE rtol 1e-9 (an absolute
1e-15 beside it for results that are zero in exact arithmetic)."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from velox_tpu_torch.config import QueryConfig
from velox_tpu_torch.connectors.tpch import load_table
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.expr.registry import DEFAULT_REGISTRY
from velox_tpu_torch.ops import int128
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.sql import run_sql
from velox_tpu_torch.testing import assert_same_rows, table_from_numpy

pytestmark = pytest.mark.gpu

N = 3000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _table():
    rng = np.random.default_rng(6)
    words = ["", "hello world", "caresses", "relational", "kitten", "abcabc", "Ω", "  pad  "]
    x = rng.normal(0, 30, N)
    x[:6] = [0.5, -0.5, 2.5, -2.5, 0.0, -0.0]
    cols = {
        "x": x, "p": rng.uniform(0.01, 0.99, N), "n": rng.integers(-40, 40, N),
        "g": rng.integers(0, 700, N), "k": rng.integers(0, 6, N),
        "dec": rng.integers(-100000, 100000, N), "d": rng.integers(-800, 12000, N).astype(np.int32),
        "ts": rng.integers(-(10**15), 2 * 10**15, N), "s": rng.integers(1, len(words), N).astype(np.int32),
    }
    types = ["DOUBLE", "DOUBLE", "BIGINT", "BIGINT", "BIGINT", "DECIMAL(12, 2)", "DATE", "TIMESTAMP", "VARCHAR"]
    return table_from_numpy(list(cols), types, cols, {"s": words}, {"n": rng.random(N) < 0.8})


def _both(plan_of, cuda, tile_rows=1 << 10, **kw):
    t = _table()
    got = LocalExecutor(plan_of(t), tile_rows=tile_rows, device=cuda, **kw).run()
    want = LocalExecutor(plan_of(t), tile_rows=tile_rows, device="cpu", **kw).run()
    assert_same_rows(got, want, atol=1e-15)
    return got


EXPRESSIONS = [
    "round(x)", "round(x, 1)", "round(dec)", "floor(dec)", "ceil(x)", "truncate(x, 1)",
    "cbrt(x)", "exp(x / 100)", "ln(abs(x) + 1)", "atan2(x, p)", "power(abs(x), 1.5e0)",
    "nullif(n, 0)", "greatest(n, 2, g)", "least(x, p)", "is_distinct_from(n, g)",
    "normal_cdf(0.0e0, 1.0e0, x / 30)", "inverse_normal_cdf(0.0e0, 1.0e0, p)",
    "beta_cdf(2.5e0, 3.5e0, p)", "binomial_cdf(20.0e0, p, abs(n) + 3)",
    "chi_squared_cdf(3.0e0, abs(x))", "poisson_cdf(2.5e0, abs(n))",
    "width_bucket(x, -60.0e0, 60.0e0, 12)", "year(d)", "week(d)", "day_of_week(d)",
    "date_trunc('quarter', d)", "date_diff('month', d, date '1997-05-19')",
    "date_add('month', n, d)", "last_day_of_month(d)", "hour(ts)", "date_trunc('hour', ts)",
    "bitwise_right_shift(g, 3)", "bitwise_left_shift(n, 62)", "bit_count(n * 1234567891011)",
    "pi()", "md5(s)", "word_stem(s)", "levenshtein_distance(s, 'sitting')", "lpad(s, 9, '*')",
    "regexp_replace(s, '[aeiou]', '_')", "at_timezone(ts, 'America/New_York')",
    "timezone_minute(ts, '-03:30')",
]


def test_scalar_functions_match_the_cpu(cuda):
    _both(lambda t: PlanBuilder().table_scan(t).project(
        [f"{e} as c{i}" for i, e in enumerate(EXPRESSIONS)]).build(), cuda)


AGGREGATES = [
    "count_if(x > 0) as ci", "bool_and(p > 0.1) as ba", "bool_or(x > 80) as bo",
    "min_by(n, x) as mb", "max_by(g, p) as xb", "var_samp(x) as vs", "stddev_pop(dec) as sd",
    "skewness(x) as sk", "kurtosis(p) as ku", "covar_samp(x, p) as cs", "corr(x, g) as co",
    "geometric_mean(p) as gm", "bitwise_and_agg(g * 8 + 5) as ba8", "bitwise_or_agg(n) as bo8",
    "checksum(g) as ck", "arbitrary(dec) as ar",
]


@pytest.mark.parametrize("keys,host_merge", [((), False), (("k",), False), (("g",), False), (("g",), True)])
def test_aggregates_match_the_cpu(cuda, keys, host_merge):
    kw = {"config": QueryConfig(device_agg_merge=False)} if host_merge else {}

    def plan(t):
        pb = (PlanBuilder().table_scan(t)
              .project(["x", "p", "n", "g", "k", "dec", "x > 0 as xp", "p > 0.1 as p1", "x > 80 as x8",
                        "g * 8 + 5 as g8"])
              .aggregation(list(keys), [a.replace("x > 0", "xp").replace("p > 0.1", "p1")
                                        .replace("x > 80", "x8").replace("g * 8 + 5", "g8")
                                        for a in AGGREGATES]))
        return (pb.orderby(list(keys)) if keys else pb).build()

    _both(plan, cuda, tile_rows=512, **kw)


def test_int128_functions_match_numpy(cuda):
    int128.register_i128_functions()
    rng = np.random.default_rng(3)
    a = [int(rng.integers(-(10**15), 10**15)) * int(rng.integers(1, 10**15)) for _ in range(500)]
    b = [int(rng.integers(-(10**6), 10**6)) * int(rng.integers(1, 10**6)) or 7 for _ in range(500)]
    ah, al = int128.np_from_int(a)
    bh, bl = int128.np_from_int(b)

    def dev(name, *args):
        sig = DEFAULT_REGISTRY.signatures(name)[0]
        out = sig.impl(None, None, None, *[torch.as_tensor(x, device=cuda) for x in args])
        return tuple(o.cpu().numpy() for o in out) if isinstance(out, tuple) else out.cpu().numpy()

    np.testing.assert_array_equal(dev("__i128_add_hi", ah, al, bh, bl), int128.np_add(ah, al, bh, bl)[0])
    x, y = np.asarray(a, dtype=object), np.asarray(b, dtype=object)
    lo64 = np.array([int(v) & ((1 << 62) - 1) for v in x], np.int64)
    eh, el = int128.np_mul_i64(lo64, bl)
    np.testing.assert_array_equal(dev("__i128_mul64_hi", lo64, bl), eh)
    np.testing.assert_array_equal(dev("__i128_mul64_lo", lo64, bl), el)
    qh = dev("__i128_div_hi", ah, al, bh, bl)
    ql, err = dev("__i128_div_lo", ah, al, bh, bl)
    assert int128.np_to_int(qh, ql) == int128.np_div_round(list(x), list(y)) and not err.any()


def test_window_null_keys_match_the_cpu(cuda):
    def plan(t):
        from velox_tpu_torch.sql import plan_sql

        return plan_sql(
            "select g, row_number() over (partition by nk order by nn nulls first, g) as a,"
            " rank() over (order by nn desc) as b"
            " from (select g, nullif(k, 0) as nk, nullif(n, 3) as nn from t) u", {"t": t})

    _both(plan, cuda, tile_rows=1 << 10)
    _both(plan, cuda, tile_rows=1 << 12)


@pytest.mark.parametrize("name", list(cs.FUNCTION_SQL))
def test_function_texts_hold_to_their_oracles(cuda, name):
    tables = {t: load_table(t, 0.01, list(c)) for t, c in cs.FUNCTION_COLUMNS[name].items()}
    got = run_sql(cs.FUNCTION_SQL[name], tables, tile_rows=1 << 12, device=cuda)
    cs.check_window_rows(got, *cs.function_oracle(name, tables))
