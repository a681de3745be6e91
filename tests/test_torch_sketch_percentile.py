"""approx_percentile of the port (``exec/sketch.py``: the KLL rewrite over
the window barrier, ``QueryConfig(percentile_sketch="ddsketch")``'s log
buckets, the accuracy form) against the JAX package's: the ungrouped
percentile cases of ``tests/test_sketch.py`` on the same numpy-seeded rows
(the grouped, weighted, mixed and multi-call ones are in
``test_torch_sketch_percentile_grouped.py``), the JAX package's rows
computed once for the module.

The two packages agree exactly (DOUBLE to rtol 1e-9); each case also keeps
the reference test's bound: rank error 2/m for KLL, 0.5 % value error for
DDSketch.  Row counts are a quarter of the reference test's where it took
over a few seconds.
"""

import numpy as np
import pytest

from test_torch_sketch import REF, Cases, agg_plan

CASES = Cases()
case = CASES.case


def lognormal_ints(p, n):
    rng = np.random.default_rng(int(p * 100))
    return (rng.lognormal(8, 2, n)).astype(np.int64) + 1


for _p in (0.1, 0.5, 0.99):
    case(f"rank_{_p}")(lambda k, p=_p: agg_plan(
        k, {"v": lognormal_ints(p, 50_000)}, [], [f"approx_percentile(v, {p}) as q"]))
    case(f"dd_{_p}", runs=((1 << 20, {"percentile_sketch": "ddsketch"}),))(
        lambda k, p=_p: agg_plan(k, {"v": lognormal_ints(p, 50_000)}, [],
                                 [f"approx_percentile(v, {p}) as q"]))


def _dense():
    return {"v": np.random.default_rng(5).uniform(1.0, 1.004, 50_000)}


for _p in (0.25, 0.75):
    case(f"dense_{_p}")(lambda k, p=_p: agg_plan(
        k, _dense(), [], [f"approx_percentile(v, {p}) as q"], types={"v": "DOUBLE"}))


def _accuracy():
    return {"v": np.random.default_rng(17).integers(0, 1 << 40, 100_000).astype(np.int64)}


case("accuracy")(lambda k: agg_plan(k, _accuracy(), [],
                                    ["approx_percentile(v, 0.5, 0.001) as q"]))



@pytest.fixture(scope="module")
def ref_rows():
    """Every case through the JAX package once."""
    return {name: CASES.rows(REF, name) for name in CASES}


def port_rows(name, ref_rows):
    return CASES.port(name, ref_rows)


def assert_rank_error(values, est, p, m=256, slack=2):
    """The estimate's empirical rank must be within 2/m (+slack rows) of the
    target rank — the kll sketch's bound."""
    sv = np.sort(np.asarray(values, dtype=np.float64))
    n = len(sv)
    target = np.floor(p * n)
    lo = np.searchsorted(sv, est, "left")
    hi = np.searchsorted(sv, est, "right") - 1
    dist = max(lo - target, target - hi, 0)
    assert dist <= 2.0 / m * n + slack, (est, p, n, lo, hi, target)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.99])
def test_percentile_rank_error(p, ref_rows):
    [got] = port_rows(f"rank_{p}", ref_rows)
    assert_rank_error(lognormal_ints(p, 50_000), got["q"][0], p)


def test_percentile_rank_error_dense_range(ref_rows):
    for p in (0.25, 0.75):
        [got] = port_rows(f"dense_{p}", ref_rows)
        assert_rank_error(_dense()["v"], got["q"][0], p)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.99])
def test_percentile_ddsketch_value_error(p, ref_rows):
    [got] = port_rows(f"dd_{p}", ref_rows)
    v = lognormal_ints(p, 50_000)
    exact = np.sort(v)[int(np.floor(p * len(v)))]
    assert abs(got["q"][0] - exact) <= 0.011 * exact + 1, (got, exact)


def test_percentile_accuracy_argument(ref_rows):
    [got] = port_rows("accuracy", ref_rows)
    assert_rank_error(_accuracy()["v"], got["q"][0], 0.5, m=2000)
