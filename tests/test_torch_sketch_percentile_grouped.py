"""approx_percentile of the port against the JAX package's: the grouped,
weighted, mixed-node, multi-call, DOUBLE and tile-invariance cases of
``tests/test_sketch.py`` on the same numpy-seeded rows (the ungrouped ones
are in ``test_torch_sketch_percentile.py``), the JAX package's rows computed
once for the module.  The two packages agree exactly (DOUBLE to rtol 1e-9);
each case also keeps the reference test's bound.  The tile-invariance case
runs the JAX package at the first tile size only; the port runs both and
must agree with itself and with it.
"""

import numpy as np
import pandas as pd
import pytest

from test_torch_sketch import REF, Cases, agg_plan
from test_torch_sketch_percentile import assert_rank_error

CASES = Cases()
case = CASES.case


def _negatives():
    rng = np.random.default_rng(3)
    g = rng.integers(0, 8, 50_000)
    return {"g": g.astype(np.int64), "v": rng.normal(0, 10_000, 50_000).astype(np.int64)}


case("negatives")(lambda k: agg_plan(k, _negatives(), ["g"],
                                     ["approx_percentile(v, 0.5) as q"]))


def _tile_inv():
    return {"v": np.random.default_rng(9).integers(1, 10**9, 60_000).astype(np.int64)}


case("pct_tile_sizes", runs=((1 << 11, {}), (1 << 17, {})))(
    lambda k: agg_plan(k, _tile_inv(), [], ["approx_percentile(v, 0.9) as q"]))
case("pct_double")(lambda k: agg_plan(
    k, {"v": np.random.default_rng(11).lognormal(0, 3, 50_000)}, [],
    ["approx_percentile(v, 0.5) as q"], types={"v": "DOUBLE"}))


def _multi():
    return {"v": np.random.default_rng(13).integers(1, 1000, 5_000).astype(np.int64)}


case("pct_multi")(lambda k: agg_plan(
    k, _multi(), [], ["approx_percentile(v, 0.5) as p50", "approx_percentile(v, 0.9) as p90"]))


def _mixed_pct():
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 50_000).astype(np.int64)
    return {"g": g, "v": rng.lognormal(3.0, 1.0, 50_000), "p": np.full(50_000, 0.5)}


case("mixed_percentile")(lambda k: agg_plan(
    k, _mixed_pct(), ["g"], ["count(*) as c", "approx_percentile(v, p) as med"],
    types={"v": "DOUBLE", "p": "DOUBLE"}))


def _weighted():
    rng = np.random.default_rng(11)
    return {"g": rng.integers(0, 3, 500).astype(np.int64), "x": rng.uniform(1, 1000, 500),
            "w": rng.integers(1, 10, 500).astype(np.int64)}


case("weighted")(lambda k: agg_plan(k, _weighted(), ["g"],
                                    ["approx_percentile(x, w, 0.5) as q"], types={"x": "DOUBLE"}))


@pytest.fixture(scope="module")
def ref_rows():
    """Every case through the JAX package once (the tile-invariance case at
    its first tile size)."""
    return {name: Cases({name: (fn, runs[:1])}).rows(REF, name)
            for name, (fn, runs) in CASES.items()}


def port_rows(name, ref_rows):
    return CASES.port(name, ref_rows)


def test_percentile_grouped_with_negatives(ref_rows):
    [got] = port_rows("negatives", ref_rows)
    cols = _negatives()
    for gid, est in zip(got["g"], got["q"]):
        assert_rank_error(cols["v"][cols["g"] == gid], est, 0.5)


def test_percentile_tile_invariance(ref_rows):
    a, b = CASES.port("pct_tile_sizes", ref_rows, ref_runs=1)
    assert a == b


def test_percentile_double_values(ref_rows):
    [got] = port_rows("pct_double", ref_rows)
    assert_rank_error(np.random.default_rng(11).lognormal(0, 3, 50_000), got["q"][0], 0.5)


def test_percentile_multi_call_bounded_state(ref_rows):
    [got] = port_rows("pct_multi", ref_rows)
    for name, q in (("p50", 0.5), ("p90", 0.9)):
        assert_rank_error(_multi()["v"], got[name][0], q)


def test_mixed_node_percentile(ref_rows):
    [got] = port_rows("mixed_percentile", ref_rows)
    cols = _mixed_pct()
    df = pd.DataFrame({"g": cols["g"], "v": cols["v"]})
    exact = df.groupby("g")["v"].median().values
    rel = np.abs(np.asarray(got["med"]) - exact) / exact
    assert (rel < 0.02).all(), rel
    assert got["c"] == list(df.groupby("g").size().values)


def test_weighted_percentile(ref_rows):
    [got] = port_rows("weighted", ref_rows)
    cols = _weighted()
    for gi, q in zip(got["g"], got["q"]):
        m = cols["g"] == gi
        xs = np.sort(np.repeat(cols["x"][m], cols["w"][m]))
        exact = xs[min(len(xs) - 1, int(np.ceil(0.5 * len(xs)) - 1))]
        assert abs(q - exact) / exact < 0.02
