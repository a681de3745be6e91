"""Sketch aggregates of the port (``exec/sketch.py``) against the JAX
package's: the approx_distinct and mixed-node cases of
``tests/test_sketch.py`` (its percentile cases are in the two
``test_torch_sketch_percentile*.py`` files) on the same numpy-seeded rows,
plus ``_split_mixed_node`` on a directly built ``AggregationNode``
(the only way a mixed node keeps its approx_distinct: ``PlanBuilder`` makes
it an exact distinct count, in both packages) and the device functions
``hll_bucket64`` / ``hll_rho64`` / ``dd_bucket64`` value by value.

Each plan runs through both packages; the JAX package's rows are computed
once for the module.  The estimates are integer max / sum merges and a
deterministic rank compression, so the two packages agree exactly: integers
bit for bit, DOUBLE to rtol 1e-9.  Each case also keeps the reference test's
own error bound (4 sigma of HLL's 2.3 %, KLL's rank error 2/m, DDSketch's
0.5 % value error).  Row counts are those of the reference test where it
runs in a few seconds, cut to a quarter where it does not (the bounds are
relative, so they hold at any count).  ``test_distributed_matches_local``
waits for the distributed executor (``parallel/``, ROADMAP Queue 1 item 12).
"""

import types

import numpy as np
import pandas as pd
import pytest
import torch

import velox_tpu.dtypes as vt
import velox_tpu_torch.dtypes as pt
from velox_tpu.config import DEFAULT_CONFIG as REF_CONFIG
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.exec.sketch import _register_hll_functions as ref_register_hll
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu_torch.config import DEFAULT_CONFIG
from velox_tpu_torch.exec import sketch
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.io.table import Table
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import assert_same_values, python_rows

TOL = 4 * 0.023  # 4 sigma at the reference's default stderr (log2m=11)

REF = types.SimpleNamespace(
    t=vt, Table=RefTable, B=RefBuilder,
    run=lambda p, tile_rows, cfg: RefExecutor(
        p, tile_rows, config=REF_CONFIG.copy(**cfg)).run(),
)
PORT = types.SimpleNamespace(
    t=pt, Table=Table, B=PlanBuilder,
    run=lambda p, tile_rows, cfg: LocalExecutor(
        p, tile_rows, config=DEFAULT_CONFIG.copy(**cfg), device="cpu").run(),
)


def values_table(n, ndv, with_group=False, seed=1):
    rng = np.random.default_rng(seed)
    cols = {"v": rng.integers(0, ndv, n).astype(np.int64) * 7919 + 13}
    if with_group:
        cols["g"] = rng.integers(0, 16, n).astype(np.int64)
    return cols


def make_table(k, cols, validities=None, types=None):
    names = list(cols)
    types = types or {}
    return k.Table(
        k.t.RowType(names, [getattr(k.t, types.get(n, "BIGINT")) for n in names]),
        cols, validities=validities or {},
    )


def agg_plan(k, cols, keys, aggs, validities=None, types=None):
    return (
        k.B().table_scan(make_table(k, cols, validities, types))
        .aggregation(list(keys), aggs).build()
    )


class Cases(dict):
    """name -> (plan maker(k), [(tile_rows, config overrides)]): the cases of
    one test module, each run through both packages."""

    def case(self, name, runs=((1 << 20, {}),)):
        def wrap(fn):
            self[name] = (fn, runs)
            return fn
        return wrap

    def rows(self, k, name):
        """The case's result rows through package ``k``, one dict of
        columns a run, rows sorted."""
        fn, runs = self[name]
        outs = []
        for tile_rows, cfg in runs:
            out = python_rows(k.run(fn(k), tile_rows, cfg))
            order = sorted(range(len(next(iter(out.values())))),
                           key=lambda i: tuple((v[i] is None, v[i]) for v in out.values()))
            outs.append({c: [v[i] for i in order] for c, v in out.items()})
        return outs

    def port(self, name, ref_rows, ref_runs=None):
        """The case through the port, asserted equal to the JAX package's rows
        (of the first ``ref_runs`` runs, every run by default); returns the
        port's rows."""
        got = self.rows(PORT, name)
        for g, w in zip(got, ref_rows[name][:ref_runs]):
            assert list(g) == list(w), name
            for c in w:
                assert_same_values(g[c], w[c], path=f"{name}.{c}")
        return got


CASES = Cases()
case = CASES.case


for _ndv in (50, 5_000, 200_000):
    case(f"ungrouped_{_ndv}")(
        lambda k, ndv=_ndv: agg_plan(k, values_table(100_000, ndv, seed=ndv), [],
                                     ["approx_distinct(v) as ad"]))
case("grouped")(lambda k: agg_plan(k, values_table(100_000, 20_000, True), ["g"],
                                   ["approx_distinct(v) as ad"]))
case("tile_sizes", runs=((1 << 11, {}), (1 << 18, {})))(
    lambda k: agg_plan(k, values_table(50_000, 30_000), [], ["approx_distinct(v) as ad"]))


def _nulls_cols():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 1000, 50_000).astype(np.int64)
    return {"v": v}, {"v": rng.random(50_000) > 0.5}


case("nulls")(lambda k: agg_plan(k, _nulls_cols()[0], [], ["approx_distinct(v) as ad"],
                                 _nulls_cols()[1]))
case("small_cardinality")(lambda k: agg_plan(k, values_table(10_000, 12), [],
                                             ["approx_distinct(v) as ad"]))
case("mixed_exact")(lambda k: agg_plan(k, values_table(20_000, 500, True), ["g"],
                                       ["approx_distinct(v) as ad", "count(*) as c"]))
case("mixed_grouped")(lambda k: agg_plan(
    k, values_table(60_000, 8_000, True, seed=7), ["g"],
    ["sum(v) as sv", "approx_distinct(v) as ad", "count(*) as c"]))
case("mixed_ungrouped")(lambda k: agg_plan(
    k, values_table(50_000, 3_000, seed=11), [],
    ["count(*) as c", "approx_distinct(v) as ad", "max(v) as mx"]))


def _null_keys():
    rng = np.random.default_rng(3)
    g = rng.integers(0, 5, 20_000).astype(np.int64)
    gv = rng.random(20_000) > 0.2
    return {"g": g, "v": rng.integers(0, 500, 20_000).astype(np.int64)}, {"g": gv}


case("mixed_null_key")(lambda k: agg_plan(k, _null_keys()[0], ["g"],
                                          ["count(*) as c", "approx_distinct(v) as ad"],
                                          _null_keys()[1]))
case("mixed_null_key_direct")(lambda k: _direct_mixed(k, *_null_keys()))


def _direct_mixed(k, cols, validities):
    """An AggregationNode built directly with approx_distinct beside count:
    the sketch rewrite splits it and re-joins on NULL-safe keys."""
    from importlib import import_module

    nodes = import_module(f"{k.t.__name__.rsplit('.', 1)[0]}.plan.nodes")
    ir = import_module(f"{k.t.__name__.rsplit('.', 1)[0]}.expr.ir")
    scan = k.B().table_scan(make_table(k, cols, validities)).build()
    bigint = k.t.BIGINT
    return nodes.AggregationNode(
        scan, nodes.AggregationStep.SINGLE, ("g",), ("c", "ad"),
        (ir.Call(bigint, "count", ()),
         ir.Call(bigint, "approx_distinct", (ir.FieldAccess(bigint, "v"),))),
    )


@pytest.fixture(scope="module")
def ref_rows():
    """Every case through the JAX package once."""
    return {name: CASES.rows(REF, name) for name in CASES}


def port_rows(name, ref_rows):
    return CASES.port(name, ref_rows)


def _exact_ndv(name):
    cols = {"ungrouped_50": values_table(100_000, 50, seed=50),
            "ungrouped_5000": values_table(100_000, 5_000, seed=5_000),
            "ungrouped_200000": values_table(100_000, 200_000, seed=200_000)}[name]
    return len(np.unique(cols["v"]))


@pytest.mark.parametrize("ndv", [50, 5_000, 200_000])
def test_ungrouped_accuracy(ndv, ref_rows):
    [got] = port_rows(f"ungrouped_{ndv}", ref_rows)
    exact = _exact_ndv(f"ungrouped_{ndv}")
    assert abs(got["ad"][0] - exact) <= max(TOL * exact, 3), (got, exact)


def test_grouped_accuracy(ref_rows):
    [got] = port_rows("grouped", ref_rows)
    cols = values_table(100_000, 20_000, True)
    exact = pd.DataFrame(cols).groupby("g")["v"].nunique()
    for g, est in zip(got["g"], got["ad"]):
        assert abs(est - exact[g]) <= max(TOL * exact[g], 3), (g, est, exact[g])


def test_tile_size_invariance(ref_rows):
    a, b = port_rows("tile_sizes", ref_rows)
    assert a == b


def test_nulls_ignored(ref_rows):
    [got] = port_rows("nulls", ref_rows)
    cols, val = _nulls_cols()
    exact = len(np.unique(cols["v"][val["v"]]))
    assert abs(got["ad"][0] - exact) <= max(TOL * exact, 3)


def test_small_cardinality_is_exact(ref_rows):
    [got] = port_rows("small_cardinality", ref_rows)
    assert got["ad"][0] == len(np.unique(values_table(10_000, 12)["v"]))


def test_mixed_aggregation_keeps_exact_path(ref_rows):
    [got] = port_rows("mixed_exact", ref_rows)
    want = pd.DataFrame(values_table(20_000, 500, True)).groupby("g")["v"].nunique()
    assert got["ad"] == list(want.values)


def _walk_names(node, names):
    for c in getattr(node, "aggregates", ()):
        names.add(c.name)
    for s in getattr(node, "sources", ()):
        _walk_names(s, names)
    return names


def test_mixed_node_grouped(ref_rows):
    [got] = port_rows("mixed_grouped", ref_rows)
    assert list(got) == ["g", "sv", "ad", "c"]
    df = pd.DataFrame(values_table(60_000, 8_000, True, seed=7))
    exact = df.groupby("g").agg(sv=("v", "sum"), ad=("v", "nunique"), c=("v", "size"))
    assert got["sv"] == list(exact["sv"]) and got["c"] == list(exact["c"])
    err = np.abs(np.asarray(got["ad"]) - exact["ad"].values) / exact["ad"].clip(lower=1).values
    assert (err <= TOL + 3 / exact["ad"].clip(lower=1).values).all()
    plan = CASES["mixed_grouped"][0](PORT)
    assert "approx_distinct" not in _walk_names(sketch.rewrite_sketch_aggregates(plan), set())


def test_mixed_node_ungrouped(ref_rows):
    [got] = port_rows("mixed_ungrouped", ref_rows)
    v = values_table(50_000, 3_000, seed=11)["v"]
    assert list(got) == ["c", "ad", "mx"]
    assert got["c"] == [50_000] and got["mx"] == [int(v.max())]
    exact = len(np.unique(v))
    assert abs(got["ad"][0] - exact) <= max(TOL * exact, 3)


def _null_key_exact():
    cols, val = _null_keys()
    df = pd.DataFrame({"g": pd.array(np.where(val["g"], cols["g"], None)), "v": cols["v"]})
    return df.groupby("g", dropna=False).agg(c=("v", "size"), ad=("v", "nunique")).reset_index()


def test_mixed_node_null_group_key(ref_rows):
    [got] = port_rows("mixed_null_key", ref_rows)
    exact = _null_key_exact()
    assert len(got["g"]) == len(exact) == 6  # 5 groups + the NULL group
    by_key = {(None if pd.isna(g) else int(g)): (c, ad) for g, c, ad in exact.itertuples(index=False)}
    for g, c, ad in zip(got["g"], got["c"], got["ad"]):
        assert c == by_key[g][0] and abs(ad - by_key[g][1]) <= (TOL + 0.05) * by_key[g][1]


def test_split_mixed_node_built_directly(ref_rows):
    """A directly built mixed node keeps approx_distinct: the rewrite splits
    it into count and an HLL piece, re-joined on the NULL-safe key (the NULL
    group included), and the columns keep their order."""
    [got] = port_rows("mixed_null_key_direct", ref_rows)
    assert list(got) == ["g", "c", "ad"]
    exact = _null_key_exact()
    by_key = {(None if pd.isna(g) else int(g)): (c, ad) for g, c, ad in exact.itertuples(index=False)}
    assert sorted(map(repr, got["g"])) == sorted(map(repr, by_key))
    for g, c, ad in zip(got["g"], got["c"], got["ad"]):
        assert c == by_key[g][0] and abs(ad - by_key[g][1]) <= max(TOL * by_key[g][1], 3)
    plan = _direct_mixed(PORT, *_null_keys())
    rewritten = sketch.rewrite_sketch_aggregates(plan)
    names = _walk_names(rewritten, set())
    assert "approx_distinct" not in names and {"count", "max", "sum"} <= names
    assert type(rewritten).__name__ == "ProjectNode"
    assert type(rewritten.source).__name__ == "HashJoinNode"


def test_device_functions_match_reference():
    """hll_bucket64 / hll_rho64 / dd_bucket64 value by value against the JAX
    package's, on integers, the edges of int64, doubles (their IEEE bits) and
    the powers of gamma, where DDSketch's bucket boundaries lie (a one-ulp
    difference between torch's log and XLA's would move such a value into
    the next bucket; on the CPU there is none); the all-zero remainder
    (rho 65) included."""
    import jax.numpy as jnp

    from velox_tpu.expr.registry import DEFAULT_REGISTRY as REF_REG

    ref_register_hll()
    rng = np.random.default_rng(21)
    ints = np.concatenate([
        rng.integers(-(1 << 62), 1 << 62, 4000), [0, 1, -1, (1 << 63) - 1, -(1 << 63)],
    ]).astype(np.int64)
    gamma = (1 + 0.005) / (1 - 0.005)
    doubles = np.concatenate([
        rng.lognormal(0, 5, 4000), -rng.lognormal(0, 5, 100), [0.0, -0.0, 1e-300, 1.0],
        gamma ** np.arange(-50, 50, dtype=np.float64),
    ])
    for name, fn in (("hll_bucket64", sketch.hll_bucket), ("hll_rho64", sketch.hll_rho),
                     ("dd_bucket64", sketch.dd_bucket)):
        [sig] = REF_REG.signatures(name)
        for x in (ints, doubles):
            want = np.asarray(sig.impl(None, None, None, jnp.asarray(x)))
            got = fn(torch.from_numpy(x)).numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)
    # rho of the value whose hash remainder is all zero is 65 in both
    zero_rem = np.asarray([0], np.int64)  # hash64(0) == 0
    assert int(sketch.hll_rho(torch.from_numpy(zero_rem))[0]) == 65
