"""Every aggregate of the port against the JAX package's, on the same seeded
numpy rows: the cases of ``tests/test_aggregates_extended.py`` and
each through both ``LocalExecutor``s (``tests/test_null_grouping.py`` is
mirrored in ``test_torch_null_grouping.py``, the fuzzer's one-tile and
host-merge plans in ``test_torch_aggregation_fuzzer.py``).

Each aggregate runs ungrouped, grouped in array mode (a key of 7 values) and
grouped in sort mode over several tiles with the device carry merge; the
host merge (``device_agg_merge=False``) of every aggregate is in
``test_torch_aggregation_fuzzer.py``.  Integers and booleans
agree exactly, DOUBLE to rtol 1e-9.  The statistical aggregates (variance,
covariance, correlation, skewness, kurtosis) differ in algorithm: the JAX
package keeps raw power sums and subtracts at the end, which cancels where a
group's spread is small beside its mean (3.5e-7 of error in the standard
deviation of one row); the port merges central moments
(``exec/aggregates.py MomentAggregate``).  A value of the port that is not
within rtol 1e-9 of the reference must be at least as close as the
reference to the exact value, computed with Python fractions from the same
rows (``_exact_stat``).  The registry test holds the port's aggregate names
to the reference's."""

import math
import re
from fractions import Fraction

import numpy as np
import pytest

import velox_tpu as vt
from velox_tpu.exec.aggregates import AGGREGATE_NAMES as REF_NAMES
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu_torch.dtypes import BIGINT, map_
from velox_tpu_torch.exec.aggregates import AGGREGATE_NAMES, bind_aggregate
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor
from velox_tpu_torch.plan import PlanBuilder as PortBuilder
from velox_tpu_torch.testing import assert_same_rows, table_from_numpy

N = 1000
RNG = np.random.default_rng(42)
K = RNG.integers(0, 7, N).astype(np.int64)
WIDE = RNG.integers(0, 300, N).astype(np.int64)  # sort mode: 300 groups
V = RNG.integers(-50, 50, N).astype(np.int64)
W = RNG.normal(size=N)
P = np.abs(V) + 1.0
B = RNG.random(N) > 0.3
D = (V * 7).astype(np.int64)  # DECIMAL(10, 2)
S_WORDS = ["", "pear", "apple", "fig", "banana", "kiwi", "zeta"]
S = RNG.integers(1, len(S_WORDS), N).astype(np.int32)
VALID_V = RNG.random(N) > 0.15

_COLS = {
    "k": (K, "BIGINT"), "g": (WIDE, "BIGINT"), "v": (V, "BIGINT"), "w": (W, "DOUBLE"),
    "p": (P, "DOUBLE"), "b": (B, "BOOLEAN"), "d": (D, "DECIMAL(10, 2)"), "s": (S, "VARCHAR"),
    "nv": (V, "BIGINT"),
}


def _tables():
    names = list(_COLS)
    data = {n: c[0] for n, c in _COLS.items()}
    validities = {"nv": VALID_V}
    port = table_from_numpy(names, [c[1] for c in _COLS.values()], data, {"s": S_WORDS}, validities)
    ref_types = [
        vt.BIGINT, vt.BIGINT, vt.BIGINT, vt.DOUBLE, vt.DOUBLE, vt.BOOLEAN,
        vt.decimal(10, 2), vt.VARCHAR, vt.BIGINT,
    ]
    ref = RefTable(
        vt.RowType(names, ref_types), dict(data),
        {"s": vt.StringTable.from_values(S_WORDS)}, dict(validities),
    )
    return ref, port


# name: the aggregate calls of one case
CASES = {
    "count_if_and_bool": ["count_if(b) as ci", "bool_and(b) as ba", "bool_or(b) as bo", "every(b) as ev"],
    "variance_family": [
        "variance(w) as va", "var_samp(w) as vs", "var_pop(w) as vp",
        "stddev(w) as sd", "stddev_samp(w) as ss", "stddev_pop(w) as sdp",
    ],
    "variance_on_decimal": ["var_pop(d) as vp", "stddev_samp(d) as sd"],
    "covar_corr": ["covar_pop(v, w) as cp", "covar_samp(v, w) as cs", "corr(v, w) as r"],
    "min_by_max_by": ["min_by(v, w) as mn", "max_by(v, w) as mx"],
    "min_by_ties": ["min_by(w, v) as mn", "max_by(w, v) as mx", "max_by(v, k) as mk"],
    "min_by_strings": ["min_by(s, v) as ms", "max_by(v, s) as mv"],
    "min_max_strings": ["min(s) as mn", "max(s) as mx", "arbitrary(s) as ar"],
    "arbitrary_and_geometric_mean": ["geometric_mean(p) as gm", "arbitrary(p) as ar", "arbitrary(v) as av"],
    "checksum": ["checksum(v) as c", "checksum(w) as cw"],
    "moments": ["skewness(w) as sk", "kurtosis(w) as ku", "skewness(v) as sv"],
    "bitwise": ["bitwise_and_agg(v) as a", "bitwise_or_agg(v) as o"],
    "null_handling": [
        "count(nv) as c", "min_by(nv, nv) as mb", "max_by(w, nv) as mw",
        "bitwise_or_agg(nv) as o", "checksum(nv) as ck", "var_samp(nv) as vs",
    ],
}

# label: (grouping keys, tile rows)
MODES = {
    "ungrouped": ((), 256),
    "array": (("k",), 256),
    "sort_device_merge": (("g",), 256),
}


def _run_both(aggs, keys, tile):
    ref_t, port_t = _tables()

    def plan(builder, t):
        pb = builder().table_scan(t).aggregation(list(keys), list(aggs))
        return (pb.orderby(list(keys)) if keys else pb).build()

    port_ex = PortExecutor(plan(PortBuilder, port_t), tile_rows=tile, device="cpu")
    ref_ex = RefExecutor(plan(RefBuilder, ref_t), tile_rows=tile)
    return port_ex, port_ex.run(), ref_ex.run()


_STATS = (
    "variance", "var_samp", "var_pop", "stddev", "stddev_samp", "stddev_pop",
    "covar_pop", "covar_samp", "corr", "skewness", "kurtosis",
)
_CALL = re.compile(r"^(\w+)\((\w+)(?:, (\w+))?\) as (\w+)$")


def _exact_stat(name, x, y):
    """The statistic of one group in exact rational arithmetic, rounded once
    (a square root or a power of 1.5 is taken of the rounded rational)."""
    n = len(x)
    mx = sum(x) / n
    m2 = sum((a - mx) ** 2 for a in x)
    if name in ("covar_pop", "covar_samp", "corr"):
        my = sum(y) / n
        cxy = sum((a - mx) * (b - my) for a, b in zip(x, y))
        if name == "corr":
            return float(cxy) / math.sqrt(float(m2 * sum((b - my) ** 2 for b in y)))
        return float(cxy / (n if name == "covar_pop" else n - 1))
    if name == "skewness":
        m3 = sum((a - mx) ** 3 for a in x)
        return math.sqrt(n) * float(m3) / float(m2) ** 1.5
    if name == "kurtosis":
        m4 = sum((a - mx) ** 4 for a in x)
        return float(n * m4 / (m2 * m2) - 3)
    var = m2 / (n if name.endswith("_pop") else n - 1)
    return math.sqrt(float(var)) if name.startswith("stddev") else float(var)


def _column_fractions(name):
    values, dtype = _COLS[name]
    if dtype.startswith("DECIMAL"):
        return [Fraction(int(v), 100) for v in values]
    return [Fraction(float(v)) if isinstance(v, float) else Fraction(int(v)) for v in values.tolist()]


def _assert_stats_no_worse_than_reference(got, want, aggs, keys):
    """Each DOUBLE statistic not within rtol 1e-9 of the reference is at
    least as close as the reference to the exact value."""
    ref_t, _ = _tables()
    valid_rows = np.ones(N, bool)
    for call in aggs:
        fn, a, b, out = _CALL.match(call).groups()
        if fn not in _STATS:
            continue
        g = np.asarray(got.columns[out], dtype=np.float64)
        w = np.asarray(want.columns[out], dtype=np.float64)
        ok = np.isclose(g, w, rtol=1e-9, atol=0) | ~np.asarray(
            want.validities.get(out, np.ones(len(w), bool))
        )
        xs, ys = _column_fractions(a), _column_fractions(b) if b else None
        for row in np.flatnonzero(~ok):
            sel = valid_rows.copy()
            for k in keys:
                sel &= _COLS[k][0] == np.asarray(got.columns[k])[row]
            idx = np.flatnonzero(sel)
            exact = _exact_stat(fn, [xs[i] for i in idx], [ys[i] for i in idx] if ys else None)
            assert abs(g[row] - exact) <= max(abs(w[row] - exact), 1e-9 * abs(exact)), (
                call, row, g[row], w[row], exact
            )
        got.columns[out] = np.where(ok, g, w)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(CASES))
def test_aggregate_matches_reference(case, mode):
    keys, tile = MODES[mode]
    ex, got, want = _run_both(CASES[case], keys, tile)
    assert ex.kind == {
        "ungrouped": "direct_agg", "array": "direct_agg", "sort_device_merge": "sort_agg_device",
    }[mode]
    _assert_stats_no_worse_than_reference(got, want, CASES[case], keys)
    assert_same_rows(got, want)


def test_one_row_statistics_are_exact():
    """A one-row group's variance and standard deviation are 0 and a two-row
    group's skewness is 0 in exact arithmetic; the port's central moments
    give the first two exactly and the third within rounding of the group's
    own values."""
    ex, got, _ = _run_both(
        ["count(*) as n", "var_pop(w) as vp", "stddev_pop(w) as sd", "skewness(w) as sk"],
        ("g",), 256,
    )
    n = np.asarray(got.columns["n"])
    assert (n == 1).any() and (n == 2).any()
    assert (np.asarray(got.columns["vp"])[n == 1] == 0).all()
    assert (np.asarray(got.columns["sd"])[n == 1] == 0).all()
    assert np.abs(np.asarray(got.columns["sk"])[n == 2]).max() < 1e-9


def test_bitwise_aggregates_expected_rows():
    """``tests/test_aggregates_extended.py::test_bitwise_aggregates`` in the
    port, two rows a tile so the carry combines them."""
    t = table_from_numpy(
        ["g", "x"], ["BIGINT", "BIGINT"],
        {"g": np.array([1, 1, 1, 2, 2]), "x": np.array([0b1101, 0b1011, 0b1111, 0b0101, 0b0110])},
    )
    plan = (
        PortBuilder().table_scan(t)
        .aggregation(["g"], ["bitwise_and_agg(x) as a", "bitwise_or_agg(x) as o"])
        .orderby(["g"]).build()
    )
    out = PortExecutor(plan, tile_rows=2, device="cpu").run()
    assert list(out.columns["a"]) == [0b1001, 0b0100]
    assert list(out.columns["o"]) == [0b1111, 0b0111]


def test_checksum_order_independent():
    perm = RNG.permutation(N)
    outs = []
    for order in (np.arange(N), perm):
        t = table_from_numpy(["k", "v"], ["BIGINT", "BIGINT"], {"k": K[order], "v": V[order]})
        plan = PortBuilder().table_scan(t).aggregation(["k"], ["checksum(v) as c"]).orderby(["k"]).build()
        outs.append(PortExecutor(plan, tile_rows=128, device="cpu").run())
    assert_same_rows(outs[0], outs[1])


def test_aggregate_names_match_reference():
    """The port binds every name of the reference's ``AGGREGATE_NAMES`` and
    ``COLLECT_AGG_NAMES``, the sketches included: approx_distinct and
    bloom_filter_agg type their node for the sketch rewrite (their update
    raises: the rewrite lowers them before a plan runs), approx_percentile
    and the rewrite's finishers bind to ``exec/collect_agg.py`` as the other
    collect aggregates do; the Spark aliases bind to their targets."""
    from velox_tpu.exec.collect_agg import COLLECT_AGG_NAMES as REF_COLLECT
    from velox_tpu_torch.dtypes import DOUBLE, VARBINARY
    from velox_tpu_torch.exec.collect_agg import COLLECT_AGG_NAMES, CollectAggregate

    assert set(AGGREGATE_NAMES) == set(REF_NAMES)
    assert set(COLLECT_AGG_NAMES) == set(REF_COLLECT)
    assert set(COLLECT_AGG_NAMES).isdisjoint(AGGREGATE_NAMES)
    arg_types = {"map_agg": (BIGINT, BIGINT), "multimap_agg": (BIGINT, BIGINT),
                 "map_union": (map_(BIGINT, BIGINT),),
                 "approx_most_frequent": (BIGINT, BIGINT, BIGINT),
                 "approx_percentile": (BIGINT, DOUBLE),
                 "__dd_quantile": (BIGINT, BIGINT, DOUBLE),
                 "__kll_quantile": (BIGINT, BIGINT, BIGINT, DOUBLE),
                 "__bloom_assemble": (BIGINT, BIGINT, BIGINT)}
    for name in COLLECT_AGG_NAMES:
        bound = bind_aggregate(name, arg_types.get(name, (BIGINT,)))
        assert isinstance(bound, CollectAggregate) and bound.name == name
    for name, result in (("approx_distinct", BIGINT), ("bloom_filter_agg", VARBINARY)):
        bound = bind_aggregate(name, (BIGINT,))
        assert bound.name == name and bound.result_type == result
        with pytest.raises(NotImplementedError, match="rewrite_sketch_aggregates"):
            bound.raw_inputs((np.zeros(2, np.int64),), np.ones(2, bool))
    for alias, target in (("first", "arbitrary"), ("last", "arbitrary"),
                          ("collect_list", "array_agg"), ("collect_set", "set_agg")):
        assert bind_aggregate(alias, (BIGINT,)).name == target


def test_new_aggregates_stay_off_the_piece_path():
    """The grouped piece-sum kernel takes sums, averages and counts only:
    every new aggregate keeps the plan on the per-accumulator path, as in
    the reference."""
    _, port_t = _tables()
    for aggs in CASES.values():
        plan = PortBuilder().table_scan(port_t).aggregation(["k"], list(aggs)).build()
        ex = PortExecutor(plan, tile_rows=256, device="cpu")
        assert ex.agg_exec._piece_plan is None
