"""Window functions of the port against the JAX package's, on the same numpy
tables: every case of ``tests/test_window.py`` (the rank family, running and
full-partition aggregates, lead / lag / first / last / nth value with and
without IGNORE NULLS, ntile, percent_rank / cume_dist, k-bounded ROWS and
RANGE frames, the variance family, inputs chunked into whole partitions and
a partition larger than a tile), and the lowerings of ``row_number``,
``topn_row_number`` and ``mark_distinct``.  The window primitives are held
against theirs in ``test_torch_window_primitives.py``.

Integer, date and string columns agree exactly, DOUBLE columns to rtol 1e-9.
The output order is compared too: both packages emit a window's rows in the
order of its stable partition sort."""

import numpy as np
import pytest

import velox_tpu as vt
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.vector.string_table import StringTable as RefStrings
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor
from velox_tpu_torch.plan import PlanBuilder as PortBuilder
from velox_tpu_torch.testing import table_from_numpy

_REF_TYPES = {"BIGINT": vt.BIGINT, "DOUBLE": vt.DOUBLE, "VARCHAR": vt.VARCHAR, "DATE": vt.DATE,
              "DECIMAL(12,2)": vt.decimal(12, 2)}
RTOL = 1e-9


def _pair(cols, types=None, strings=None, validities=None):
    names = list(cols)
    types = types or ["BIGINT"] * len(names)
    port = table_from_numpy(names, types, cols, strings, validities)
    ref = RefTable(
        vt.RowType(names, [_REF_TYPES[t] for t in types]), dict(cols),
        {k: RefStrings.from_values(v) for k, v in (strings or {}).items()},
        dict(validities or {}),
    )
    return ref, port


def _same_rows(got, want):
    """Same schema, row count, order, validity (a missing validity is all
    valid) and values: exact, DOUBLE to RTOL, strings through their
    dictionaries."""
    assert list(got.schema.names) == list(want.schema.names)
    assert [str(t) for t in got.schema.types] == [str(t) for t in want.schema.types]
    assert got.num_rows == want.num_rows
    n = want.num_rows
    for name, dtype in zip(want.schema.names, want.schema.types):
        gv = got.validities.get(name)
        wv = want.validities.get(name)
        gv = np.ones(n, bool) if gv is None else np.asarray(gv, bool)
        wv = np.ones(n, bool) if wv is None else np.asarray(wv, bool)
        np.testing.assert_array_equal(gv, wv, err_msg=name)
        g, w = np.asarray(got.columns[name])[wv], np.asarray(want.columns[name])[wv]
        if dtype.is_string:
            g = got.string_tables[name].decode(g)
            w = want.string_tables[name].decode(w)
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=name)


def _run_both(pair, make, tile_rows=1 << 20):
    """The plan ``make(builder, table)`` through both executors; returns
    (port Table, JAX Table, port executor)."""
    ref, port = pair
    want = RefExecutor(make(RefBuilder, ref).build(), tile_rows=tile_rows).run()
    ex = PortExecutor(make(PortBuilder, port).build(), tile_rows=tile_rows, device="cpu")
    return ex.run(), want, ex


# ---- the data of tests/test_window.py --------------------------------------


def _data():
    rng = np.random.default_rng(7)
    n = 200
    return _pair({"g": rng.integers(0, 8, n), "o": rng.integers(0, 40, n),
                  "v": rng.integers(-50, 50, n)})


def _lead_lag_data():
    rng = np.random.default_rng(3)
    g, o, v = [], [], []
    for part in range(6):
        g.append(np.full(30, part))
        o.append(rng.permutation(30))
        v.append(rng.integers(-50, 50, 30))
    return _pair({"g": np.concatenate(g), "o": np.concatenate(o), "v": np.concatenate(v)})


def _ntile_data():
    return _pair({"g": np.ones(10, np.int64), "o": np.arange(10), "v": np.arange(10)})


def _percent_data():
    return _pair({"g": np.ones(4, np.int64), "o": np.array([10, 10, 20, 30]),
                  "v": np.array([1, 2, 3, 4])})


def _nth_data():
    return _pair({"g": np.array([1, 1, 1, 1, 2, 2, 2]), "o": np.array([1, 2, 3, 4, 1, 2, 3]),
                  "v": np.array([10, 20, 30, 40, 5, 6, 7])})


def _k_frame_data():
    return _pair({"g": np.array([1, 1, 1, 1, 2, 2]), "o": np.array([1, 2, 5, 6, 1, 9]),
                  "v": np.array([10, 20, 30, 40, 7, 9])})


def _ignore_nulls_data():
    return _pair(
        {"g": np.array([1, 1, 1, 1, 1, 2, 2]), "o": np.array([1, 2, 3, 4, 5, 1, 2]),
         "v": np.array([10, 0, 0, 40, 0, 0, 70])},
        validities={"v": np.array([1, 0, 0, 1, 0, 0, 1], bool)},
    )


def _variance_data():
    return _pair({"g": np.array([1, 1, 1, 2, 2]), "o": np.array([1, 2, 3, 1, 2]),
                  "v": np.array([1.0, 3.0, 5.0, 2.0, 2.0])}, ["BIGINT", "BIGINT", "DOUBLE"])


def _mixed_data():
    """Nullable DOUBLE, DECIMAL and DATE values, a VARCHAR partition key,
    ties in the order key: the typed paths of every function."""
    rng = np.random.default_rng(21)
    n = 600
    return _pair(
        {"s": rng.integers(1, 6, n).astype(np.int32), "o": rng.integers(0, 50, n),
         "d": rng.normal(size=n) * 100, "m": rng.integers(-10**6, 10**6, n),
         "t": rng.integers(9000, 9400, n).astype(np.int32)},
        ["VARCHAR", "BIGINT", "DOUBLE", "DECIMAL(12,2)", "DATE"],
        strings={"s": ["", "ash", "birch", "cedar", "dogwood", "elm"]},
        validities={"d": rng.random(n) < 0.85, "m": rng.random(n) < 0.9},
    )


_ALL_FUNCTIONS = [
    "row_number() as rn", "rank() as rk", "dense_rank() as dr", "sum(v) as s",
    "count(v) as c", "avg(v) as m", "min(v) as mn", "max(v) as mx", "lag(v) as lg",
    "lead(v, 2) as ld", "first_value(v) as fv", "last_value(v) as lv", "ntile(3) as nt",
    "percent_rank() as pr", "cume_dist() as cd", "nth_value(v, 2) as nv",
]

# name: (data, partition keys, order keys, calls, orderby after the window)
CASES = {
    "row_number_rank_dense_rank": (_data, ["g"], ["o"],
                                   ["row_number() as rn", "rank() as rk", "dense_rank() as dr"],
                                   ["g", "o", "v"]),
    "running_sum_range_frame": (_data, ["g"], ["o"], ["sum(v) as s"], ["g", "o", "v"]),
    "count_and_avg": (_data, ["g"], ["o"], ["count(v) as c", "avg(v) as m"], ["g", "o", "v"]),
    "lead_lag": (_lead_lag_data, ["g"], ["o"], ["lag(v) as prev", "lead(v) as nxt"],
                 ["g", "o", "v"]),
    "first_last_value": (_data, ["g"], ["o"], ["first_value(v) as fv", "last_value(v) as lv"],
                         ["g", "o", "v"]),
    "ntile": (_ntile_data, ["g"], ["o"], ["ntile(3) as t"], ["g", "o", "v"]),
    "percent_rank_cume_dist": (_percent_data, ["g"], ["o"],
                               ["percent_rank() as pr", "cume_dist() as cd"], ["g", "o", "v"]),
    "nth_value_and_rows_frames": (_nth_data, ["g"], ["o"], [
        "nth_value(v, 2) as nv",
        "sum(v) rows between 1 preceding and 1 following as ws",
        "count(v) rows between unbounded preceding and current row as wc",
        "avg(v) rows between 1 preceding and current row as wa",
    ], None),
    "k_bounded_frames_rows_and_range": (_k_frame_data, ["g"], ["o"], [
        "min(v) rows between 1 preceding and current row as m1",
        "max(v) rows between current row and 1 following as m2",
        "sum(v) range between 1 preceding and 1 following as rs",
        "min(v) range between 3 preceding and current row as rm",
        "count(v) range between unbounded preceding and 0 following as rc",
    ], None),
    "ignore_nulls_lead_lag_first_last": (_ignore_nulls_data, ["g"], ["o"], [
        "lag(v) ignore nulls as lg", "lead(v) ignore nulls as ld",
        "first_value(v) ignore nulls as fv", "last_value(v) ignore nulls as lv",
    ], None),
    "variance_window_aggregates": (_variance_data, ["g"], ["o"], [
        "variance(v) as v1", "stddev_pop(v) as sp",
        "var_pop(v) rows between 1 preceding and current row as vr",
    ], None),
    # beyond tests/test_window.py: every function at once, the frames on
    # DOUBLE / DECIMAL / DATE, DESC order keys, no partition keys
    "every_function": (_data, ["g"], ["o"], _ALL_FUNCTIONS + [
        "sum(v) rows between 1 preceding and 1 following as ws",
        "min(v) rows between 2 preceding and current row as wm",
        "max(v) range between 3 preceding and 2 following as rmx",
        "variance(v) as var",
        "stddev_pop(v) rows between 1 preceding and current row as sp",
        "var_samp(v) range between 5 preceding and current row as vs",
    ], None),
    "typed_columns": (_mixed_data, ["s"], ["o"], [
        "sum(d) as sd", "avg(m) as am", "min(t) as mt", "max(d) as xd", "lag(t, 2) as lt",
        "lead(m) ignore nulls as lm", "sum(m) rows between 3 preceding and 1 following as wm",
        "min(d) rows between 2 preceding and 2 following as wd",
        "stddev(d) rows between 4 preceding and current row as sdd",
        "avg(d) range between 5 preceding and 5 following as ad",
        "count(m) range between 10 preceding and current row as cm",
        "first_value(d) as fd", "last_value(t) ignore nulls as lt2",
    ], None),
    "desc_order_key": (_mixed_data, ["s"], ["o desc"], [
        "row_number() as rn", "rank() as rk", "sum(m) as sm", "min(d) as md",
        "max(o) range between 2 preceding and current row as mo",
    ], None),
    "two_desc_order_keys": (_mixed_data, ["s"], ["o desc", "t desc"], [
        "row_number() as rn", "dense_rank() as dr", "max(m) as xm", "lag(d, 3) as ld",
    ], None),
    "global_window": (_data, [], ["o"], ["row_number() as rn", "sum(v) as s", "max(v) as mx",
                                         "cume_dist() as cd"], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_matches_reference(case):
    data, part, order, calls, after = CASES[case]

    def make(builder, table):
        b = builder().table_scan(table).window(part, order, calls)
        return b.orderby(after) if after else b

    got, want, _ = _run_both(data(), make)
    _same_rows(got, want)


def test_value_functions_keep_the_string_dictionary():
    """lag / lead / first_value / last_value / nth_value of a VARCHAR return
    its strings (the JAX package returns the bare codes without their
    dictionary, so this is held against the expected strings)."""
    names = ["", "ash", "birch", "cedar"]
    _, port = _pair({"g": np.array([1, 1, 1, 2, 2]), "o": np.array([3, 1, 2, 1, 2]),
                     "s": np.array([1, 2, 3, 3, 1], np.int32)},
                    ["BIGINT", "BIGINT", "VARCHAR"], strings={"s": names})
    out = PortExecutor(PortBuilder().table_scan(port).window(["g"], ["o"], [
        "lag(s) as lg", "lead(s) as ld", "first_value(s) as fv", "last_value(s) as lv",
        "nth_value(s, 2) as nv",
    ]).build(), device="cpu").run().to_pandas()
    norm = lambda col: [None if v is None or v != v else v for v in col]  # noqa: E731
    assert norm(out["s"]) == ["birch", "cedar", "ash", "cedar", "ash"]
    assert norm(out["lg"]) == [None, "birch", "cedar", None, "cedar"]
    assert norm(out["ld"]) == ["cedar", "ash", None, "ash", None]
    assert norm(out["fv"]) == ["birch"] * 3 + ["cedar"] * 2
    assert norm(out["lv"]) == ["ash"] * 3 + ["ash"] * 2
    assert norm(out["nv"]) == [None, "cedar", "cedar", None, "ash"]


def test_count_star_over_raises_in_both_packages():
    """``count(*) over (...)`` is a gap of the JAX package (its argument
    ``*`` is looked up as a column); the port keeps it, so that it stays
    visible."""
    from velox_tpu.sql import run_sql as ref_run_sql
    from velox_tpu_torch.sql import run_sql

    ref, port = _data()
    text = "select g, count(*) over (partition by g) as c from t"
    with pytest.raises(ValueError):
        ref_run_sql(text, {"t": ref})
    with pytest.raises(ValueError):
        run_sql(text, {"t": port}, device="cpu")


# ---- inputs larger than a tile ---------------------------------------------


def test_multi_tile_window_chunked_partitions():
    """60 000 rows in 500 partitions over 4096-row tiles: whole partitions
    pack into chunks, each one device pass; the rows equal the JAX
    package's, and equal one pass over a tile that holds everything."""
    rng = np.random.default_rng(11)
    n = 60_000
    pair = _pair({"g": rng.integers(0, 500, n), "o": rng.permutation(n).astype(np.int64),
                  "v": rng.integers(-50, 50, n)})

    def make(builder, table):
        return builder().table_scan(table).window(
            ["g"], ["o", "v"], ["row_number() as rn", "sum(v) as sv", "rank() as rk"]
        ).orderby(["g", "o", "v"])

    small, want, ex = _run_both(pair, make, tile_rows=4096)
    _same_rows(small, want)
    assert len(ex.window_chunks) > 1
    # every pass holds whole partitions (about 120 rows each), a tile at most
    assert all(rows <= min(cap, 4096) for cap, rows in ex.window_chunks)
    assert sum(rows for _, rows in ex.window_chunks) == n
    big = PortExecutor(make(PortBuilder, pair[1]).build(), tile_rows=1 << 20, device="cpu")
    _same_rows(big.run(), small)
    assert len(big.window_chunks) == 1


def test_multi_tile_window_oversized_partition():
    """One partition holds half the input: it gets a pass of its own, sized
    to fit, larger than the tile."""
    rng = np.random.default_rng(13)
    n = 20_000
    g = rng.integers(0, 20, n)
    g[: n // 2] = 3
    pair = _pair({"g": g, "o": rng.integers(0, 10**6, n), "v": rng.integers(0, 9, n)})

    def make(builder, table):
        return builder().table_scan(table).window(["g"], ["o"], ["row_number() as rn"]).orderby(
            ["g", "o"]
        )

    got, want, ex = _run_both(pair, make, tile_rows=4096)
    _same_rows(got, want)
    assert max(cap for cap, _ in ex.window_chunks) >= n // 2 > 4096
    assert max(rows for _, rows in ex.window_chunks) >= n // 2


def test_row_number_topn_mark_distinct():
    """``row_number`` (with its per-partition limit), ``topn_row_number`` and
    ``mark_distinct`` lower onto a window plus a filter or a projection, as
    in the JAX package (mirrors ``tests/test_misc_operators.py``)."""
    pair = _pair({"g": np.array([1, 1, 1, 2, 2, 3]), "v": np.array([10, 20, 30, 40, 50, 60])})
    got, want, _ = _run_both(pair, lambda b, t: b().table_scan(t).row_number(["g"], limit=2))
    _same_rows(got, want)
    assert got.num_rows == 5 and int(np.max(got.columns["row_number"])) == 2
    pair = _pair({"g": np.array([1, 1, 1, 2, 2]), "v": np.array([30, 10, 20, 5, 50])})
    got, want, _ = _run_both(
        pair, lambda b, t: b().table_scan(t).topn_row_number(["g"], ["v desc"], 1).orderby(["g"])
    )
    _same_rows(got, want)
    assert list(got.columns["v"]) == [30, 50]
    pair = _pair({"k": np.array([7, 7, 8, 9, 8]), "v": np.array([1, 2, 3, 4, 5])})
    got, want, _ = _run_both(
        pair, lambda b, t: b().table_scan(t).mark_distinct("is_first", ["k"]).orderby(["v"])
    )
    _same_rows(got, want)
    assert list(got.columns["is_first"]) == [True, False, True, True, False]
