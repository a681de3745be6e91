"""Window functions, UNION [ALL] and non-equi joins through the port's SQL
front end against the JAX package's, text for text: the window and union
cases of ``tests/test_sql.py`` (TestWindow, TestUnion, TestWindowWithGroupBy,
the empty OVER () spec, the nested-loop routing), on the same seeded tables.
The TPC-H texts of the slice (W1-W4, F1, F2, U1, N1 in ``chip_smoke.py``)
are in ``test_torch_sql_window_tpch.py``.

Rows are compared as sorted frames unless the text orders them; integers
exactly, DOUBLE to rtol 1e-9."""

import numpy as np
import pandas as pd
import pytest

import velox_tpu as vt
from velox_tpu.io.table import Table as RefTable
from velox_tpu.sql import run_sql as ref_run_sql
from velox_tpu_torch.sql import run_sql
from velox_tpu_torch.testing import table_from_numpy


def _t(n, seed=1):
    """``tests/test_sql.py make_t``: k in [0, 20), v in [-100, 100), w a
    DOUBLE in [0, 10)."""
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 20, n), "v": rng.integers(-100, 100, n), "w": rng.random(n) * 10}
    ref = RefTable(vt.RowType(["k", "v", "w"], [vt.BIGINT, vt.BIGINT, vt.DOUBLE]), cols)
    return ref, table_from_numpy(["k", "v", "w"], ["BIGINT", "BIGINT", "DOUBLE"], cols)


def _gx(n, seed):
    """``TestWindowWithGroupBy``'s table: g in [0, 6) or [0, 8), x."""
    rng = np.random.default_rng(seed)
    cols = {"g": rng.integers(0, 6 if seed == 8 else 8, n), "x": rng.integers(0, 100 if seed == 8 else 50, n)}
    ref = RefTable(vt.RowType(["g", "x"], [vt.BIGINT, vt.BIGINT]), cols)
    return ref, table_from_numpy(["g", "x"], ["BIGINT", "BIGINT"], cols)


def _nl():
    cols_l, cols_r = {"a": np.array([1, 5, 9])}, {"b": np.array([2, 6])}
    return (
        (RefTable(vt.RowType(["a"], [vt.BIGINT]), cols_l), table_from_numpy(["a"], ["BIGINT"], cols_l)),
        (RefTable(vt.RowType(["b"], [vt.BIGINT]), cols_r), table_from_numpy(["b"], ["BIGINT"], cols_r)),
    )


# name: (tables {name: (ref, port)} maker, text, rows ordered by the text)
CASES = {
    "row_number_rank": (lambda: {"t": _t(1000)},
                        "select k, v, row_number() over (partition by k order by v) as rn,"
                        " rank() over (partition by k order by v) as rk "
                        "from t order by k, v, rn", False),
    "windowed_sum_with_frame": (lambda: {"t": _t(500)},
                                "select k, v, sum(v) over (partition by k order by v, w"
                                " rows between 1 preceding and current row) as s from t", False),
    "window_in_subquery_then_filter": (lambda: {"t": _t(800)},
                                       "select k, v from (select k, v, row_number() over"
                                       " (partition by k order by v desc) as rn from t) sub"
                                       " where rn = 1 order by k", True),
    "window_plus_groupby": (lambda: {"t": _t(100)},
                            "select k, sum(v) as s, row_number() over (order by k) as rn"
                            " from t group by k order by k", True),
    "union_all": (lambda: {"t": _t(300)},
                  "select k, v from t where v > 0 union all select k, v from t where v <= 0", False),
    "union_distinct": (lambda: {"t": _t(500)}, "select k from t union select k from t", False),
    "union_in_subquery_with_order": (lambda: {"t": _t(200)},
                                     "select a from (select k as a from t union all "
                                     "select v + 1000 as a from t) u order by a limit 5", True),
    "union_trailing_order_by_limit": (lambda: {"t": _t(200)},
                                      "select k as a from t union all select v + 1000 as a from t "
                                      "order by a limit 5", True),
    "union_trailing_order_by_desc": (lambda: {"t": _t(200)},
                                     "select k as a from t union all select v + 1000 as a from t "
                                     "order by 1 desc", True),
    "union_distinct_limit_offset": (lambda: {"t": _t(200)},
                                    "select k as a from t union select k as a from t order by a "
                                    "limit 3 offset 2", True),
    "rank_over_aggregate": (lambda: {"t": _gx(400, 8)},
                            "select g, sum(x) as s, rank() over (order by sum(x) desc) as r "
                            "from t group by g order by g", True),
    "running_total_of_group_sums": (lambda: {"t": _gx(500, 9)},
                                    "select g, sum(sum(x)) over (order by g) as running "
                                    "from t group by g order by g", True),
    "window_over_empty_spec": (lambda: {"t": _t(10)}, "select sum(v) over () as s from t", False),
    "moving_frames_and_offsets": (lambda: {"t": _t(700, seed=4)},
                                  "select k, v, w,"
                                  " avg(w) over (partition by k order by v rows between 2 preceding"
                                  " and 2 following) as aw,"
                                  " min(w) over (partition by k order by v range between 10 preceding"
                                  " and current row) as mw,"
                                  " lead(w, 2) over (partition by k order by v, w) as lw,"
                                  " dense_rank() over (partition by k order by v desc) as dr,"
                                  " ntile(4) over (partition by k order by v, w) as nt"
                                  " from t", False),
    "nested_loop_inner": (lambda: dict(zip(("L", "R"), _nl())),
                          "SELECT a, b FROM L JOIN R ON a > b", False),
    "nested_loop_left": (lambda: dict(zip(("L", "R"), _nl())),
                         "SELECT a, b FROM L LEFT JOIN R ON a > b", False),
}


def _sorted(df):
    return df.sort_values(list(df.columns), kind="mergesort", na_position="first").reset_index(drop=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sql_matches_reference(case):
    make, text, ordered = CASES[case]
    tables = make()
    want = ref_run_sql(text, {k: v[0] for k, v in tables.items()}).to_pandas()
    got = run_sql(text, {k: v[1] for k, v in tables.items()}, device="cpu").to_pandas()
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    if not ordered:
        got, want = _sorted(got), _sorted(want)
    pd.testing.assert_frame_equal(got.reset_index(drop=True), want.reset_index(drop=True),
                                  check_dtype=False, rtol=1e-9)


def test_union_order_by_branch_raises():
    """An ORDER BY on a branch of a set operation is refused in both."""
    from velox_tpu.sql import plan_sql as ref_plan_sql
    from velox_tpu_torch.sql import plan_sql

    ref, port = _t(10)
    text = "select k from t order by k union all select k from t"
    with pytest.raises(NotImplementedError, match="set-op"):
        ref_plan_sql(text, {"t": ref})
    with pytest.raises(NotImplementedError, match="set-op"):
        plan_sql(text, {"t": port})
