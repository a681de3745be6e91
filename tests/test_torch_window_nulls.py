"""NULL partition and order keys of window functions, held to expected rows.

Every NULL partition key forms one partition and every NULL order key one
peer group; an order key's NULLs sort first or last as its ``NULLS FIRST`` /
``NULLS LAST`` says (NULLS LAST by default), whatever its direction.  The
raw values under the NULLs are chosen to differ, so a window that reads them
gives other rows.  Each case runs through ``run_sql`` at three tile sizes:
at 4 rows the window source cuts the input into chunks of whole partitions.

The JAX package partitions and orders by the raw values under the NULLs, so
its rows differ here; for the three cases of ``ROADMAP.md`` Queue 3 the test
also asserts the reference's known-wrong rows, named as such, so that a
change on either side shows."""

import numpy as np
import pytest

import velox_tpu as vt
from velox_tpu.io.table import Table as RefTable
from velox_tpu.sql import run_sql as ref_run_sql
from velox_tpu_torch.sql import run_sql
from velox_tpu_torch.testing import table_from_numpy

TILES = (4, 64, 1024)

# t(id, k, v): k = 1, NULL, 2, NULL, 1, 2 (raw 1 and 2 under the NULLs);
# v = 5, 0, 3, 9, NULL, 1 (raw 7 under the NULL)
_T = {
    "id": np.arange(6, dtype=np.int64),
    "k": np.array([1, 1, 2, 2, 1, 2], dtype=np.int64),
    "v": np.array([5, 0, 3, 9, 7, 1], dtype=np.int64),
}
_T_VALID = {
    "k": np.array([1, 0, 1, 0, 1, 1], dtype=bool),
    "v": np.array([1, 1, 1, 1, 0, 1], dtype=bool),
}

# s(id, name, x): a string partition key with NULLs (codes 1 and 2 under
# them) and an all-NULL key a
_S_NAMES = ["", "ant", "bee", "cat"]
_S = {
    "id": np.arange(7, dtype=np.int64),
    "name": np.array([1, 2, 3, 1, 2, 2, 3], dtype=np.int32),
    "x": np.array([4, 4, 1, 2, 3, 9, 0], dtype=np.int64),
    "a": np.array([3, 1, 2, 3, 1, 2, 1], dtype=np.int64),
}
_S_VALID = {
    "name": np.array([1, 0, 1, 1, 0, 1, 1], dtype=bool),
    "a": np.zeros(7, dtype=bool),
}


def _tables(which):
    if which == "t":
        ref = RefTable(
            vt.RowType(["id", "k", "v"], [vt.BIGINT] * 3), dict(_T), {}, dict(_T_VALID)
        )
        port = table_from_numpy(["id", "k", "v"], ["BIGINT"] * 3, _T, validities=_T_VALID)
        return ref, port
    names = ["id", "name", "x", "a"]
    types = ["BIGINT", "VARCHAR", "BIGINT", "BIGINT"]
    port = table_from_numpy(names, types, _S, {"name": _S_NAMES}, _S_VALID)
    ref = RefTable(
        vt.RowType(names, [vt.BIGINT, vt.VARCHAR, vt.BIGINT, vt.BIGINT]),
        dict(_S),
        {"name": vt.StringTable.from_values(_S_NAMES)},
        dict(_S_VALID),
    )
    return ref, port


# name: (table, window expression, expected rows by id, the JAX package's
# rows at tile_rows 1024 where they are known to be wrong)
CASES = {
    "row_number_null_partition": (
        "t", "row_number() over (partition by k order by id)",
        [1, 1, 1, 2, 2, 2], [1, 2, 1, 2, 3, 3],
    ),
    "rank_null_order_default_last": (
        "t", "rank() over (order by v)", [4, 1, 3, 5, 6, 2], [4, 1, 3, 6, 5, 2],
    ),
    "rank_null_order_nulls_first": (
        "t", "rank() over (order by v nulls first)", [5, 2, 4, 6, 1, 3], [4, 1, 3, 6, 5, 2],
    ),
    "rank_desc_keeps_nulls_last": (
        "t", "rank() over (order by v desc)", [2, 5, 3, 1, 6, 4], None,
    ),
    "rank_desc_nulls_first": (
        "t", "rank() over (order by v desc nulls first)", [3, 6, 4, 2, 1, 5], None,
    ),
    "two_keys_partition_and_order": (
        "t", "row_number() over (partition by k order by v desc, id)",
        [1, 2, 1, 1, 2, 2], None,
    ),
    "null_peers_share_running_sum": (
        "t", "sum(id) over (order by k)", [4, 15, 11, 15, 4, 11], None,
    ),
    "range_frame_over_null_order_key": (
        "t", "count(v) over (order by k range between 1 preceding and current row)",
        [1, 2, 3, 2, 1, 3], None,
    ),
    "dense_rank_null_partition_key": (
        "t", "dense_rank() over (partition by k order by v)", [1, 1, 2, 2, 2, 1], None,
    ),
    "string_partition_key": (
        "s", "row_number() over (partition by name order by x, id)",
        [2, 2, 2, 1, 1, 1, 1], None,
    ),
    "string_order_key_nulls_first": (
        "s", "rank() over (order by name nulls first)", [3, 1, 6, 3, 1, 5, 6], None,
    ),
    "all_null_partition_key": (
        "s", "row_number() over (partition by a order by x, id)",
        [5, 6, 2, 3, 4, 7, 1], None,
    ),
    "all_null_order_key": (
        "s", "rank() over (partition by name order by a)", [1, 1, 1, 1, 1, 1, 1], None,
    ),
}


def _by_id(table, col):
    ids = np.asarray(table.columns["id"])
    return [int(x) for x in np.asarray(table.columns[col])[np.argsort(ids)]]


@pytest.mark.parametrize("tile_rows", TILES)
@pytest.mark.parametrize("name", list(CASES))
def test_window_null_keys_give_expected_rows(name, tile_rows):
    which, expr, expected, _ = CASES[name]
    _, port = _tables(which)
    out = run_sql(f"select id, {expr} as w from {which}", {which: port}, tile_rows=tile_rows, device="cpu")
    assert _by_id(out, "w") == expected


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[3] is not None])
def test_reference_rows_known_wrong(name):
    """The JAX package reads the raw values under NULL keys: its rows for
    these texts are the known-wrong ones (ROADMAP Queue 3)."""
    which, expr, expected, ref_wrong = CASES[name]
    ref, _ = _tables(which)
    out = ref_run_sql(f"select id, {expr} as w from {which}", {which: ref}, tile_rows=1024)
    got = _by_id(out, "w")
    assert got == ref_wrong and got != expected


def test_chunk_cut_puts_every_null_key_in_one_partition():
    """At tile_rows 4 the six rows run in passes of whole partitions; the
    NULL partition (raw values 1 and 2 under it) is one of them."""
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.sql import plan_sql

    _, port = _tables("t")
    plan = plan_sql("select id, row_number() over (partition by k order by id) as w from t", {"t": port})
    ex = LocalExecutor(plan, tile_rows=4, device="cpu")
    out = ex.run()
    assert _by_id(out, "w") == [1, 1, 1, 2, 2, 2]
    assert sorted(rows for _, rows in ex.window_chunks) == [2, 4]
