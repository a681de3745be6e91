"""A host table's page-locked tiles, kept across the scans that read them
(``velox_tpu_torch/io/table.py``), through the CPU staging seam
(``tests/torch_staging_helpers.py``).

A second executor over one host table, or over a ``select`` view of it,
stages nothing and returns the rows of the first and of a scan with no
staging at all; another column array, capacity or narrowed dtype misses; a
short last tile's padding reads zero; the residency upload keeps nothing;
and a refused page-locked block stages the tile for one scan.  Imports
nothing of the JAX package."""

import numpy as np
import pytest
import torch

from torch_staging_helpers import plain_staging
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy

N_ORDERS, N_LINES = 3000, 20000
TILE_ROWS = 1 << 10  # three orders tiles, the last one short


def host_tables():
    rng = np.random.default_rng(17)
    orders = table_from_numpy(
        ["o_orderkey", "o_custkey", "o_orderdate", "o_priority"],
        ["BIGINT", "BIGINT", "DATE", "BIGINT"],
        {"o_orderkey": np.arange(N_ORDERS, dtype=np.int64),
         "o_custkey": rng.integers(0, 100_000, N_ORDERS),
         "o_orderdate": rng.integers(8000, 10_000, N_ORDERS).astype(np.int32),
         "o_priority": rng.integers(0, 5, N_ORDERS)},
        validities={"o_priority": rng.random(N_ORDERS) < 0.9},
    )
    lineitem = table_from_numpy(
        ["l_orderkey", "l_price"], ["BIGINT", "BIGINT"],
        {"l_orderkey": rng.integers(0, N_ORDERS, N_LINES),
         "l_price": rng.integers(1, 10_000, N_LINES)},
    )
    return orders, lineitem


def q3_shaped(orders, lineitem):
    """Revenue by order and priority of the orders before a date, top 20:
    the build side a filtered scan of the host ``orders``."""
    build = PlanBuilder().table_scan(orders, filter="o_orderdate < date '1994-06-01'")
    return (
        PlanBuilder()
        .table_scan(lineitem, filter="l_price > 100")
        .hash_join(build, ["l_orderkey"], ["o_orderkey"],
                   output=["l_orderkey", "l_price", "o_priority", "o_custkey"])
        .aggregation(["l_orderkey", "o_priority", "o_custkey"], ["sum(l_price) as revenue"])
        .topn(["revenue desc", "l_orderkey"], 20)
        .build()
    )


def rows_of(table):
    cols = []
    for n in table.schema.names:
        values = np.asarray(table.columns[n]).tolist()
        valid = table.validities.get(n)
        if valid is not None:
            values = [v if ok else None for v, ok in zip(values, np.asarray(valid).tolist())]
        cols.append(values)
    return list(zip(*cols))


def run(plan):
    return rows_of(LocalExecutor(plan, tile_rows=TILE_ROWS, device="cpu").run())


def kept_blocks(table):
    """{key: id of the kept tensor}: which blocks a table keeps."""
    return {k: id(t) for k, (_, t) in table._kept.items()}


@pytest.mark.parametrize("second", ["table", "view"])
def test_a_second_executor_reads_the_kept_tiles(monkeypatch, second):
    orders, lineitem = host_tables()
    want = run(q3_shaped(orders, lineitem))  # no staging
    assert len(want) == 20
    blocks = plain_staging(monkeypatch)
    cold = run(q3_shaped(orders, lineitem))
    staged = len(blocks)
    # orders: 3 tiles of 4 columns and a validity; lineitem: 20 tiles of 2
    assert staged == 3 * 5 + 20 * 2
    assert orders.kept_bytes() == 3 * TILE_ROWS * (2 + 4 + 2 + 1 + 1)
    kept = kept_blocks(orders)
    over = orders if second == "table" else orders.select(orders.schema.names)
    warm = run(q3_shaped(over, lineitem.select(["l_orderkey", "l_price"])))
    assert cold == warm == want
    assert len(blocks) == staged  # nothing written the second time
    assert kept_blocks(orders) == kept and over._kept is orders._kept


def test_a_kept_tile_equals_a_tile_staged_afresh(monkeypatch):
    orders, _ = host_tables()
    plain_staging(monkeypatch)
    fresh = [orders.tile(i, TILE_ROWS, "cpu") for i in range(3)]
    for scan in range(2):  # cold, then warm
        for got, want in zip(orders.tiles(TILE_ROWS, "cpu"), fresh):
            for g, w in zip(got.columns, want.columns):
                assert g.data.dtype == w.data.dtype and torch.equal(g.data, w.data)
                assert (g.validity is None) == (w.validity is None)
                if w.validity is not None:
                    assert torch.equal(g.validity, w.validity)


@pytest.mark.parametrize("change", ["array", "capacity", "dtype"])
def test_another_array_capacity_or_dtype_misses(monkeypatch, change):
    orders, _ = host_tables()
    blocks = plain_staging(monkeypatch)
    list(orders.tiles(TILE_ROWS, "cpu"))
    kept, n_blocks = kept_blocks(orders), len(blocks)
    view, tile_rows = orders.select(orders.schema.names), TILE_ROWS
    if change == "array":
        view.columns["o_custkey"] = orders.columns["o_custkey"].copy()
    elif change == "capacity":
        tile_rows = TILE_ROWS * 2
    else:  # wider bounds: o_priority ships as int16, not int8
        view._bounds["o_priority"] = (0, 1000)
    tiles = list(view.tiles(tile_rows, "cpu"))
    new = {k: v for k, v in kept_blocks(orders).items() if k not in kept}
    assert {k: kept_blocks(orders)[k] for k in kept} == kept  # the old ones stay
    if change == "capacity":
        assert len(new) == 2 * 5 and len(blocks) == n_blocks + 2 * 5
    else:
        want_dtype = np.dtype(np.int32 if change == "array" else np.int16)
        # one column's values in each of the 3 tiles
        assert len(new) == 3 and {k[3] for k in new} == {want_dtype}
        assert all(v.shape == (TILE_ROWS,) for _, v in
                   (orders._kept[k] for k in new))
    for i, tile in enumerate(tiles):
        want = view.tile(i, tile_rows, "cpu")
        for g, w in zip(tile.columns, want.columns):
            assert torch.equal(g.data, w.data)


def test_a_short_last_tile_pads_with_zeros(monkeypatch):
    orders, _ = host_tables()
    plain_staging(monkeypatch)  # blocks start as 0x55 bytes
    n_last = N_ORDERS - 2 * TILE_ROWS
    for scan in range(2):
        last = list(orders.tiles(TILE_ROWS, "cpu"))[-1]
        assert int(last.length) == n_last and last.capacity == TILE_ROWS
        for name, col in zip(orders.schema.names, last.columns):
            assert col.data.shape[0] == TILE_ROWS
            assert not col.data[n_last:].any(), name
            np.testing.assert_array_equal(
                col.data[:n_last].numpy(), orders.columns[name][2 * TILE_ROWS:], name)
        validity = last.column("o_priority").validity
        assert not validity[n_last:].any()
        np.testing.assert_array_equal(validity[:n_last].numpy(),
                                      orders.validities["o_priority"][2 * TILE_ROWS:])


def test_device_tiles_and_tile_keep_nothing(monkeypatch):
    orders, _ = host_tables()
    blocks = plain_staging(monkeypatch)
    resident = orders.device_tiles(TILE_ROWS, "cpu")
    one = orders.tile(2, TILE_ROWS, "cpu")
    assert len(resident) == 3 and int(one.length) == N_ORDERS - 2 * TILE_ROWS
    assert len(blocks) == 4 * 5 and orders._kept == {} and orders.kept_bytes() == 0
    list(orders.tiles(TILE_ROWS, "cpu"))  # the streaming scan keeps
    assert len(orders._kept) == 3 * 5


def test_a_refused_block_stages_the_tile_for_one_scan(monkeypatch):
    orders, lineitem = host_tables()
    want = run(q3_shaped(orders, lineitem))
    calls = []

    def every_other(shape, np_dtype):  # the kept block refused, the fresh one not
        calls.append(shape)
        return len(calls) % 2 == 1

    blocks = plain_staging(monkeypatch, refuse=every_other)
    assert run(q3_shaped(orders, lineitem)) == run(q3_shaped(orders, lineitem)) == want
    assert orders._kept == {} and lineitem._kept == {}
    # each block refused once, then allocated for its scan alone
    assert len(calls) == 2 * len(blocks) and len(blocks) >= 2 * (3 * 5 + 20 * 2)
