"""The files / encodings slice on the card: a SEQUENCE column of 2^24 rows
decoded on CUDA against ``repeat_interleave`` (values, run nulls, a gather),
a BIAS column against its widened deltas, and a Hive write and read of a
device query's result (TPC-H Q1 at SF 0.01, its rows against the CPU's).
Skipped where there is no CUDA device.  The card's machine has no JAX, and
``tests/conftest.py`` imports it, so run with ``python -m pytest
tests/test_torch_gpu_io.py -m gpu --noconftest -q``.

Integers exact; Q1's DOUBLE averages rtol 1e-9."""

import numpy as np
import pandas as pd
import pytest
import torch

import velox_tpu_torch as vtt
from velox_tpu_torch.vector.column import Column

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def test_sequence_decode_at_a_tile(cuda):
    cap = 1 << 24
    runs = 1 << 22
    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    cuts = torch.randperm(cap - 1, generator=gen, device=cuda)[: runs - 1].sort().values + 1
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=cuda), cuts,
                        torch.full((1,), cap, dtype=torch.int64, device=cuda)])
    lengths = (bounds[1:] - bounds[:-1]).to(torch.int32)
    vals = torch.randint(-(1 << 40), 1 << 40, (runs,), generator=gen, device=cuda)
    valid = torch.rand(runs, generator=gen, device=cuda) > 0.1
    col = Column.sequence(Column.flat(vals, vtt.BIGINT, valid), lengths, cap)
    values, validity = col.decode(cap)
    want = torch.repeat_interleave(vals, lengths.to(torch.int64))
    assert torch.equal(values, want)
    assert torch.equal(validity, torch.repeat_interleave(valid, lengths.to(torch.int64)))
    idx = torch.randint(0, cap, (1 << 20,), generator=gen, device=cuda)
    g_values, g_validity = col.gather(idx).decode(1 << 20)
    assert torch.equal(g_values, want[idx])
    deltas = torch.randint(-128, 128, (cap,), generator=gen, device=cuda).to(torch.int8)
    bias = Column.bias(1 << 40, deltas, vtt.BIGINT)
    assert torch.equal(bias.decode(cap)[0], deltas.to(torch.int64) + (1 << 40))


def test_hive_roundtrip_of_a_device_result(cuda, tmp_path):
    from velox_tpu_torch.connectors.hive import read_table
    from velox_tpu_torch.connectors.tpch import load_table
    from velox_tpu_torch.connectors.tpch.plans import build_q1
    from velox_tpu_torch.exec.runner import LocalExecutor, run_plan
    from velox_tpu_torch.plan import PlanBuilder

    cols = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount",
            "l_tax", "l_shipdate"]
    li = load_table("lineitem", 0.01, cols, cache_dir=None)
    root = str(tmp_path / "li")
    plan = (
        PlanBuilder().table_scan(li)
        .project([*cols, "year(l_shipdate) as l_shipyear"])
        .table_write(root, partition_by=["l_shipyear"]).build()
    )
    assert run_plan(plan, tile_rows=1 << 14).columns["rows"].tolist() == [li.num_rows]
    back = read_table(root).select(cols)
    assert back.num_rows == li.num_rows
    got = LocalExecutor(build_q1(back), tile_rows=1 << 14).run().to_pandas()
    want = LocalExecutor(build_q1(li), tile_rows=1 << 14, device="cpu").run().to_pandas()
    pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=1e-9)


@pytest.mark.parametrize("index", [0, 2])  # a full tile and the ragged last one
def test_host_table_tiles_on_the_card_equal_the_cpu_tiles(cuda, index):
    """``Table.tile`` on CUDA writes each numeric column (narrowed, padded,
    its validity too) once into page-locked memory; the tile equals the CPU
    tile, dtypes included, for a writeable and a read-only column, and a
    string column's codes keep their dictionary.  The streaming scan
    (``Table.tiles``) keeps its page-locked tile: a second scan uploads the
    same kept blocks, and its tile equals the CPU tile too."""
    from velox_tpu_torch.io.table import Table
    from velox_tpu_torch.vector.string_table import StringTable

    rng = np.random.default_rng(5 + index)
    n = 2 * 1024 + 300
    frozen = rng.integers(-(1 << 40), 1 << 40, n)
    frozen.flags.writeable = False
    strings = StringTable.from_values(["", "a", "bb", "ccc"])
    cols = {
        "small": rng.integers(-30000, 30000, n).astype(np.int64),
        "wide": frozen,
        "day": rng.integers(8000, 10000, n).astype(np.int32),
        "dbl": rng.normal(size=n),
        "flag": rng.random(n) < 0.5,
        "name": rng.integers(0, 4, n).astype(np.int32),
    }
    names = list(cols)
    types = [vtt.BIGINT, vtt.BIGINT, vtt.DATE, vtt.DOUBLE, vtt.BOOLEAN, vtt.VARCHAR]
    table = Table(vtt.RowType(names, types), cols, {"name": strings},
                  {"small": rng.random(n) < 0.9, "dbl": rng.random(n) < 0.8})
    want = table.tile(index, 1024, device="cpu")
    scans = [table.tile(index, 1024, device=cuda)]
    assert table.kept_bytes() == 0
    kept = None
    for _ in range(2):  # cold, then from the kept blocks
        scans.append(list(table.tiles(1024, device=cuda))[index])
        blocks = {k: t.data_ptr() for k, (_, t) in table._kept.items()}
        assert kept in (None, blocks) and all(t.is_pinned() for _, t in table._kept.values())
        kept = blocks
    assert table.kept_bytes() == table.num_tiles(1024) * table.tile_bytes(1024)
    torch.cuda.synchronize()
    for got in scans:
        assert (got.capacity, int(got.length), int(got.row_offset)) == (
            want.capacity, int(want.length), int(want.row_offset))
        for name in names:
            g, w = got.column(name), want.column(name)
            assert g.data.device.type == "cuda" and g.data.dtype == w.data.dtype, name
            assert torch.equal(g.data.cpu(), w.data), name
            assert (g.validity is None) == (w.validity is None), name
            if w.validity is not None:
                assert torch.equal(g.validity.cpu(), w.validity), name
        assert got.column("name").strings is strings
        assert got.column("small").data.dtype == torch.int16


@pytest.mark.parametrize("num", [3, 13])
def test_plans_over_kept_host_tiles_give_the_same_rows_each_time(cuda, num):
    """Q3 (two build sides, orders and customer) and Q13 (the orders build
    side under a NOT LIKE) at SF 0.05, three plans over the same host tables,
    as a power stream runs them: the first executor stages and keeps the
    host tiles, the next two upload from the kept blocks; the rows are the
    oracle's every time."""
    from velox_tpu_torch.connectors.tpch.plans import build_query, load_query_tables, oracle_result
    from velox_tpu_torch.exec.runner import LocalExecutor

    tables = load_query_tables(num, 0.05)
    want = oracle_result(num, tables).reset_index(drop=True)
    kept = []
    for _ in range(3):
        ex = LocalExecutor(build_query(num, tables), tile_rows=1 << 14)  # default: CUDA
        got = ex.run().to_pandas()[list(want.columns)].reset_index(drop=True)
        pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=1e-9)
        kept.append({name: t.kept_bytes() for name, t in tables.items()})
    assert all(kept[0].values()) and kept == [kept[0]] * 3
