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
