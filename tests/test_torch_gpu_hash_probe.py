"""K5, the hashed probe of a unique-key join (``csrc/hash_probe.cu``), against
its plain version on the card, and the joins that take it on the main path.

These build ``velox_tpu_torch/csrc`` with nvcc and launch on a CUDA device, so
they are skipped where there is none (run them on a GPU machine with
``python -m pytest tests/test_torch_gpu_hash_probe.py -m gpu --noconftest``).
Slot ids are compared exactly: the build keys are unique, so a key has one
slot whatever order the build's atomics took."""

import numpy as np
import pytest
import torch

from velox_tpu_torch.ops import hash_probe as k5

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def order_keys(n):
    """TPC-H's order keys: 8 values out of every 32, from 1."""
    i = np.arange(n, dtype=np.int64)
    return (i // 8) * 32 + i % 8 + 1


@pytest.mark.parametrize("key_dtype", [torch.int8, torch.int16, torch.int32, torch.int64])
@pytest.mark.parametrize("n_build", [0, 1, 90, (1 << 20) + 3])
def test_hash_probe_kernel(cuda, key_dtype, n_build):
    rng = np.random.default_rng(n_build)
    info = torch.iinfo(key_dtype)
    build = order_keys(n_build) + (info.min if key_dtype != torch.int64 else -(1 << 40))
    build = build[build <= info.max]
    keys = torch.from_numpy(build).to(cuda)
    lo, hi = (int(build[0]), int(build[-1])) if len(build) else (1, 0)
    table = k5.build_hash_table(keys, lo, hi)
    rows = (1 << 20) + 11
    probe = rng.integers(max(info.min, lo - 64), min(info.max, hi + 64) + 1, rows)
    probe = torch.from_numpy(probe).to(key_dtype).to(cuda)
    sel = torch.from_numpy(rng.random(rows) < 0.7).to(cuda)
    valid = torch.from_numpy(rng.random(rows) < 0.9).to(cuda)
    length = torch.tensor(rows - 5, dtype=torch.int32, device=cuda)
    walk = torch.zeros((1,), dtype=torch.int32, device=cuda)
    before = k5.hash_probe.launches
    got = k5.hash_probe(table, probe, length, sel, valid, walk=walk)
    want = k5.hash_probe_plain(table, probe, length, sel, valid)
    torch.cuda.synchronize()
    assert k5.hash_probe.launches == before + 1
    assert torch.equal(got, want)
    assert (want >= 0).any() == (len(build) > 0)
    assert 1 <= int(walk.item()) < 256 or len(build) == 0  # walks stay short
    bare = k5.hash_probe(table, probe, length)
    assert torch.equal(bare, k5.hash_probe_plain(table, probe, length))


def test_hash_probe_refuses_what_the_kernel_does_not_take(cuda):
    table = k5.build_hash_table(torch.arange(10, device=cuda), 0, 9)
    length = torch.tensor(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        k5.hash_probe(table, torch.zeros(4, device=cuda), length)
    with pytest.raises(ValueError):
        k5.hash_probe(table, torch.arange(8, device=cuda)[::2], length)


def _query(num, sf, tile_rows):
    from velox_tpu_torch.connectors.tpch.plans import build_query, load_query_tables
    from velox_tpu_torch.exec.runner import LocalExecutor

    tables = load_query_tables(num, sf)
    return tables, LocalExecutor(build_query(num, tables), tile_rows=tile_rows)  # default: CUDA


@pytest.mark.parametrize("num,tile_rows", [(12, 1 << 16), (13, 1 << 16), (3, 1 << 20), (3, 1 << 16)])
def test_joins_on_the_card_take_the_hashed_probe(cuda, num, tile_rows):
    """A join whose grouping reads no key order probes hashed, one launch a
    tile (Q12, Q13, Q3 in one tile); Q3 over several tiles groups presorted
    and keeps the merge.  The rows are the oracle's either way."""
    import pandas as pd

    from velox_tpu_torch.connectors.tpch.plans import ENGINE_OUTPUT_ORDER, oracle_result

    tables, ex = _query(num, 0.05, tile_rows)
    before = k5.hash_probe.launches
    got = ex.run().to_pandas().reset_index(drop=True)
    got = got[ENGINE_OUTPUT_ORDER[num]] if num in ENGINE_OUTPUT_ORDER else got
    tiles = ex.source_table.num_tiles(ex.capacity)
    hashed = not ex.agg_exec.presorted
    assert hashed == (num != 3 or tiles == 1)
    assert k5.hash_probe.launches - before == (tiles if hashed else 0)
    pd.testing.assert_frame_equal(
        got, oracle_result(num, tables).reset_index(drop=True), check_dtype=False, rtol=1e-9
    )
