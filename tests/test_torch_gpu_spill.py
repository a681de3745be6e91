"""The memory / spill slice on the card: ``__grace_hash`` on CUDA int64
lanes against the host partitioner (``splitmix64_np``) on 2^22 keys, and the
spill paths (the carry's fallback to the spilling host merge, the external
sort, the window spill, the Grace join) on CUDA against the same plans on
the CPU without a budget.  Skipped where there is no CUDA device.  The
card's machine has no JAX, and ``tests/conftest.py`` imports it, so run with
``python -m pytest tests/test_torch_gpu_spill.py -m gpu --noconftest -q``.

Integers exact; DOUBLE rtol 1e-9."""

import numpy as np
import pytest
import torch

from velox_tpu_torch.config import DEFAULT_CONFIG
from velox_tpu_torch.exec.grace import grace_hash, splitmix64_np
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.utils import testvalue

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def test_grace_hash_on_cuda(cuda):
    rng = np.random.default_rng(1)
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 1 << 22, dtype=np.int64)
    keys[:3] = [np.iinfo(np.int64).min, -1, np.iinfo(np.int64).max]
    for salt in (1, 0xFFFFFFFF):
        dev = grace_hash(torch.from_numpy(keys).to(cuda), salt).cpu().numpy()
        np.testing.assert_array_equal(dev, splitmix64_np(keys, salt))


def _frame(table, keys):
    return table.to_pandas().sort_values(keys).reset_index(drop=True)


def _same(got, want, keys):
    import pandas as pd

    pd.testing.assert_frame_equal(_frame(got, keys), _frame(want, keys), check_dtype=False,
                                  rtol=1e-9)


def _hits(points, run):
    hits = {p: [] for p in points}
    for p in points:
        testvalue.register(p, hits[p].append)
    try:
        out = run()
    finally:
        for p in points:
            testvalue.unregister(p)
    return out, {p: len(h) for p, h in hits.items()}


def test_spill_paths_on_cuda(cuda):
    rng = np.random.default_rng(2)
    n = 1 << 18
    t = table_from_numpy(
        ["k", "o", "v", "d"], ["BIGINT", "BIGINT", "BIGINT", "DOUBLE"],
        {"k": rng.integers(0, 1 << 16, n), "o": rng.permutation(n).astype(np.int64),
         "v": rng.integers(-100, 100, n), "d": rng.random(n)},
    )
    build = table_from_numpy(["bk", "w"], ["BIGINT", "BIGINT"],
                             {"bk": np.arange(1 << 16), "w": rng.integers(0, 9, 1 << 16)})
    agg = PlanBuilder().table_scan(t).aggregation(["k"], ["sum(v) as s", "count(*) as c"]).build()
    sort = PlanBuilder().table_scan(t).orderby(["d desc", "o"]).build()
    window = (PlanBuilder().table_scan(t)
              .window(["k"], ["o"], ["row_number() as rn", "sum(d) as sd"]).build())
    join = (PlanBuilder().table_scan(t)
            .hash_join(PlanBuilder().table_scan(build).build(), ["k"], ["bk"],
                       output=["k", "o", "w"]).build())
    cases = [
        (agg, ["k"], DEFAULT_CONFIG.copy(query_memory_limit_bytes=1 << 20,
                                         spill_bytes_threshold=1 << 16),
         ["LocalExecutor::carryMemoryFallback", "Spiller::spill"]),
        (sort, ["d", "o"], DEFAULT_CONFIG.copy(spill_bytes_threshold=1 << 20),
         ["LocalExecutor::sortSpill"]),
        (window, ["k", "o"], DEFAULT_CONFIG.copy(spill_bytes_threshold=1 << 20),
         ["LocalExecutor::windowSpill"]),
        (join, ["k", "o"], DEFAULT_CONFIG.copy(query_memory_limit_bytes=1 << 18),
         ["LocalExecutor::graceJoin"]),
    ]
    for plan, keys, config, points in cases:
        want = LocalExecutor(plan, tile_rows=1 << 16, device="cpu").run()
        got, hits = _hits(points, lambda: LocalExecutor(plan, tile_rows=1 << 16, config=config,
                                                        device=cuda).run())
        assert all(hits.values()), hits
        _same(got, want, keys)
