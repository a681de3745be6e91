"""Memory pools and host fetches of the port against the JAX package's."""

import numpy as np
import torch

import jax.numpy as jnp

from velox_tpu.exec.memory import MemoryPool as RefPool, MemoryPoolError as RefPoolError
from velox_tpu.utils import transfer as ref_transfer
from velox_tpu_torch.exec.memory import MemoryPool, MemoryPoolError, batch_bytes
from velox_tpu_torch.utils import transfer


def _script(pool_cls, err_cls):
    root = pool_cls("root", limit=1000)
    a, b = root.add_child("a", limit=600), root.add_child("b")
    log = []
    a.reserve(500)
    b.reserve(300)
    log.append((root.reserved, a.reserved, b.reserved, root.peak))
    try:
        a.reserve(200)
    except err_cls:
        log.append("a over its own limit")
    try:
        b.reserve(300)
    except err_cls:
        log.append("b over the root's limit")
    b.add_reclaimer(lambda target: (b.release(300), 300)[1])
    b.reserve(300)  # the reclaimer frees b's first reservation
    log.append((root.reserved, a.reserved, b.reserved))
    a.release(100)
    b.detach()
    log.append((root.reserved, len(root.children)))
    return log


def test_pool_accounting_matches_reference():
    assert _script(MemoryPool, MemoryPoolError) == _script(RefPool, RefPoolError)


def test_batch_bytes_counts_every_tensor():
    import velox_tpu_torch as vtt
    from velox_tpu_torch.vector.column import Batch

    schema = vtt.RowType(["a", "b"], [vtt.BIGINT, vtt.BIGINT])
    batch = Batch.from_numpy(
        schema,
        [np.arange(10, dtype=np.int8), np.arange(10, dtype=np.int64)],
        [None, np.ones(10, bool)],
        capacity=16,
        device="cpu",
    )
    assert batch_bytes([batch]) == 16 * 1 + 16 * 8 + 16
    sel = batch.with_selection(torch.ones(16, dtype=torch.bool))
    assert batch_bytes([batch, sel]) == 2 * (16 + 128 + 16) + 16


def test_fetch_tree_and_buckets():
    tree = ((torch.arange(3), [torch.ones(2, dtype=torch.bool)]), {"k": torch.tensor(5)}, "s", 7)
    ref_tree = ((jnp.arange(3), [jnp.ones(2, dtype=bool)]), {"k": jnp.asarray(5)}, "s", 7)
    got, want = transfer.fetch_tree(tree), ref_transfer.fetch_tree(ref_tree)
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[0][1][0], want[0][1][0])
    assert int(got[1]["k"]) == int(want[1]["k"]) and got[2:] == ("s", 7)
    assert isinstance(got[0][0], np.ndarray)
    for n in (0, 1, 2, 3, 1000, 1024, 1025):
        assert transfer.bucket_of(n) == ref_transfer.bucket_of(n)
