"""The port's row exchange on 4 gloo ranks on the CPU, against the JAX
package's on 4 of the conftest's virtual devices.

Mirrors the exchange tests of tests/test_distributed.py (the bucketize
round trip, hash64, the skew-aware bucket capacity).  The exchange functions are held to the JAX package's bit for bit
on seeded numpy input (padding rows, counts and dropped rows included).
The world itself is checked in test_torch_distributed_world.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_world_helpers import RANKS, ref_mesh, world_fixture
from velox_tpu.dtypes import BIGINT as REF_BIGINT, RowType as RefRowType
from velox_tpu.expr.parser import parse_expr as ref_parse_expr
from velox_tpu.parallel import exchange as ref_exchange
from velox_tpu.parallel.distributed import distributed_grouped_sum as ref_grouped_sum
from velox_tpu_torch.parallel.exchange import (
    bucketize,
    hash64,
    partition_destinations,
)

world = world_fixture()
TASKS = "velox_tpu_torch.testing.dist_tasks"


# ---------------------------------------------------------------------------
# the exchange functions, bit for bit


def test_hash64_matches_reference_bits():
    rng = np.random.default_rng(1)
    keys = np.concatenate([rng.integers(-(1 << 63), (1 << 63) - 1, 4096, dtype=np.int64),
                           np.array([0, -1, 1, (1 << 63) - 1, -(1 << 63)], np.int64)])
    got = hash64(torch.as_tensor(keys)).numpy().view(np.uint64)
    want = np.asarray(ref_exchange.hash64(jnp.asarray(keys)))
    np.testing.assert_array_equal(got, want)
    small = rng.integers(-1000, 1000, 512).astype(np.int32)
    np.testing.assert_array_equal(hash64(torch.as_tensor(small)).numpy().view(np.uint64),
                                  np.asarray(ref_exchange.hash64(jnp.asarray(small))))


def test_hash64_determinism():
    a = hash64(torch.tensor([1, 2, 3]))
    b = hash64(torch.tensor([1, 2, 3]))
    assert torch.equal(a, b)
    assert len(torch.unique(hash64(torch.arange(1000)))) == 1000


@pytest.mark.parametrize("n", [1, 3, 4, 7, 8])
def test_partition_destinations_match_reference(n):
    """The UNSIGNED remainder of the 64-bit hash: half the hashes are at or
    above 2^63, where int64 ``%`` would give another rank."""
    keys = np.random.default_rng(n).integers(-(1 << 40), 1 << 40, 8192, dtype=np.int64)
    got = partition_destinations(torch.as_tensor(keys), n).numpy()
    want = np.asarray(ref_exchange.partition_destinations(jnp.asarray(keys), n))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() < n


@pytest.mark.parametrize("cap", [64, 16])
def test_bucketize_matches_reference(cap):
    """Every bucketed array (its padding rows too), the counts, the valid
    mask and the dropped rows (cap 16 is undersized) equal the JAX
    package's."""
    rng = np.random.default_rng(cap)
    keys = (np.arange(64) * 7 % 13).astype(np.int64)
    values = rng.integers(-50, 50, 64).astype(np.int64)
    flags = rng.random(64) < 0.5
    mask = np.arange(64) % 5 != 0
    dest = partition_destinations(torch.as_tensor(keys), 4)
    (bk, bv, bf), counts, valid, dropped = bucketize(
        [torch.as_tensor(keys), torch.as_tensor(values), torch.as_tensor(flags)],
        dest, torch.as_tensor(mask), 4, cap,
    )
    rdest = ref_exchange.partition_destinations(jnp.asarray(keys), 4)
    (rk, rv, rf), rcounts, rvalid, rdropped = ref_exchange.bucketize(
        [jnp.asarray(keys), jnp.asarray(values), jnp.asarray(flags)], rdest, jnp.asarray(mask), 4, cap
    )
    for a, b in ((bk, rk), (bv, rv), (bf, rf), (counts, rcounts), (valid, rvalid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(dropped) == int(rdropped) == (0 if cap == 64 else int(rdropped))
    if cap == 16:
        assert int(dropped) > 0


def test_exchange_bucketize_roundtrip():
    """Every live row lands in exactly one bucket, the bucket of its hash."""
    keys = torch.as_tensor(np.arange(64) * 7 % 13, dtype=torch.int64)
    values = torch.arange(64, dtype=torch.int64)
    mask = torch.as_tensor(np.arange(64) % 5 != 0)
    dest = partition_destinations(keys, 4)
    (_, bv), counts, _, dropped = bucketize([keys, values], dest, mask, 4, 64)
    assert int(dropped) == 0 and int(counts.sum()) == int(mask.sum())
    got = []
    for p in range(4):
        c = int(counts[p])
        got.extend(bv[p, :c].tolist())
        assert (dest[bv[p, :c]] == p).all()
    assert sorted(got) == torch.nonzero(mask).flatten().tolist()


def _ref_exchange(keys, vals, mask, cap):
    """The JAX package's exchange_rows over 4 devices: per device (vals,
    keys, live, dropped)."""
    mesh = ref_mesh()
    sh = NamedSharding(mesh, P("data"))

    def body(a, k, m):
        arrs, keys_r, live, dropped = ref_exchange.exchange_rows([a], k, m, "data", RANKS, cap)
        return arrs[0], keys_r, live, dropped.reshape(1)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("data"),) * 3, out_specs=P("data")))
    out = fn(*(jax.device_put(jnp.asarray(x), sh) for x in (vals, keys, mask)))
    out = [np.asarray(o) for o in out]
    per = len(out[0]) // RANKS
    return [[o[r * per : (r + 1) * per] for o in out[:3]] + [out[3][r : r + 1]]
            for r in range(RANKS)]


def _skewed(seed, per_dev=64):
    rng = np.random.default_rng(seed)
    n = RANKS * per_dev
    keys = np.where(rng.random(n) < 0.8, 7, rng.integers(0, 1000, n)).astype(np.int64)
    return keys, np.arange(n, dtype=np.int64), rng.random(n) < 0.9


def test_skew_aware_bucket_capacity(world):
    """Two-phase shuffle sizing over the ranks: the worst destination's
    receive total (an all-reduce) sizes the bucket, the exchange at that
    capacity loses no rows, and every rank received what the JAX package's
    device did, bit for bit."""
    keys, vals, mask = _skewed(3)
    got = world.run(f"{TASKS}:exchange_rows_task", keys, vals, mask)
    mesh = ref_mesh()
    sh = NamedSharding(mesh, P("data"))
    want_cap = ref_exchange.skew_aware_bucket_capacity(
        mesh, "data", jax.device_put(jnp.asarray(keys), sh), jax.device_put(jnp.asarray(mask), sh),
        RANKS,
    )
    cap = got["cap"]
    assert cap == want_cap
    hot = int(((keys == 7) & mask).sum())
    assert hot <= cap <= 2 * max(hot, 1)
    for port_rank, ref_rank in zip(got["ranks"], _ref_exchange(keys, vals, mask, cap)):
        for a, b in zip(port_rank, ref_rank):
            np.testing.assert_array_equal(a, b)
    received = np.concatenate([r[0][r[2]] for r in got["ranks"]])
    assert sorted(received.tolist()) == sorted(vals[mask].tolist())
    assert all(int(r[3][0]) == 0 for r in got["ranks"])


def test_exchange_rows_undersized_bucket_agrees_on_dropped(world):
    """An undersized bucket drops rows on the hot rank only; the dropped
    count every rank returns is the global total, as the JAX package's psum."""
    keys, vals, mask = _skewed(4)
    got = world.run(f"{TASKS}:exchange_rows_task", keys, vals, mask, 16)
    want = _ref_exchange(keys, vals, mask, 16)
    dropped = {int(r[3][0]) for r in got["ranks"]}
    assert dropped == {int(want[0][3][0])} and dropped != {0}
    for port_rank, ref_rank in zip(got["ranks"], want):
        for a, b in zip(port_rank, ref_rank):
            np.testing.assert_array_equal(a, b)


def test_distributed_grouped_sum_matches_reference(world):
    rng = np.random.default_rng(8)
    n, groups = RANKS * 256, 16
    x = rng.integers(0, 40, n).astype(np.int64)
    keys = rng.integers(0, groups, n).astype(np.int32)
    got = world.run(f"{TASKS}:grouped_sum_task", x, keys, groups)
    schema = RefRowType(["x"], [REF_BIGINT])
    mesh = ref_mesh()
    step = ref_grouped_sum(mesh, ref_parse_expr("x > 10", schema), ref_parse_expr("x * 2", schema),
                           schema, groups)
    sh = NamedSharding(mesh, P("data"))
    want = np.asarray(step([jax.device_put(jnp.asarray(x), sh)], jax.device_put(jnp.asarray(keys), sh)))
    for r in range(RANKS):
        np.testing.assert_array_equal(got[r], want[r])
    total = np.zeros(groups, np.int64)
    np.add.at(total, keys[x > 10], 2 * x[x > 10])
    np.testing.assert_array_equal(np.sum(got, axis=0), total)
