"""Distributed exchange: hash-partitioned shuffle as collectives between ranks.

Counterpart of the JAX package's ``parallel/exchange.py``.  Reference: the
reference's "communication backend" is the serialize -> OutputBufferManager ->
HTTP -> ExchangeSource pipeline (velox/exec/PartitionedOutput.h:139,
OutputBuffer.h:131, ExchangeSource.h:22, ExchangeClient.h:26).

Here rows stay in columnar tensors.  Each rank hash-partitions its rows into
fixed-capacity per-destination buckets, then one ``all_to_all_single`` with
equal splits (``Mesh.all_to_all``) moves every bucket to its destination; the
counts ride in the same message to mark the ragged valid region.  The JAX
package runs these functions inside ``shard_map`` and its collectives are
``lax.all_to_all`` / ``lax.psum``; here every rank calls them in the same
order (SPMD over processes).

The hash is uint64 arithmetic on int64 lanes (``ops/u64.py``): multiplies wrap
to the same bits, but ``>>`` on int64 is arithmetic, so the shifts go through
``srl64``, and ``hash % n`` is the UNSIGNED remainder (``umod64``).  Both must
be bit-identical to the JAX package's ``jnp.uint64`` code, or a row lands on
another rank than there and every bucket size after it differs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.u64 import signed64, srl64

# Knuth multiplicative constant (splitmix64's increment)
_HASH_MULT = 0x9E3779B97F4A7C15


def hash64(keys: torch.Tensor) -> torch.Tensor:
    """Vectorized 64-bit mix (splitmix-style finalizer) of integer keys: the
    bits of the uint64 result on int64 lanes.  The one definition of this mix
    in the port: the sketches' register hash, the Hive connector's bucketing
    and the shuffle join's host partitioning (``shuffle_join.hash64_np``) all
    call it."""
    x = keys.to(torch.int64) * signed64(_HASH_MULT)
    x = x ^ srl64(x, 31)
    x = x * signed64(0xBF58476D1CE4E5B9)
    return x ^ srl64(x, 27)


def umod64(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h mod n`` of the uint64 value whose bits the int64 lane ``h`` holds
    (torch's ``%`` on int64 takes a negative lane as negative: for h < 0 the
    unsigned value is h + 2^64)."""
    r = torch.remainder(h, n)
    return torch.where(h < 0, torch.remainder(r + (1 << 64) % n, n), r)


def partition_destinations(keys: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """row -> destination rank (reference: HashPartitionFunction)."""
    return umod64(hash64(keys), num_partitions).to(torch.int32)


def destination_counts(dest: torch.Tensor, mask: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """[P] int64: the live rows bound for each destination."""
    P = num_partitions
    dest_eff = torch.where(mask, dest.to(torch.int64), torch.full_like(dest, P, dtype=torch.int64))
    return torch.bincount(dest_eff, minlength=P + 1)[:P]


def bucketize(
    arrays: Sequence[torch.Tensor],
    dest: torch.Tensor,
    mask: torch.Tensor,
    num_partitions: int,
    bucket_capacity: int,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack rows into per-destination buckets.

    Returns (bucketed arrays, counts, valid, dropped): each array becomes
    [P, bucket_capacity, ...] (rows beyond counts[p] are padding); ``dropped``
    is the number of live rows that did NOT fit their destination bucket.  A
    nonzero ``dropped`` means the capacity was undersized — callers MUST
    surface it (abort or re-run at a larger bucket) rather than clip silently
    (the reference's analog is OutputBuffer backpressure,
    velox/exec/OutputBuffer.h:131, which blocks instead of dropping).  One
    stable sort by destination and one gather an array, as in the JAX
    package; the padding rows hold the same values as there."""
    n = dest.shape[0]
    P = num_partitions
    # dead rows go to a virtual partition P so they never land in a real bucket
    dest_eff = torch.where(mask, dest.to(torch.int64), torch.full_like(dest, P, dtype=torch.int64))
    order = torch.argsort(dest_eff, stable=True)
    raw_counts = destination_counts(dest, mask, P)
    dropped = (raw_counts - bucket_capacity).clamp(min=0).sum()
    counts = raw_counts.clamp(max=bucket_capacity).to(torch.int32)
    starts = torch.cumsum(raw_counts, 0) - raw_counts
    # idx[p, i]: position in the sorted order of the i-th row for partition p
    offs = torch.arange(bucket_capacity, dtype=torch.int64, device=dest.device)[None, :]
    idx = (starts[:, None] + offs).clamp(0, max(n - 1, 0))
    valid = offs < counts[:, None]
    src = order.index_select(0, idx.reshape(-1))
    out = [
        arr.index_select(0, src).reshape((P, bucket_capacity) + tuple(arr.shape[1:]))
        for arr in arrays
    ]
    return out, counts, valid, dropped


def start_all_to_all_exchange(bucketed: Sequence[torch.Tensor], counts: torch.Tensor, mesh):
    """Send bucket p to rank p without waiting (``async_op``); ``.wait()``
    on the result gives what ``all_to_all_exchange`` returns.  The counts and
    every array travel as one byte message (one collective)."""
    from .distributed import pack_bytes, unpack_bytes

    buf, layout = pack_bytes(list(bucketed) + [counts], dim=1)
    pending = mesh.all_to_all(buf, async_op=True)

    class _Received:
        def wait(self):
            parts = unpack_bytes(pending.wait(), layout, dim=1)
            return parts[:-1], parts[-1]

    return _Received()


def all_to_all_exchange(bucketed: Sequence[torch.Tensor], counts: torch.Tensor, mesh):
    """Move bucket p to rank p.

    Input per rank: arrays [P, cap, ...] + counts [P].  Output per rank:
    arrays [P, cap, ...] where dim 0 indexes the *source* rank, + the received
    counts [P].  Every rank must pass the same shapes (equal splits): the
    capacities are decided on the host from values all ranks agree on."""
    return start_all_to_all_exchange(bucketed, counts, mesh).wait()


def skew_probe(keys: torch.Tensor, mask: torch.Tensor, mesh, num_partitions: int):
    """Phase 1 of the skew-aware shuffle: per-destination RECEIVE totals.

    Returns [P] — for each destination p, the number of rows all ranks will
    send it (an all-reduce, the JAX package's ``psum``)."""
    dest = partition_destinations(keys, num_partitions)
    return mesh.all_reduce(destination_counts(dest, mask, num_partitions), "sum")


def skew_aware_bucket_capacity(mesh, keys: torch.Tensor, mask: torch.Tensor,
                               num_partitions: int) -> int:
    """Host-level phase 1: run the probe and bucket the worst destination
    (a power of two, at least 8); every rank computes the same value."""
    worst = int(skew_probe(keys, mask, mesh, num_partitions).max())
    cap = 8
    while cap < max(worst, 1):
        cap *= 2
    return cap


def exchange_rows(
    arrays: Sequence[torch.Tensor],
    keys: torch.Tensor,
    mask: torch.Tensor,
    mesh,
    num_partitions: int,
    bucket_capacity: Optional[int] = None,
):
    """Full shuffle: partition by key hash, all-to-all, flatten received buckets.

    Returns (arrays [P*cap, ...] flattened over sources, keys, live-row mask,
    dropped): ``dropped`` counts live rows that exceeded their destination
    bucket on ANY rank — each rank sends its own count to every destination
    in the same message, so the received counts sum to the global total and
    every rank agrees (the JAX package's ``psum``) without a second
    collective.  After this call every row with a given key lives on rank
    hash(key) % num_partitions."""
    if bucket_capacity is None:
        bucket_capacity = keys.shape[0]
    P = num_partitions
    dest = partition_destinations(keys, P)
    bucketed, counts, _, dropped = bucketize(
        list(arrays) + [keys], dest, mask, P, bucket_capacity
    )
    received, recv_counts = all_to_all_exchange(
        bucketed + [dropped.reshape(1).expand(P)], counts, mesh
    )
    dropped = received.pop().sum()
    offs = torch.arange(bucket_capacity, dtype=torch.int32, device=keys.device)[None, :]
    live = (offs < recv_counts[:, None]).reshape(-1)
    flat = [r.reshape((P * bucket_capacity,) + tuple(r.shape[2:])) for r in received]
    return flat[:-1], flat[-1], live, dropped
