"""Partitioned (shuffle) hash joins across ranks.

Counterpart of the JAX package's ``parallel/shuffle_join.py``.  Reference:
velox/exec/HashJoinBridge.h + core/PlanNode.h:1107 — the reference partitions
BOTH join sides by key hash (PartitionedOutput kPartitioned mode) so each
worker joins only its key range; small build sides broadcast instead
(kBroadcast).  The choice is made by build cardinality.

The build side is partitioned on the host by the SAME 64-bit mix the exchange
uses (``exchange.hash64``).  Every rank computes the same partitioning of the
same build Table and uploads only its own partition (the JAX package uploads
a stacked [n_devices, part_capacity] array sharded over the mesh): rank d
holds exactly the build rows with ``hash64(key) % n == d``.  Probe rows reach
their partition through ``exchange_rows``, then the standard sort-merge
probe (exec/joins.py) runs rank-locally.

Scope: INNER/LEFT/LEFT_SEMI/ANTI builds, unique-key or duplicate-key.  A
duplicate-key (N:M) build keeps its per-key runs (start, count) per partition —
hash partitioning sends every row of a key to the same rank, so the local
expansion probe (probe_spans / expand) sees the complete run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..exec.joins import HashJoinExec, JoinBuildError, _KEY_SENTINEL, _NormalizedKey
from ..io.table import Table
from ..plan.nodes import HashJoinNode, JoinType
from .exchange import hash64


def hash64_np(keys: np.ndarray) -> np.ndarray:
    """``exchange.hash64`` of host keys as uint64 (the same code on a CPU
    tensor, so host-partitioned build rows land on the rank their probes
    shuffle to)."""
    x = torch.from_numpy(np.ascontiguousarray(np.asarray(keys).astype(np.int64)))
    return hash64(x).numpy().view(np.uint64)


@dataclasses.dataclass
class ShuffleJoinState:
    """This rank's partition of a host-partitioned build side.

    ``keys`` / ``cols`` are this rank's [part_capacity] tensors (sentinel keys
    beyond ``count``); ``part_capacity`` is the power of two that holds the
    largest partition of any rank, as in the JAX package."""

    node: HashJoinNode
    keys: torch.Tensor  # [cap] int64, sentinel beyond count
    cols: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]  # [cap] payloads
    count: torch.Tensor  # 0-d int64: this rank's live prefix
    part_capacity: int
    normalizer: Optional[_NormalizedKey]
    build_tables: Dict[str, object]
    # duplicate-key (expansion) builds: per-slot run info, local indices
    expansion: bool = False
    run_start: Optional[torch.Tensor] = None  # [cap] int64
    run_count: Optional[torch.Tensor] = None  # [cap] int64
    # host-known (min, max) over ALL partitions' valid packed keys: a superset
    # range is valid per rank and enables the packed single-operand probe
    key_range: Optional[Tuple[int, int]] = None

    def local_exec(self, d_keys, d_cols, d_count, d_rs=None, d_rc=None) -> HashJoinExec:
        """The rank-local HashJoinExec over this rank's partition."""
        cap = self.part_capacity
        valid = torch.arange(cap, dtype=torch.int64, device=d_keys.device) < d_count
        keys = torch.where(valid, d_keys, torch.full_like(d_keys, _KEY_SENTINEL))
        return HashJoinExec(
            self.node,
            keys,
            dict(d_cols),
            cap,
            self.build_tables,
            self.normalizer,
            valid,
            expansion=self.expansion,
            run_start=d_rs,
            run_count=d_rc,
            key_range=self.key_range,
            # the exchange and the carries are sized to the probe batch's
            # capacity; the fused probe's output is build + probe rows long
            allow_fused=False,
        )


def partition_build(node: HashJoinNode, build_result: Table, mesh) -> ShuffleJoinState:
    """Partition an executed build-side Table by key hash and upload this
    rank's partition to ``mesh.device``.

    Raises JoinBuildError where the build cannot be partitioned (callers
    broadcast it instead): a join type other than INNER / LEFT / LEFT_SEMI /
    ANTI, a null-aware ANTI, or composite keys wider than one int64."""
    n = mesh.size
    key_names = list(node.right_keys)
    key_arrays = [np.asarray(build_result.columns[k]) for k in key_names]
    jt = node.join_type
    if jt not in (JoinType.INNER, JoinType.LEFT, JoinType.LEFT_SEMI, JoinType.ANTI):
        raise JoinBuildError(f"shuffle join does not support {jt}")
    if node.null_aware:
        # a NULL build key must empty EVERY partition's output — a global
        # property the per-partition probes cannot see; broadcast instead
        raise JoinBuildError("null-aware ANTI joins broadcast the build side")

    # NULL build keys never match (see HashJoinExec.build)
    keep = None
    for k in key_names:
        validity = build_result.validities.get(k)
        if validity is not None and not validity.all():
            keep = validity if keep is None else (keep & validity)
    if keep is not None:
        key_arrays = [a[keep] for a in key_arrays]

    if len(key_names) == 1:
        normalizer = None
        packed = key_arrays[0].astype(np.int64)
    else:
        normalizer = _NormalizedKey.fit(key_arrays)
        if normalizer.two_limb:
            raise JoinBuildError("composite keys wider than 62 bits broadcast the build side")
        packed = normalizer.pack_host(key_arrays)

    semi = jt in (JoinType.LEFT_SEMI, JoinType.ANTI)
    expansion = False
    if semi:
        packed = np.unique(packed)
        row_src = None
    else:
        order = np.argsort(packed, kind="stable")
        packed = packed[order]
        expansion = bool(len(packed) > 1 and (packed[1:] == packed[:-1]).any())
        row_src = np.flatnonzero(keep)[order] if keep is not None else order

    if not len(packed):
        key_range = None
    elif normalizer is None:
        key_range = (int(packed.min()), int(packed.max()))
    else:
        key_range = (0, int(packed.max()))  # packed multi-key values are non-negative
    dest = (hash64_np(packed) % np.uint64(n)).astype(np.int64)
    # stable partition: rows stay key-sorted within each partition (and every
    # row of a duplicate key lands on ONE rank with its run contiguous)
    part_order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=n)
    cap = 8
    while cap < max(int(counts.max()) if len(counts) else 1, 1):
        cap *= 2
    start = int(counts[: mesh.rank].sum())
    mine = part_order[start : start + int(counts[mesh.rank])]
    c = len(mine)

    def upload(arr: np.ndarray, fill) -> torch.Tensor:
        out = np.full((cap,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[:c] = arr
        return torch.as_tensor(out, device=mesh.device)

    keys_part = packed[mine]
    rs_d = rc_d = None
    if expansion:
        # this partition's run (start, count) in LOCAL slot indices: runs are
        # contiguous within a partition
        rs = np.zeros(c, dtype=np.int64)
        rc = np.zeros(c, dtype=np.int64)
        if c:
            boundary = np.ones(c, dtype=bool)
            boundary[1:] = keys_part[1:] != keys_part[:-1]
            starts_l = np.flatnonzero(boundary)
            lengths = np.diff(np.append(starts_l, c))
            rs[:] = np.repeat(starts_l, lengths)
            rc[:] = np.repeat(lengths, lengths)
        rs_d = upload(rs, 0)
        rc_d = upload(rc, 0)
    cols: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
    right_schema = node.right.output_schema
    if not semi:
        src = row_src[mine]
        for name in node.output_columns:
            if name in right_schema and name not in key_names:
                arr = np.asarray(build_result.columns[name])[src]
                validity = build_result.validities.get(name)
                gv = None if validity is None else upload(validity[src], False)
                cols[name] = (upload(arr, 0), gv)
    return ShuffleJoinState(
        node,
        upload(keys_part, _KEY_SENTINEL),
        cols,
        torch.tensor(c, dtype=torch.int64, device=mesh.device),
        cap,
        normalizer,
        dict(build_result.string_tables),
        expansion=expansion,
        run_start=rs_d,
        run_count=rc_d,
        key_range=key_range,
    )


def probe_pack(state: ShuffleJoinState, batch) -> torch.Tensor:
    """The probe rows' normalized int64 keys (for the exchange's destination
    hash).  Out-of-range / NULL multi-key probes pack to -1 — they hash
    somewhere consistent and can never equal a build key there (packed build
    keys are non-negative)."""
    cap = batch.capacity
    vals = []
    key_ok = torch.ones((cap,), dtype=torch.bool, device=batch.device)
    for k in state.node.left_keys:
        v, val = batch.column(k).decode(cap)
        vals.append(v)
        if val is not None:
            key_ok = key_ok & val
    if state.normalizer is None:
        return vals[0].to(torch.int64)
    packed, _ = state.normalizer.pack_device(vals, key_ok)
    return packed


def flatten_state(state: ShuffleJoinState):
    """(arrays, rebuild): this rank's partition tensors in one list + a
    function mapping them back to the rank-local HashJoinExec (the JAX
    package passes them as shard_map operands and rebuilds inside the trace;
    here the executor rebuilds once)."""
    arrays: List[torch.Tensor] = [state.keys, state.count]
    if state.expansion:
        arrays += [state.run_start, state.run_count]
    base = len(arrays)
    layout: List[Tuple[str, bool]] = []
    for name, (g, gv) in state.cols.items():
        arrays.append(g)
        layout.append((name, gv is not None))
        if gv is not None:
            arrays.append(gv)

    def rebuild(local_arrays) -> HashJoinExec:
        keys, count = local_arrays[0], local_arrays[1]
        rs = rc = None
        if state.expansion:
            rs, rc = local_arrays[2], local_arrays[3]
        cols = {}
        i = base
        for name, has_validity in layout:
            g = local_arrays[i]
            i += 1
            gv = None
            if has_validity:
                gv = local_arrays[i]
                i += 1
            cols[name] = (g, gv)
        return state.local_exec(keys, cols, count, rs, rc)

    return arrays, rebuild
