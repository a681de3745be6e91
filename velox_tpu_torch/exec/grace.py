"""Grace hash join: memory-bounded joins by key-hash partitioning.

Counterpart of the JAX package's ``exec/grace.py``.  Reference:
velox/exec/Spiller.h:29-39 (kHashJoinBuild / kHashJoinProbe spill kinds),
velox/exec/HashBuild.cpp spill partitioning, and docs/develop/spilling.rst —
when a hash-join build exceeds the memory budget, the reference spills build
AND probe rows partitioned by key hash and joins partition by partition,
recursively partitioning again the partitions that still do not fit.

Here the device never scatters rows into spill partitions.  Both sides
partition by the SAME salted splitmix64 key hash, each side where it lives:

* the build side is a host Table (it did not fit the budget: that is why we
  are here); numpy masks split it into P partition tables (``splitmix64_np``);
* the probe side stays a device pipeline; a FilterNode with the identical
  hash predicate (the registered function ``__grace_hash``, on int64 lanes
  through ``ops/u64.py``) is put above the probe subtree, so each pass drops
  the other partitions' rows on the device — the probe is scanned P times
  instead of spilled.

The two hashes must agree bit for bit, or rows vanish without an error:
torch has no unsigned shift (``>>`` on int64 is arithmetic), so the device
side shifts through ``srl64``, and both sides convert a key to int64 first.

Every equi-join type is partition-local under same-key-hash partitioning:
matches happen only inside a partition, a probe row belongs to exactly one
partition (LEFT / semi / anti null extension decided there), and the
unmatched build rows of a FULL join surface in their own partition's tail.
NULL keys ride partition 0 (they never match; the null-key rows of a FULL /
LEFT join come out of partition 0).

Recursion: an oversized partition enters this path again through the child
executor's own pool, with a new salt taken from the join's id and its level
(the number of partition filters already over its probe) — the analog of the reference's multi-level recursive spill
(Spiller::state().maxPartitions per level).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional

import numpy as np
import torch

from ..dtypes import BIGINT
from ..io.table import Table
from ..ops.u64 import signed64, srl64
from ..plan.nodes import FilterNode, HashJoinNode, PlanNode, ValuesNode

_MIX1 = 0x9E3779B97F4A7C15
_MIX2 = 0xBF58476D1CE4E5B9
_MIX3 = 0x94D049BB133111EB


def splitmix64_np(x: np.ndarray, salt: int) -> np.ndarray:
    """Host-side salted splitmix64 (must match ``__grace_hash`` bit for bit)."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) ^ np.uint64(salt)
        z = (z + np.uint64(_MIX1)) * np.uint64(_MIX2)
        z ^= z >> np.uint64(30)
        z *= np.uint64(_MIX3)
        z ^= z >> np.uint64(27)
    return z.astype(np.int64)


def grace_hash(a: torch.Tensor, salt) -> torch.Tensor:
    """``splitmix64_np`` on int64 lanes: wrapping add and multiply keep the
    low 64 bits, the right shifts are logical (``srl64``)."""
    z = a.to(torch.int64) ^ torch.as_tensor(salt, device=a.device).to(torch.int64)
    z = (z + signed64(_MIX1)) * signed64(_MIX2)
    z = z ^ srl64(z, 30)
    z = z * signed64(_MIX3)
    return z ^ srl64(z, 27)


def _register_grace_hash():
    from ..expr.registry import ANY, INTEGER, DEFAULT_REGISTRY as reg

    if reg.signatures("__grace_hash"):
        return
    reg.register(
        "__grace_hash", [ANY, INTEGER], BIGINT,
        lambda ctx, out_t, arg_ts, a, salt: grace_hash(a, salt),
    )


def _grace_level(node: HashJoinNode) -> int:
    """How many Grace passes this join is already inside: each pass puts one
    ``__grace_hash`` filter over the probe, and ``dataclasses.replace``
    keeps the node's id, so the id alone does not tell the levels apart."""
    level = 0
    left = node.left
    while isinstance(left, FilterNode) and "__grace_hash(" in left.predicate.key():
        level += 1
        left = left.source
    return level


def _salt_of(node: HashJoinNode) -> int:
    """Deterministic per-join, per-level salt: partitioning an oversized
    partition again (the next level) uses an independent hash, so its rows
    spread over the new partitions instead of landing in one."""
    key = f"{getattr(node, 'id', 'join')}/{_grace_level(node)}"
    return zlib.crc32(key.encode()) or 1


def _combined_hash_np(table: Table, keys, salt: int) -> np.ndarray:
    h = None
    for k in keys:
        # the same int64 conversion as the join's own key packing (joins.py)
        arr = np.asarray(table.columns[k]).astype(np.int64)
        hk = splitmix64_np(arr, salt)
        valid = table.validities.get(k)
        if valid is not None:
            hk = np.where(valid, hk, np.int64(0))
        h = hk if h is None else (h ^ hk)
    return h


def probe_filter_expr(node: HashJoinNode, P: int, p: int, salt: int):
    """The device-side partition predicate for pass ``p`` as a parsed Expr."""
    from ..expr.parser import parse_expr

    _register_grace_hash()
    schema = node.left.output_schema
    parts = [f"__grace_hash({k}, {salt})" for k in node.left_keys]
    text = parts[0]
    for t in parts[1:]:
        text = f"bitwise_xor({text}, {t})"
    pred = f"bitwise_and({text}, {P - 1}) = {p}"
    null_any = " or ".join(f"{k} is null" for k in node.left_keys)
    if p == 0:
        pred = f"({pred}) or {null_any}"
    else:
        pred = f"({pred}) and not ({null_any})"
    return parse_expr(pred, schema)


def partition_build(table: Table, keys, P: int, salt: int) -> List[Table]:
    """Split the host build table into P partition tables by salted key hash;
    NULL-key rows land in partition 0."""
    h = _combined_hash_np(table, keys, salt)
    part = h & np.int64(P - 1)
    for k in keys:
        valid = table.validities.get(k)
        if valid is not None:
            part = np.where(valid, part, np.int64(0))
    out = []
    for p in range(P):
        rows = np.flatnonzero(part == p)
        out.append(
            Table(
                table.schema,
                {n: np.asarray(v)[rows] for n, v in table.columns.items()},
                table.string_tables,
                {n: np.asarray(v)[rows] for n, v in table.validities.items()},
            )
        )
    return out


def pick_partition_count(build_bytes: int, budget: Optional[int]) -> int:
    """Power-of-two partition count targeting builds of about a quarter of
    the budget (at least 2, at most 64)."""
    if not budget:
        return 4
    target = max(budget // 4, 1)
    P = 1
    while P < 64 and build_bytes // P > target:
        P *= 2
    return max(P, 2)


def grace_join_table(
    node: HashJoinNode,
    build_table: Table,
    tile_rows: int,
    config,
    device=None,
    report: Optional[dict] = None,
) -> Table:
    """Execute ``node`` partition by partition; returns the joined host Table.

    The caller hands over the already materialized (host) build table; each
    pass plans the join again with a device-side partition filter over the
    probe and a ValuesNode build partition, run by a child LocalExecutor
    under its own memory pool (pressure there enters this path again).
    ``device`` None = the CUDA device.  ``report``, when given, receives P,
    the salt, each partition's build and output rows (and the reports of the
    Grace joins its own pass ran, when it had to split again), the partitions run
    without a budget (``no_progress``) and what the joined parts spilled."""
    from ..utils.testvalue import adjust
    from .memory import Spiller, no_spill, table_nbytes
    from .runner import LocalExecutor

    out_names = list(node.output_columns)
    if report is not None:
        # a null-aware join that resolves globally partitions nothing (P 0)
        report.update(join_id=node.id, P=0, salt=None, build_rows=build_table.num_rows,
                      partitions=[], no_progress=[], spill=no_spill())
    if node.null_aware:
        # NOT IN semantics resolve GLOBALLY before partitioning, after which
        # every partition-local join is a plain ANTI (reference:
        # HashJoinBridge's nullAware build summary):
        #   1. any NULL build key  -> x NOT IN (..., NULL) is never TRUE ->
        #      the whole result is empty
        #   2. empty build         -> every probe row keeps
        #   3. otherwise           -> probe NULL keys drop (FALSE/UNKNOWN),
        #      and no partition-local null handling remains
        from ..expr.parser import parse_expr

        def key_has_null(k):
            v = build_table.validities.get(k)
            return v is not None and not np.asarray(v).all()

        probe_schema = node.left.output_schema
        if any(key_has_null(k) for k in node.right_keys):
            empty = FilterNode(node.left, parse_expr("1 = 0", probe_schema))
            return LocalExecutor(empty, tile_rows, config, device=device).run().select(out_names)
        if build_table.num_rows == 0:
            return LocalExecutor(node.left, tile_rows, config, device=device).run().select(out_names)
        not_null = " and ".join(f"{k} is not null" for k in node.left_keys)
        node = dataclasses.replace(
            node,
            left=FilterNode(node.left, parse_expr(not_null, probe_schema)),
            null_aware=False,
        )
    from .grouped import concat_tables

    adjust("LocalExecutor::graceJoin", node)
    salt = _salt_of(node)
    P = pick_partition_count(table_nbytes(build_table), config.query_memory_limit_bytes)
    builds = partition_build(build_table, list(node.right_keys), P, salt)
    total_rows = build_table.num_rows
    spiller = None
    parts: List[Table] = []
    partitions = []
    no_progress = []
    acc = 0
    for p in range(P):
        sub = dataclasses.replace(
            node,
            left=FilterNode(node.left, probe_filter_expr(node, P, p, salt)),
            right=ValuesNode(builds[p]),
        )
        sub_config = config
        if total_rows and builds[p].num_rows >= max(1, (3 * total_rows) // 4):
            # no-progress partition (one key dominates the build): hashing
            # cannot split equal keys, so recursing would loop forever —
            # run this partition without a budget instead (the reference
            # hits the same wall and switches its last spill level to
            # kNoMoreSpill, Spiller.cpp maxSpillLevel)
            adjust("LocalExecutor::graceNoProgress", node)
            no_progress.append(p)
            sub_config = config.copy(query_memory_limit_bytes=None)
        child = LocalExecutor(sub, tile_rows, sub_config, device=device)
        part = child.run()
        # a partition that still did not fit split again: its own report
        partitions.append(dict(build_rows=builds[p].num_rows, out_rows=part.num_rows,
                               grace_joins=child.grace_joins))
        parts.append(part)
        acc += table_nbytes(part)
        if (
            config.spill_enabled
            and acc > config.spill_bytes_threshold
            and not any(t.is_complex for t in part.schema.types)
        ):
            spiller = spiller or Spiller.for_config(config)
            for t in parts:
                spiller.spill(t)
            parts.clear()
            acc = 0
    spilled = no_spill()
    if spiller is not None:
        restored = list(spiller.restore())
        spilled = spiller.report()
        spiller.cleanup()
        parts = restored + parts
    if report is not None:
        report.update(P=P, salt=salt, partitions=partitions, no_progress=no_progress,
                      spill=spilled)
    return concat_tables(parts)
