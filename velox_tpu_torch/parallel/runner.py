"""Distributed plan execution across the ranks of a process group.

Counterpart of the JAX package's ``parallel/runner.py``.  Reference
re-orientation: the reference scales out via N identical Drivers per pipeline
(velox/exec/LocalPlanner.cpp:174) plus a partitioned exchange between hosts
(PartitionedOutput.h:139, kPartitioned / kBroadcast modes, core/PlanNode.h:1107).

Every rank runs the same ``DistributedExecutor`` (SPMD) and returns the same
result Table:

* intra-pipeline data parallelism -> rank r owns rows
  ``[r * per_dev, (r + 1) * per_dev)`` of every tile of capacity
  ``n * per_dev`` (the JAX package's ``P(axis)`` row sharding) and runs the
  same tile steps as the single-device path over them;
* broadcast joins -> small build sides execute on every rank (the kBroadcast
  mode);
* shuffle joins -> large build sides hash-partition across the ranks
  (parallel/shuffle_join.py) and probe rows reach their partition through a
  row exchange; the choice is by build cardinality
  (config.broadcast_join_max_rows);
* grouped aggregation -> per-rank partial groups, a hash all-to-all of the
  groups so each rank owns its key space, a rank-local sorted-carry merge;
  carry overflow grows the carry and retries — the backpressure analog of
  OutputBuffer limits (velox/exec/OutputBuffer.h:131);
* collect pipelines -> per-rank compaction, then one all-gather of the live
  prefixes.

Every decision the host takes from device values — an error count, a dropped
row count, a carry overflow, a bucket maximum — is taken from a value every
rank agrees on (an all-reduce, or counts that rode in an all-to-all), before
any rank acts on it.  The JAX package gets that from ``psum`` inside one
program; here a rank that raised or retried alone would leave the others
blocked in their next collective until the process group's timeout.

Scope as in the JAX package: ungrouped / array-mode aggregations keep
broadcast joins; sort-mode aggregations and collects take both join modes.
Accumulators are integer-exact, so the rank count changes no integer result.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..exec.runner import (
    AggExecutor,
    LocalExecutor,
    RunStats,
    _linearize,
    _pick_capacity,
    _raise_on_errors,
    apply_finishers,
    apply_streaming,
    table_batches,
)
from ..io.table import Table
from ..plan.nodes import PlanNode
from ..vector.column import Batch, Column
from .distributed import Mesh, all_gather_arrays, gather_prefixes, make_mesh  # noqa: F401

__all__ = ["DistributedExecutor", "ExchangeOverflow", "GroupOverflow", "make_mesh"]


class ExchangeOverflow(RuntimeError):
    """A shuffle exchange bucket was undersized and rows would have been
    dropped; the executor re-probes exact bucket sizes and retries
    (exchange.py bucketize's dropped counter)."""


class GroupOverflow(RuntimeError):
    """A rank's carry ran out of slots (skewed group ownership)."""


class DistributedExecutor:
    """Executes a single-pipeline plan with every tile split across the ranks.

    The per-tile capacity is ``n * per_dev`` so each rank owns an equal
    contiguous shard of every tile.  Construct and run it on every rank of
    ``mesh`` with the same plan (each rank holds the same source tables).

    After a run: ``kind`` (``direct_agg`` / ``sort_agg_exchange`` /
    ``collect``), ``_sjoin_buckets`` and ``_sjoin_outcaps`` (each shuffle
    join's exchange bucket and output capacity), ``_carry_rows`` (a rank's
    carry slots), ``carry_retries`` and ``reprobes`` (how often the carry grew
    and the buckets were re-probed), and ``mesh.stats`` (the collectives)."""

    def __init__(
        self,
        root: PlanNode,
        mesh: Mesh,
        per_device_rows: int = 1 << 18,
        config=None,
    ):
        from ..config import DEFAULT_CONFIG
        from ..exec.hugeint import rewrite_long_decimals
        from ..exec.joins import HashJoinExec, JoinBuildError, rewrite_filtered_existence_joins
        from ..exec.sketch import rewrite_sketch_aggregates
        from ..exec.strcast import rewrite_string_construction
        from ..exec.window import WindowNode
        from ..plan.nodes import (
            AggregationNode,
            MergeExchangeNode,
            TableScanNode,
            UnionAllNode,
            ValuesNode,
        )
        from .shuffle_join import flatten_state, partition_build

        self.mesh = mesh
        self.n = mesh.size
        self.device = mesh.device
        self.config = config or DEFAULT_CONFIG
        self.carry_retries = 0
        self.reprobes = 0

        # a second pass over an already rewritten plan finds nothing and
        # keeps the specs
        root, specs = rewrite_string_construction(root)
        self._strcast_specs = specs or getattr(self, "_strcast_specs", None)
        root = rewrite_sketch_aggregates(root, self.config)
        root = rewrite_filtered_existence_joins(root)
        root, self._hugeint_logical = rewrite_long_decimals(root)
        lin = _linearize(root)
        if not isinstance(lin.source, (TableScanNode, ValuesNode)):
            # pipeline barrier (e.g. an aggregation feeding another): run the
            # subtree DISTRIBUTED when it is aggregation-rooted — the heavy
            # half of stacked aggregations (sketch rewrites) stays
            # distributed — otherwise materialize it on every rank.  A window
            # or set-operation source is the local executor's (the JAX
            # package would recurse into it without end)
            def _has_agg(n):
                return isinstance(n, AggregationNode) or any(
                    _has_agg(s) for s in getattr(n, "sources", ())
                )

            local_sources = (WindowNode, UnionAllNode, MergeExchangeNode)
            if _has_agg(lin.source) and not isinstance(lin.source, local_sources):
                sub = DistributedExecutor(lin.source, mesh, per_device_rows, config).run()
            else:
                sub = LocalExecutor(lin.source, device=self.device).run()
            lin.source = ValuesNode(sub, id=lin.source.id)
        self.lin = lin

        self.source_table = lin.source.table.select(list(lin.source.output_schema.names))
        per_device = _pick_capacity(
            max(-(-self.source_table.num_rows // self.n), 1), per_device_rows
        )
        self.per_dev = per_device
        self.capacity = per_device * self.n

        # pipeline kind first: it decides whether shuffle joins are available
        if lin.agg is not None:
            ex = AggExecutor(lin.agg, self.capacity)
            self.agg_exec = ex
            self.kind = "direct_agg" if ex.mode in ("ungrouped", "array") else "sort_agg_exchange"
        else:
            self.agg_exec = None
            self.kind = "collect"
        allow_shuffle = self.kind in ("sort_agg_exchange", "collect")

        # ---- joins: broadcast vs shuffle by build cardinality ------------
        # Broadcast joins stay inline in the step list (every rank holds the
        # whole build); each shuffle join splits the pipeline at its
        # probe-row exchange.
        resolved: List[Tuple] = []
        for step in lin.steps:
            if step[0] != "join":
                resolved.append(step)
                continue
            node = step[1]
            build = LocalExecutor(node.right, device=self.device).run()
            if allow_shuffle and build.num_rows > self.config.broadcast_join_max_rows:
                try:
                    resolved.append(("sjoin", partition_build(node, build, mesh)))
                    continue
                except JoinBuildError:
                    pass  # join type unsupported: broadcast instead
            exec_ = HashJoinExec.build(node, *table_batches(build, per_device_rows, self.device))
            if exec_.expansion:
                # a duplicate-key (N:M) build produces data-dependent output
                # sizes; the shuffle-join segments size and overflow-guard
                # those, so route ANY expansion build through them when the
                # pipeline kind allows
                if allow_shuffle:
                    try:
                        resolved.append(("sjoin", partition_build(node, build, mesh)))
                        continue
                    except JoinBuildError:
                        pass
                raise NotImplementedError(
                    f"distributed {node.join_type.name} join over a duplicate-key (N:M) "
                    "build is only supported on collect/grouped-aggregation pipelines "
                    "via the shuffle path; run via LocalExecutor instead"
                )
            resolved.append(("join", exec_))
        for i, step in enumerate(resolved):
            if (
                step[0] == "left_join_filter"
                and i > 0
                and resolved[i - 1][0] == "sjoin"
                and resolved[i - 1][1].expansion
            ):
                # non-equi filter on an N:M LEFT join: per-expanded-row
                # null-out is wrong (a probe row whose matches ALL fail must
                # appear once, not k times) — re-plan through the
                # uid/inner/left composition, exactly as LocalExecutor does
                from ..exec.joins import rewrite_left_filter_nm
                from ..exec.runner import _replace_plan_node

                orig = step[3]
                new_root = _replace_plan_node(root, orig, rewrite_left_filter_nm(orig))
                self.__init__(new_root, mesh, per_device_rows, config)
                return
        self._segments: List[Tuple[Tuple, object]] = []
        cur: List[Tuple] = []
        for step in resolved:
            if step[0] == "sjoin":
                self._segments.append((tuple(cur), step[1]))
                cur = []
            else:
                cur.append(step)
        self._tail_steps = tuple(cur)
        lin.steps = [s for s in resolved if s[0] != "sjoin"]
        # each shuffle join's rank-local probe state, rebuilt once
        self._sjoin_execs = []
        for _, state in self._segments:
            arrays, rebuild = flatten_state(state)
            self._sjoin_execs.append(rebuild(arrays))

        # Per-segment exchange bucket sizing: the balanced share (pipe_cap /
        # n) with 4x slack — a bucket the exchange's overflow counter guards;
        # on overflow the executor re-probes exact per-source maxima
        # (_resize_exchange_buckets, the two-phase skew-aware protocol).
        self._sjoin_buckets: List[int] = []
        # per-segment post-probe capacity: for a unique-key probe the
        # exchange's receive capacity (n * bucket); an expansion (N:M) probe
        # materializes into its own overflow-guarded output bucket (2x the
        # receive capacity; exact-sized by the two-phase re-probe)
        self._sjoin_outcaps: List[int] = []
        pipe_cap = per_device
        for _, state in self._segments:
            if self.config.exchange_bucket_rows:
                bucket = min(self.config.exchange_bucket_rows, pipe_cap)
            else:
                bucket = 8
                while bucket < min(max(pipe_cap // self.n, 1) * 4, pipe_cap):
                    bucket *= 2
            self._sjoin_buckets.append(bucket)
            recv_cap = self.n * bucket
            out_cap = 2 * recv_cap if state.expansion else recv_cap
            self._sjoin_outcaps.append(out_cap)
            pipe_cap = out_cap
        self.pipe_cap = pipe_cap

        if self.kind == "sort_agg_exchange":
            self.local_agg = AggExecutor(lin.agg, self.pipe_cap)
            self._carry_rows = self.config.distributed_carry_rows or per_device

    # ------------------------------------------------------------------
    def _check_exchange_drops(self, dropped: int) -> None:
        if dropped:
            raise ExchangeOverflow(
                f"{dropped} rows exceeded their exchange bucket "
                f"(buckets {self._sjoin_buckets}); re-probing"
            )

    def _exchange_probe_rows(self, batch: Batch, state, bucket: int):
        """A shuffle join's probe rows to the rank that owns their keys:
        (received batch of capacity n * bucket, global dropped rows)."""
        from .exchange import exchange_rows
        from .shuffle_join import probe_pack

        packed = probe_pack(state, batch)
        flat_arrays, layout, strings = _flatten_batch_columns(batch)
        recv, _keys, live, drop = exchange_rows(
            flat_arrays, packed, batch.active_mask(), self.mesh, self.n, bucket
        )
        return _rebuild_batch(batch.schema, layout, strings, recv, live, self.n * bucket), drop

    def _resize_exchange_buckets(self, tiles) -> None:
        """Phase 1 of the two-phase skew-aware shuffle (exchange.py
        skew_probe): run the segment pipeline once with always-safe
        full-capacity buckets, recording each exchange's worst
        per-source-per-destination count over all tiles and ranks, then
        size the buckets at those proven power-of-two sizes."""
        from .exchange import destination_counts, partition_destinations
        from .shuffle_join import probe_pack

        n = self.n
        S = len(self._segments)
        # expansion capacities for the probe run itself: grown and measured
        # again until every measured total fits, so downstream measurements
        # are never computed over truncated data
        probe_caps = list(self._sjoin_outcaps)
        for _grow in range(8):
            local = torch.zeros((2 * S,), dtype=torch.int64, device=self.device)
            for t in tiles:
                batch = t
                for i, ((seg_steps, state), ex) in enumerate(zip(self._segments, self._sjoin_execs)):
                    batch, _ = apply_streaming(batch, seg_steps)
                    dest = partition_destinations(probe_pack(state, batch), n)
                    worst = destination_counts(dest, batch.active_mask(), n).max()
                    local[i] = torch.maximum(local[i], worst)
                    batch, _ = self._exchange_probe_rows(batch, state, batch.capacity)
                    if ex.expansion:
                        spans = ex.probe_spans(batch)
                        local[S + i] = torch.maximum(local[S + i], spans[3].to(torch.int64))
                        batch = ex.expand(batch, spans[:3], probe_caps[i])
                    else:
                        batch = ex.probe(batch)
            got = self.mesh.all_reduce(local, "max").tolist()
            worst, worst_totals = got[:S], got[S:]
            grown = False
            for i, ((_, state), wt) in enumerate(zip(self._segments, worst_totals)):
                if state.expansion and wt > probe_caps[i]:
                    # truncated expansion: downstream maxima are invalid —
                    # grow this capacity and measure again
                    c = 8
                    while c < wt:
                        c *= 2
                    probe_caps[i] = c
                    grown = True
            if not grown:
                break
        buckets, outcaps = [], []
        pipe_cap = self.per_dev
        for (_, state), w, wt in zip(self._segments, worst, worst_totals):
            b = 8
            while b < max(w, 1):
                b *= 2
            b = min(b, pipe_cap)
            buckets.append(b)
            if state.expansion:
                oc = 8
                while oc < max(wt, 1):
                    oc *= 2
            else:
                oc = self.n * b
            outcaps.append(oc)
            pipe_cap = oc
        self._sjoin_buckets = buckets
        self._sjoin_outcaps = outcaps
        self.pipe_cap = pipe_cap
        if self.kind == "sort_agg_exchange":
            self.local_agg = AggExecutor(self.lin.agg, self.pipe_cap)

    # ------------------------------------------------------------------
    def _run_segments_local(self, batch: Batch):
        """This rank's pipeline over its shard of a tile: the segment steps,
        a shuffle-join probe exchange after each, then the tail steps.
        Returns (batch, error count, dropped rows), the counts 0-d tensors."""
        err = torch.zeros((), dtype=torch.int64, device=self.device)
        dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        for (seg_steps, state), ex, bucket, out_cap in zip(
            self._segments, self._sjoin_execs, self._sjoin_buckets, self._sjoin_outcaps
        ):
            batch, e = apply_streaming(batch, seg_steps)
            err = err + e
            # hash-partition the probe rows to the build's partitioning
            batch, drop = self._exchange_probe_rows(batch, state, bucket)
            dropped = dropped + drop
            if ex.expansion:
                # N:M probe: data-dependent output size — materialize into
                # the sized bucket and count overflow (two-phase protocol)
                spans = ex.probe_spans(batch)
                dropped = dropped + (spans[3] - out_cap).clamp(min=0)
                batch = ex.expand(batch, spans[:3], out_cap)
            else:
                batch = ex.probe(batch)
        batch, e = apply_streaming(batch, self._tail_steps)
        return batch, err + e, dropped

    def device_tiles(self) -> List[Batch]:
        """This rank's shard of every tile on its device: shard r of tile i
        is rows ``[i * capacity + r * per_dev, ... + per_dev)``, with that
        global row offset (so AssignUniqueId numbers rows as the local
        executor does)."""
        n_tiles = self.source_table.num_tiles(self.capacity)
        return [
            self.source_table.tile(i * self.n + self.mesh.rank, self.per_dev, self.device)
            for i in range(n_tiles)
        ]

    # ------------------------------------------------------------------
    def run(self, prefetched_tiles=None, stats: Optional[RunStats] = None) -> Table:
        tiles = prefetched_tiles if prefetched_tiles is not None else self.device_tiles()
        if stats is not None:
            stats.tiles = len(tiles)
            stats.rows_in = self.source_table.num_rows
        for attempt in range(2):
            try:
                if self.kind == "direct_agg":
                    result = self._run_direct(tiles)
                elif self.kind == "collect":
                    result = self._run_collect(tiles)
                else:
                    # grouped aggregation: grow the carry, retry on overflow
                    while True:
                        try:
                            result = self._run_grouped(tiles)
                            break
                        except GroupOverflow:
                            if self._carry_rows >= self.n * self.pipe_cap:
                                raise
                            self._carry_rows = min(self._carry_rows * 4, self.n * self.pipe_cap)
                            self.carry_retries += 1
                break
            except ExchangeOverflow:
                if attempt:
                    raise
                # phase 2 of the skew-aware shuffle: measure exact per-source
                # bucket maxima and run again at the proven sizes
                self._resize_exchange_buckets(tiles)
                self.reprobes += 1
        result = apply_finishers(result, self.lin.finishers)
        if self._hugeint_logical is not None:
            from ..exec.hugeint import merge_result

            result = merge_result(result, self._hugeint_logical)
        if self._strcast_specs:
            from ..exec.strcast import render_result

            result = render_result(result, self._strcast_specs)
        return result

    # ---- ungrouped / array-mode aggregation ---------------------------
    def _run_direct(self, tiles) -> Table:
        """Each rank updates its own carry over its shards; the carries are
        then gathered and folded in rank order by each accumulator's own
        merge (``merge``: sums add, extremes take min / max, pairs and
        moments combine as in a tile update).  The JAX package keeps one
        replicated carry that XLA reduces across devices; integer results are
        the same, DOUBLE sums may differ in the last bits.  As there, no
        scan batch rides along, so the piece-sum kernel is not launched."""
        ex = self.agg_exec
        accs, rowcounts = ex.init_carry(self.device)
        errs = torch.zeros((), dtype=torch.int64, device=self.device)
        for t in tiles:
            batch, err = apply_streaming(t, self._tail_steps)
            accs, rowcounts = ex.update_carry((accs, rowcounts), batch)
            errs = errs + err
        widths = [len(acc) for acc in accs]
        flat = [a for acc in accs for a in acc] + [rowcounts, errs.reshape(1)]
        ranks = all_gather_arrays(self.mesh, flat)
        _raise_on_errors(int(sum(int(r[-1][0]) for r in ranks)))

        def nested(arrays):
            out, i = [], 0
            for w in widths:
                out.append(tuple(arrays[i : i + w]))
                i += w
            return out

        merged = nested(ranks[0][:-2])
        rowcounts = ranks[0][-2]
        for r in ranks[1:]:
            merged = [agg.merge(a, b) for agg, a, b in zip(ex.aggs, merged, nested(r[:-2]))]
            rowcounts = rowcounts + r[-2]
        accs_np = [tuple(a.cpu().numpy() for a in acc) for acc in merged]
        return ex.extract(None, accs_np, rowcounts.cpu().numpy())

    # ---- grouped sort-mode aggregation ---------------------------------
    def _run_grouped(self, tiles) -> Table:
        """Software-pipelined shuffle (reference discipline: OutputBuffer
        pipelining + split preloading, velox/exec/TableScan.cpp:245): a
        tile's work splits into PRODUCE (segments, partial grouping,
        bucketize) and CONSUME (the all-to-all and the carry merge).  Tile
        i-1's all-to-all is issued without waiting, tile i is produced while
        it moves, then tile i-1 is merged."""
        from .exchange import bucketize, hash64, start_all_to_all_exchange, umod64

        ex = self.local_agg
        n = self.n
        G = self._carry_rows
        nkeys = len(ex.key_infos)
        acc_widths = [len(a.acc_ops) for a in ex.aggs]
        errs = torch.zeros((), dtype=torch.int64, device=self.device)
        drops = torch.zeros((), dtype=torch.int64, device=self.device)

        def produce(tile):
            batch, err, drop = self._run_segments_local(tile)
            keys, accs, nruns = ex.tile_partial(batch)
            flat = list(keys) + [a for acc in accs for a in acc]
            live = torch.arange(batch.capacity, dtype=torch.int32, device=self.device) < nruns
            # h = h * 31 + hash64(k) in uint64 (wrapping int64 lanes), the
            # unsigned remainder: bit-identical to the JAX package's
            # jnp.uint64, so every group lands on the same rank as there
            h = torch.zeros((batch.capacity,), dtype=torch.int64, device=self.device)
            for k in keys:
                h = h * 31 + hash64(k.to(torch.int64))
            dest = umod64(h, n).to(torch.int32)
            # full-capacity buckets: a destination's count cannot exceed the
            # row count, so this bucketize never drops.  Sent whole, they
            # would move n * capacity rows a rank (the JAX package's shape):
            # every rank agrees on the fullest bucket of any rank and sends
            # that many rows a destination — equal splits, no row lost
            bucketed, counts, _, _ = bucketize(flat, dest, live, n, batch.capacity)
            width = int(self.mesh.all_reduce(counts.max().to(torch.int64).reshape(1), "max"))
            bucketed = [b[:, : max(width, 1)] for b in bucketed]
            return start_all_to_all_exchange(bucketed, counts, self.mesh), err, drop

        def consume(carry, pending):
            received, recv_counts = pending.wait()
            cap_b = received[0].shape[1]
            offs = torch.arange(cap_b, dtype=torch.int32, device=self.device)[None, :]
            recv_live = (offs < recv_counts[:, None]).reshape(-1)
            recv_flat = [r.reshape((n * cap_b,) + tuple(r.shape[2:])) for r in received]
            accs_r, i = [], nkeys
            for w in acc_widths:
                accs_r.append(tuple(recv_flat[i : i + w]))
                i += w
            return ex.merge_partial_into_carry(
                carry, (tuple(recv_flat[:nkeys]), tuple(accs_r), recv_live)
            )

        carry = ex.init_sorted_carry(G, self.device)
        pending = None
        for t in tiles:
            nxt, err, drop = produce(t)
            errs, drops = errs + err, drops + drop
            if pending is not None:
                carry = consume(carry, pending)
            pending = nxt
        carry = consume(carry, pending)
        keys_c, accs_c, count, overflow = carry
        agreed = self.mesh.all_reduce(
            torch.stack([errs, drops, overflow.to(torch.int64)]), "sum"
        ).tolist()
        _raise_on_errors(agreed[0])
        self._check_exchange_drops(agreed[1])
        if agreed[2]:
            raise GroupOverflow(f"distributed carry ({G} slots a rank) overflowed")
        flat = list(keys_c) + [a for acc in accs_c for a in acc]
        key_chunks, acc_chunks = [], []
        for _, arrays in gather_prefixes(self.mesh, flat, count.reshape(1)):
            key_chunks.append(arrays[:nkeys])
            accs, i = [], nkeys
            for w in acc_widths:
                accs.append(tuple(arrays[i : i + w]))
                i += w
            acc_chunks.append(accs)
        group_keys, merged = ex.merge_partials_host(key_chunks, acc_chunks)
        return ex.extract(group_keys, merged)

    # ---- collect pipelines ---------------------------------------------
    def _run_collect(self, tiles) -> Table:
        """Filter / project / join pipelines: per-rank compaction, then one
        gather of every rank's live prefixes; rows come out tile by tile,
        rank 0's first within a tile, as the JAX package's device order."""
        from ..ops.compact import compact

        outs = []
        errs = torch.zeros((), dtype=torch.int64, device=self.device)
        drops = torch.zeros((), dtype=torch.int64, device=self.device)
        for t in tiles:
            batch, err, drop = self._run_segments_local(t)
            batch = compact(batch)
            outs.append(batch)
            errs, drops = errs + err, drops + drop
        agreed = self.mesh.all_reduce(torch.stack([errs, drops]), "sum").tolist()
        _raise_on_errors(agreed[0])
        self._check_exchange_drops(agreed[1])
        schema = outs[-1].schema
        if any(t.is_complex for t in schema.types):
            raise NotImplementedError("distributed collect of complex-typed columns")
        flat = [[c.flatten(b.capacity) for c in b.columns] for b in outs]
        has_validity = [any(cols[j].validity is not None for cols in flat)
                        for j in range(len(schema.names))]
        lengths = torch.stack([b.length.to(torch.int64) for b in outs])
        cut = lengths.tolist()
        arrays = []
        for j, nullable in enumerate(has_validity):
            arrays.append(torch.cat([cols[j].data[:m] for cols, m in zip(flat, cut)]))
            if nullable:
                arrays.append(torch.cat([
                    cols[j].validity[:m] if cols[j].validity is not None
                    else torch.ones((m,), dtype=torch.bool, device=self.device)
                    for cols, m in zip(flat, cut)
                ]))
        gathered = gather_prefixes(self.mesh, arrays, lengths)
        # tile-major, rank-minor row order
        pieces = []
        starts = [np.concatenate([[0], np.cumsum(lens)]) for lens, _ in gathered]
        for t in range(len(outs)):
            for r, (lens, _) in enumerate(gathered):
                pieces.append((r, int(starts[r][t]), int(starts[r][t] + lens[t])))
        cols: Dict[str, np.ndarray] = {}
        validities: Dict[str, np.ndarray] = {}
        k = 0
        for j, name in enumerate(schema.names):
            cols[name] = np.concatenate([gathered[r][1][k][a:b] for r, a, b in pieces])
            k += 1
            if has_validity[j]:
                validities[name] = np.concatenate([gathered[r][1][k][a:b] for r, a, b in pieces])
                k += 1
        strings = {
            name: c.strings
            for name, c in zip(schema.names, outs[-1].columns)
            if c.strings is not None
        }
        return Table(schema, cols, strings, validities)


def _flatten_batch_columns(batch: Batch):
    """Flatten a batch's columns for a row exchange: (arrays, has-validity
    per column, string tables per column)."""
    arrays: List[torch.Tensor] = []
    layout: List[bool] = []
    strings = []
    for name, c in zip(batch.schema.names, batch.columns):
        if c.dtype.is_complex:
            raise NotImplementedError(f"row exchange of the complex-typed column {name!r}")
        fc = c.flatten(batch.capacity)
        arrays.append(fc.data)
        layout.append(fc.validity is not None)
        strings.append(fc.strings)
        if fc.validity is not None:
            arrays.append(fc.validity)
    return arrays, layout, strings


def _rebuild_batch(schema, layout, strings, arrays, live, capacity) -> Batch:
    cols = []
    pos = 0
    for has_validity, tab, dtype in zip(layout, strings, schema.types):
        data = arrays[pos]
        pos += 1
        validity = None
        if has_validity:
            validity = arrays[pos]
            pos += 1
        cols.append(Column.flat(data, dtype, validity, tab))
    b = Batch.make(schema, cols, length=capacity, capacity=capacity)
    return dataclasses.replace(b, selection=live)
