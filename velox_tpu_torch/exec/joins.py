"""Hash join execution: the unique-build regime.

Counterpart of the JAX package's ``exec/joins.py``.  Reference:
velox/exec/HashBuild.h:39 / HashProbe.h:28 / HashJoinBridge.h — the reference
builds a quadratic-probing hash table from the build side and streams probe
batches through it.

Two probes of a unique build side.  The first keeps the JAX package's
algorithm, a **sort-merge lookup**, whose output is in join-key order:

  1. build side: key-sorted tensors, sorted and kept on the device (the
     JoinBridge analog; ``HashJoinExec.build``);
  2. per probe tile: sort the concatenation [build keys ++ probe keys] with a
     tie-break flag so each build row precedes equal probe keys;
  3. "the last build row at or before this one" (the reference's running
     maximum, ``ops/segmented.py last_flagged`` here) gives every probe row
     its candidate match;
  4. the output is emitted in merged key order (fused probe) or compacted by a
     second sort (classification path).

The second, the **hashed probe** (``_probe_hashed``), looks each probe row up
in a hash table of the build keys on the card (``ops/hash_probe.py``, K5) and
keeps the probe batch's rows, order and capacity.  The executor takes it
where no consumer reads the join's key order (``exec/runner.py
_mark_hashed_joins``); everywhere else the merge stays.

The merge is sort / scan / gather.  This is the normalized-key regime the
reference itself prefers (HashTable kNormalizedKey, velox/exec/HashTable.h:74):
multi-column keys are packed into one int64 normalized key from build-side
value ranges (VectorHasher range mode, velox/exec/VectorHasher.h:118); probe
values outside any range cannot match and map to a negative sentinel.

Every sort here is stable (``torch.sort(stable=True)``): build rows must
precede equal probe keys, and ties keep their input order.

Scope: equi-joins, types INNER, LEFT, FULL, LEFT_SEMI and ANTI (RIGHT and
RIGHT_SEMI flip to LEFT / LEFT_SEMI in the executor).  A UNIQUE build
side (primary-key joins) probes in one fused pass.  A build side with
DUPLICATE keys becomes an **expansion join**: the build keeps per-key runs
(start, count) in sorted order, each probe row resolves to a span over the
build array (``probe_spans``), and ``expand`` writes one output row per
(probe row, matching build row) pair into a power-of-two output bucket that
the executor sizes by one scalar read a tile (ops/segpool.py).  A FULL join
is always an expansion join: its build keeps the null-key rows (under a
sentinel key that equals nothing) and the right key columns;
each tile's spans also flag the build rows it matched (``probe_spans``), and
after the last tile ``full_tail`` emits the build rows no tile matched, with
the probe side NULL.  LEFT_SEMI and ANTI deduplicate the build keys, so any
build side works there.  Non-equi filters: on INNER they become a filter
above the join, on LEFT they null the build side of failing matches (the
executor's ``left_join_filter`` step; on an N:M LEFT join through
``rewrite_left_filter_nm``); on LEFT_SEMI / ANTI, null-aware ANTI and FULL
they lower through plan rewrites (``rewrite_filtered_existence_joins``,
``rewrite_null_aware_anti_filter``, ``rewrite_full_filter``).

Not ported: ``probe_split_host`` (a split dispatch that exists for the JAX
package's compiler) raises by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.hash_probe import HashTable, build_hash_table, hash_probe
from ..ops.segmented import last_flagged, next_flagged
from ..ops.sortkey import sort_operands
from ..plan.nodes import HashJoinNode, JoinType
from ..vector.column import Batch, Column, Encoding, _take_clamped as _take


class JoinBuildError(RuntimeError):
    pass


def _not_ported(name: str, what: str):
    def raiser(*args, **kwargs):
        raise NotImplementedError(f"exec.joins.{name} ({what}) is not ported yet")

    raiser.__name__ = name
    return raiser


@dataclasses.dataclass
class _NormalizedKey:
    """Pack k build-key columns into one int64 (VectorHasher range mode).

    Composite keys wider than 62 bits split into TWO int64 limbs (``split``
    marks the first low-limb field) — the analog of the reference's
    kNormalizedKey -> kHash degradation (HashTable.cpp decideHashMode),
    except exactness is kept by comparing both limbs instead of hashing.
    """

    mins: np.ndarray  # [k] int64 per-key build-side minimum
    maxs: np.ndarray  # [k] int64 per-key build-side maximum
    shifts: np.ndarray  # [k] left-shift per key (within its limb)
    split: int = 0  # fields [0, split) ride the HIGH limb; 0 = single-limb

    @property
    def two_limb(self) -> bool:
        return self.split > 0

    @staticmethod
    def fit(key_arrays: Sequence[np.ndarray]) -> "_NormalizedKey":
        return _NormalizedKey.fit_from_bounds(
            [int(a.min()) if len(a) else 0 for a in key_arrays],
            [int(a.max()) if len(a) else 0 for a in key_arrays],
        )

    @staticmethod
    def fit_from_bounds(los, his) -> "_NormalizedKey":
        mins, maxs, bits = [], [], []
        for lo, hi in zip(los, his):
            lo, hi = int(lo), max(int(lo), int(hi))
            mins.append(lo)
            maxs.append(hi)
            bits.append(max(1, int(hi - lo).bit_length()))
        split = 0
        if sum(bits) > 62 and len(bits) > 1:
            # greedy: fill the high limb until the rest fits the low limb.
            # A single field wider than 62 bits may occupy a limb ALONE:
            # (v - min) then wraps int64, which is a bijection — equality
            # and probe/build consistency are preserved (the lookup needs a
            # consistent total order, not the natural one).
            acc = 0
            for i, b in enumerate(bits):
                if acc == 0 and b > 62:
                    split = i + 1  # oversized field takes the limb alone
                    break
                if acc + b > 62:
                    split = i
                    break
                acc += b
            else:
                split = len(bits)
            lo_bits = bits[split:]
            if split == 0 or (len(lo_bits) > 1 and sum(lo_bits) > 62):
                raise JoinBuildError(
                    f"multi-key join key ranges need {sum(bits)} bits across "
                    f"{len(bits)} keys; they do not fit two int64 limbs "
                    "(reorder the keys, pre-aggregate, or split the join)"
                )
        shifts = np.zeros(len(bits), dtype=np.int64)
        for limb_fields in (
            (range(0, split) if split else []),
            range(split, len(bits)),
        ):
            acc = 0
            for i in reversed(list(limb_fields)):
                shifts[i] = acc
                acc += bits[i]
        return _NormalizedKey(
            np.asarray(mins, dtype=np.int64),
            np.asarray(maxs, dtype=np.int64),
            shifts,
            split,
        )

    def pack_host(self, key_arrays: Sequence[np.ndarray]) -> np.ndarray:
        """Single-limb packed keys (callers check ``two_limb`` first)."""
        assert not self.two_limb
        out = np.zeros(len(key_arrays[0]), dtype=np.int64)
        for arr, lo, sh in zip(key_arrays, self.mins, self.shifts):
            out += (arr.astype(np.int64) - lo) << sh
        return out

    def pack_device(self, key_values: Sequence[torch.Tensor], valid: torch.Tensor):
        """Single-limb packed keys: (packed [cap] int64, in_range & valid);
        out-of-range or invalid probe values cannot match any build row and
        pack to -1 (callers check ``two_limb`` first)."""
        assert not self.two_limb
        (_, packed), ok = self.pack_device_limbs(key_values, valid)
        return packed, ok

    def pack_device_limbs(self, key_values: Sequence[torch.Tensor], valid: torch.Tensor):
        """((hi|None, lo), in_range&valid); rows out of range or invalid pack
        to -1 in every limb."""
        hi = torch.zeros_like(key_values[0], dtype=torch.int64)
        lo_arr = torch.zeros_like(key_values[0], dtype=torch.int64)
        ok = valid
        for i, (v, mn, mx, sh) in enumerate(
            zip(key_values, self.mins, self.maxs, self.shifts)
        ):
            v64 = v.to(torch.int64)
            ok = ok & (v64 >= int(mn)) & (v64 <= int(mx))
            term = (v64 - int(mn)) << int(sh)
            if i < self.split:
                hi = hi + term
            else:
                lo_arr = lo_arr + term
        lo_arr = torch.where(ok, lo_arr, torch.full_like(lo_arr, -1))
        if not self.two_limb:
            return (None, lo_arr), ok
        return (torch.where(ok, hi, torch.full_like(hi, -1)), lo_arr), ok


_KEY_SENTINEL = np.iinfo(np.int64).max
_BIG = 1 << 62


def _index_bits(n: int) -> int:
    return max(1, int(n - 1).bit_length()) if n > 1 else 1


def _key_codes(keys: torch.Tensor, lo: int, span: int) -> torch.Tensor:
    """Order- and equality-preserving map of keys into [0, span]: valid build
    keys in [lo, hi] land on [1, span-1]; anything below-range lands on 0 and
    anything above-range (incl. the int64-max sentinel) on span.  Out-of-range
    collisions are harmless — the match test compares the RAW keys.  Clamp
    BEFORE subtracting: ``sentinel - (lo-1)`` would wrap around int64."""
    lo1 = lo - 1
    return keys.clamp(lo1, lo1 + span) - lo1


def _last_build_row(p_s: torch.Tensor, o_s: torch.Tensor) -> torch.Tensor:
    """Per row of a merge sort of [build keys ++ probe keys], the index of the
    last build row at or before it (-1: none).  The build keys are sorted and
    the merge sort is stable, so build rows arrive in increasing index order:
    the last one is the running maximum of their indices."""
    return last_flagged(p_s == 0, o_s, -1)


def _iota(n: int, device, dtype=torch.int64) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device)


def _is_integral(t: torch.Tensor) -> bool:
    return t.dtype == torch.bool or not (t.dtype.is_floating_point or t.dtype.is_complex)


def _masked_min_max(values: torch.Tensor, mask: torch.Tensor):
    v = values.to(torch.int64)
    return (
        torch.where(mask, v, torch.full_like(v, _BIG)).min(),
        torch.where(mask, v, torch.full_like(v, -_BIG)).max(),
    )


def _fit_payload_plan(cols: Dict[str, Tuple], bounds_map):
    """(PackPlan, fields, bounds) packing every build output column (+ its
    validity bit) into one int64 word, or None when a column is not an
    integer, has no bounds, or the word would pass 63 bits."""
    from ..ops.sortkey import PackPlan

    fields: List[Tuple[str, str]] = []  # ('v'|'n', column name)
    bounds: List[Tuple[int, int]] = []
    for name, (values, validity) in cols.items():
        b = bounds_map.get(name)
        if not _is_integral(values) or b is None:
            return None
        fields.append(("v", name))
        bounds.append((int(b[0]), int(b[1])))
        if validity is not None:
            fields.append(("n", name))
            bounds.append((0, 1))
    plan = PackPlan.fit(bounds)
    if plan is None:
        return None
    return plan, tuple(fields), tuple(bounds)


@dataclasses.dataclass
class HashJoinExec:
    """Device-resident build state + probe application."""

    node: HashJoinNode
    build_keys: torch.Tensor  # [B] sorted normalized keys (invalid tail: sentinel)
    build_cols: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]  # sorted payloads
    build_size: int
    build_tables: Dict[str, object]
    normalizer: Optional[_NormalizedKey]  # None for single raw int64 key
    build_valid: torch.Tensor  # [B] live-slot mask
    # expansion (N:M) join state: per sorted-build-slot run info
    expansion: bool = False
    run_start: Optional[torch.Tensor] = None  # [B] first slot of this key's run
    run_count: Optional[torch.Tensor] = None  # [B] length of this key's run
    # host-known (min, max) of the VALID build keys: enables the packed
    # single-word probe sorts; None = unknown
    key_range: Optional[Tuple[int, int]] = None
    # two-limb composite keys (>62 bits): the HIGH limb rides here and every
    # key comparison tests both limbs; None for single-limb keys
    build_keys_hi: Optional[torch.Tensor] = None
    # null-aware ANTI state (reference: HashJoinNode nullAware): whether any
    # live build row carried a NULL key, and how many valid-key build rows
    # exist (an EMPTY build set means NOT IN () = true for every probe row,
    # null keys included)
    build_has_null_key: bool = False
    n_valid_build_keys: int = 0
    # Fused-probe build payload (see _probe_fused): every build output column
    # bit-packed into ONE int64 per build row, so propagating the last build
    # word carries the whole payload to matching probe rows with no gather.
    bp_plan: Optional[object] = None
    bp_packed: Optional[torch.Tensor] = None
    bp_fields: Optional[Tuple] = None
    # the fused probe emits build + probe rows; callers whose later shapes
    # are sized to the probe batch's capacity (the distributed rank-local
    # pipelines) turn it off and keep the capacity-preserving probe
    allow_fused: bool = True
    # set by the executor where no consumer reads the join's key order: the
    # probe then looks rows up in a hash table (_probe_hashed), built at the
    # first such probe
    hashed: bool = False
    _table: Optional[HashTable] = None

    probe_split_host = _not_ported("HashJoinExec.probe_split_host", "split dispatch")

    @property
    def device(self) -> torch.device:
        return self.build_keys.device

    def state_bytes(self) -> int:
        """Bytes of the device-resident build state (pool accounting)."""
        tensors = [
            self.build_keys, self.build_keys_hi, self.build_valid, self.bp_packed,
            self.run_start, self.run_count,
        ]
        for values, validity in self.build_cols.values():
            tensors += [values, validity]
        table = HashTable.nbytes(self.n_valid_build_keys) if self.hashed else 0
        return table + sum(t.numel() * t.element_size() for t in tensors if t is not None)

    def _prepare_build_payload(self, bounds_map) -> None:
        """Pack the build's non-key output columns (+ validity bits) into one
        int64 word per row when their combined bit-width allows — the fused
        probe then carries the payload through its last-build propagation instead of
        gathering per column.

        ``bounds_map``: per-column inclusive (lo, hi) integer bounds.  Any
        non-integer or unbounded column disables packing (tier-2 fallback:
        per-column gathers by candidate index)."""
        if not self.build_cols:
            return
        fitted = _fit_payload_plan(self.build_cols, bounds_map)
        if fitted is None:
            return
        plan, fields, bounds = fitted
        vals = []
        for (kind, name), (lo, hi) in zip(fields, bounds):
            values, validity = self.build_cols[name]
            if kind == "v":
                # clamp into bounds: padding slots / garbage-under-null must
                # not overflow into neighboring fields (they never match)
                vals.append(values.to(torch.int64).clamp(lo, hi))
            else:
                vals.append(validity.to(torch.int64))
        self.bp_packed = plan.pack(vals)
        self.bp_plan = plan
        self.bp_fields = fields

    @staticmethod
    def _check_node(node: HashJoinNode) -> None:
        if node.join_type not in (
            JoinType.INNER, JoinType.LEFT, JoinType.FULL, JoinType.LEFT_SEMI, JoinType.ANTI
        ):
            raise NotImplementedError(f"join type {node.join_type} is not ported yet")
        if node.filter is not None:
            # INNER / LEFT filters are stripped by _linearize; semi / anti
            # filters lower through rewrite_filtered_existence_joins —
            # reaching here means a lowering was skipped, and dropping the
            # filter would return wrong rows
            raise NotImplementedError(
                f"join filter on {node.join_type.value} must be lowered before "
                "execution (rewrite_filtered_existence_joins)"
            )

    @staticmethod
    def build(node: HashJoinNode, batches: Sequence[Batch], err_scalars) -> "HashJoinExec":
        """Construct the bridge from the build side's device batches (a
        collect pipeline's compacted tiles, or a host table's upload) and
        their per-tile error scalars.  The build is sorted on the batches'
        device; a handful of scalars (the counts, the error count, key and
        column ranges) are fetched in one read, two for a multi-column key,
        whose ranges size the packing.

        The sorted state is a power-of-two bucket: the valid keys, then (FULL
        only) the live rows with a NULL key under a sentinel that equals
        nothing, then dead slots; ``build_valid`` marks the rows kept.  Build
        rows with a NULL key never match (standard, non-null-aware join
        semantics; the reference's HashBuild drops them too).  Duplicate
        keys, or a FULL join, keep per-key runs for the expansion probe.
        """
        from ..utils.transfer import bucket_of, fetch_tree
        from .runner import _raise_on_errors

        HashJoinExec._check_node(node)
        right_schema = node.right.output_schema
        key_names = list(node.right_keys)
        semi = node.join_type in (JoinType.LEFT_SEMI, JoinType.ANTI)
        full = node.join_type == JoinType.FULL
        # FULL keeps the right KEY columns too: the unmatched-build tail
        # emits the real key values, not probe-side copies
        col_names = (
            []
            if semi
            else [
                n for n in node.output_columns
                if n in right_schema and (full or n not in key_names)
            ]
        )
        strings: Dict[str, object] = {}
        for b in batches:
            for name, col in zip(b.schema.names, b.columns):
                if col.strings is not None:
                    strings[name] = col.strings
        device = batches[0].device

        def concat_col(name):
            datas, valids = [], []
            for b in batches:
                v, val = b.column(name).decode(b.capacity)
                datas.append(v)
                valids.append(val)
            validity = None
            if any(v is not None for v in valids):
                validity = torch.cat(
                    [
                        v
                        if v is not None
                        else torch.ones((b.capacity,), dtype=torch.bool, device=device)
                        for v, b in zip(valids, batches)
                    ]
                )
            return torch.cat(datas), validity

        mask = torch.cat([b.active_mask() for b in batches])
        kvalid = mask
        keys = []
        for k in key_names:
            d, val = concat_col(k)
            keys.append(d.to(torch.int64))
            if val is not None:
                kvalid = kvalid & val
        if len(key_names) > 1:
            stats = [_masked_min_max(k, kvalid) for k in keys]
            mins, maxs = fetch_tree(
                (torch.stack([s[0] for s in stats]), torch.stack([s[1] for s in stats]))
            )
            normalizer = _NormalizedKey.fit_from_bounds(mins, maxs)
            (packed_hi, packed), _ = normalizer.pack_device_limbs(keys, kvalid)
        else:
            normalizer = None
            packed_hi, packed = None, keys[0]

        err = torch.zeros((), dtype=torch.int64, device=device)
        for e in err_scalars:
            err = err + e
        sentinel = torch.full_like(packed, _KEY_SENTINEL)
        packed = torch.where(kvalid, packed, sentinel)
        n_rows = packed.shape[0]
        orig = _iota(n_rows, device)
        # 0: a valid key, 1: a live row with a NULL key, 2: a dead slot
        rank = (~kvalid).to(torch.uint8) + (~mask).to(torch.uint8)
        if packed_hi is None:
            s_rank, s_key, s_orig = sort_operands((rank, packed, orig), num_keys=2)
            s_hi = None
        else:
            packed_hi = torch.where(kvalid, packed_hi, sentinel)
            s_rank, s_hi, s_key, s_orig = sort_operands(
                (rank, packed_hi, packed, orig), num_keys=3
            )
        s_valid = s_rank == 0
        prev_eq = s_valid & torch.roll(s_valid, 1) & (s_key == torch.roll(s_key, 1))
        if s_hi is not None:
            prev_eq = prev_eq & (s_hi == torch.roll(s_hi, 1))
        if n_rows:
            prev_eq[0] = False
        kmin, kmax = _masked_min_max(s_key, s_valid)
        n_null = (mask & ~kvalid).sum()
        cols: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
        int_cols: List[str] = []
        col_stats: List[torch.Tensor] = []
        if semi:
            keep = s_valid & ~prev_eq
            s_key = torch.where(keep, s_key, sentinel)
            if s_hi is None:
                s_key = torch.sort(s_key, stable=True).values
            else:
                s_hi, s_key = sort_operands(
                    (torch.where(keep, s_hi, sentinel), s_key), num_keys=2
                )
            n_valid = keep.sum()
            dup = torch.zeros_like(n_valid)
        else:
            n_valid = s_valid.sum()
            dup = prev_eq.sum()
            for name in col_names:
                data, validity = concat_col(name)
                g = data.index_select(0, s_orig)
                gv = None if validity is None else validity.index_select(0, s_orig)
                cols[name] = (g, gv)
                # per-integer-column (min, max) over live rows: feeds the
                # fused probe's packed payload, fetched with the counts below
                if _is_integral(g):
                    int_cols.append(name)
                    col_stats.extend(
                        _masked_min_max(g, s_valid if gv is None else (s_valid & gv))
                    )
        stats_vec = (
            torch.stack(col_stats)
            if col_stats
            else torch.zeros((0,), dtype=torch.int64, device=device)
        )
        n_valid, dup, err, kmin, kmax, n_null, st = fetch_tree(
            (n_valid, dup, err, kmin, kmax, n_null, stats_vec)
        )  # the build's one host read
        _raise_on_errors(int(err))
        n, n_null = int(n_valid), int(n_null)
        expansion = full or int(dup) > 0
        if expansion and s_hi is not None:
            raise JoinBuildError(
                "N:M / FULL joins with composite keys wider than 62 bits are "
                "not supported; pre-aggregate the build side"
            )
        live = n + n_null if full else n
        bucket = min(bucket_of(max(live, 1)), n_rows)
        slot = _iota(bucket, device)
        cut_sentinel = sentinel[:bucket]
        keys_cut = torch.where(slot < n, s_key[:bucket], cut_sentinel)
        keys_hi_cut = (
            None if s_hi is None else torch.where(slot < n, s_hi[:bucket], cut_sentinel)
        )
        run_start = run_count = None
        if expansion:
            # a run of equal keys starts at the last boundary at or before a
            # slot and ends at the first run end at or after it; slots past
            # the valid keys are runs of one
            starts = ~prev_eq[:bucket]
            ends = torch.ones_like(starts)
            ends[:-1] = starts[1:]
            run_start = last_flagged(starts, slot, -1)
            run_count = next_flagged(ends, slot, bucket) - run_start + 1
        out_cols = {
            name: (g[:bucket].clone(), None if gv is None else gv[:bucket].clone())
            for name, (g, gv) in cols.items()
        }
        exec_ = HashJoinExec(
            node, keys_cut, out_cols, bucket, strings, normalizer, slot < live,
            expansion=expansion,
            run_start=run_start,
            run_count=run_count,
            key_range=((int(kmin), int(kmax)) if n and keys_hi_cut is None else None),
            build_keys_hi=keys_hi_cut,
            build_has_null_key=n_null > 0,
            n_valid_build_keys=n,
        )
        if not expansion:
            bounds_map = {
                nm: (int(st[2 * i]), int(st[2 * i + 1]))
                for i, nm in enumerate(int_cols)
                if n and st[2 * i] <= st[2 * i + 1]
            }
            exec_._prepare_build_payload(bounds_map)
        return exec_

    # ---- sort-merge lookup --------------------------------------------
    def _lookup_sorted(
        self,
        probe_keys: torch.Tensor,
        probe_live: torch.Tensor,
        key_ok: torch.Tensor,
        probe_keys_hi: Optional[torch.Tensor] = None,
    ):
        """Match probe keys against the sorted build side.

        Returns (perm, pos, hit, live) of length cap, in **join-key order with
        live rows first**: perm[i] is the probe-row index occupying output slot
        i.  Emitting key-sorted output (instead of restoring probe order) costs
        the same second sort but leaves the batch pre-grouped for downstream
        aggregations — the engine's analog of the reference's streaming
        aggregation over sorted keys (velox/exec/StreamingAggregation.h).
        """
        cap = probe_keys.shape[0]
        B = self.build_size
        dev = probe_keys.device
        jt = self.node.join_type
        all_keys = torch.cat([self.build_keys, probe_keys])
        n_all = B + cap
        idxb = _index_bits(max(B, cap))
        orig = torch.cat([_iota(B, dev), _iota(cap, dev)])
        is_probe = torch.cat(
            [
                torch.zeros((B,), dtype=torch.int64, device=dev),
                torch.ones((cap,), dtype=torch.int64, device=dev),
            ]
        )
        packed = False
        if self.key_range is not None:
            # packed fast path: key codes (bounded by the build key range),
            # the probe flag, and the per-class row index share one int64
            lo, hi = self.key_range
            span = hi - lo + 2
            packed = int(span).bit_length() + 1 + idxb <= 63
        if packed:
            code = _key_codes(all_keys, lo, span)
            merged = (code << (1 + idxb)) | (is_probe << idxb) | orig
            s = torch.sort(merged, stable=True).values
            o_s = s & ((1 << idxb) - 1)
            p_s = (s >> idxb) & 1
            # RAW-key equality: immune to out-of-range code collisions
            k_s = _take(probe_keys, o_s)
            h_s = None
        elif self.build_keys_hi is not None:
            # two-limb composite keys (>62 bits): sort by (hi, lo, is_probe)
            # — matches the build's lexsort order — and the equality test
            # covers BOTH limbs
            all_hi = torch.cat([self.build_keys_hi, probe_keys_hi])
            h_s, k_s, p_s, o_s = sort_operands(
                (all_hi, all_keys, is_probe, orig), num_keys=3
            )
        else:
            # sort by (key, is_probe): build rows precede equal probe keys
            k_s, p_s, o_s = sort_operands((all_keys, is_probe, orig), num_keys=2)
            h_s = None
        last_build = _last_build_row(p_s, o_s)
        cand = last_build.clamp(0, B - 1)
        hit = (p_s == 1) & (last_build >= 0) & (_take(self.build_keys, cand) == k_s)
        if h_s is not None:
            hit = hit & (_take(self.build_keys_hi, cand) == h_s)
        # the build pads to a bucket; its dead slots never match
        hit = hit & _take(self.build_valid, cand)
        # null/out-of-range probe keys never match
        ok_s = _take(key_ok, o_s)
        hit = hit & ok_s
        # classify: live probe rows first (key-ordered), dead probe rows next,
        # build rows last; one stable flag sort compacts all three classes
        live_s = (p_s == 1) & _take(probe_live, o_s)
        if jt in (JoinType.INNER, JoinType.LEFT_SEMI):
            live_s = live_s & hit
        elif jt == JoinType.ANTI:
            live_s = live_s & ~hit
            if self.node.null_aware and self.n_valid_build_keys > 0:
                # NOT IN over a non-empty set: a NULL probe key compares
                # unknown against every element -> the row never passes
                live_s = live_s & ok_s
        # LEFT: probe-preserving — every live probe row stays live
        flag = torch.where(p_s == 0, 2, torch.where(live_s, 0, 1)).to(torch.uint8)
        perm2 = torch.sort(flag, stable=True).indices[:cap]
        return (
            o_s.index_select(0, perm2),
            cand.index_select(0, perm2),
            hit.index_select(0, perm2),
            live_s.index_select(0, perm2),
        )

    def _probe_keys(self, batch: Batch):
        """((hi|None, lo) probe key limbs, no-NULL-key mask, that mask
        narrowed to keys inside the build's ranges, raw key values)."""
        cap = batch.capacity
        probe_vals: List[torch.Tensor] = []
        not_null = torch.ones((cap,), dtype=torch.bool, device=batch.device)
        for k in self.node.left_keys:
            values, validity = batch.column(k).decode(cap)
            probe_vals.append(values)
            if validity is not None:
                not_null = not_null & validity
        if self.normalizer is None:
            return (None, probe_vals[0].to(torch.int64)), not_null, not_null, probe_vals
        limbs, key_ok = self.normalizer.pack_device_limbs(probe_vals, not_null)
        return limbs, not_null, key_ok, probe_vals

    # ---- expansion (N:M) probe: spans + expand ------------------------------
    def probe_spans(self, batch: Batch):
        """Phase 1 of an expansion join: per probe row (in the batch's order)
        the matching build run.  Returns (sizes, starts, hit, total) with
        ``total`` the 0-d count of output rows; a FULL join adds the [B]
        flags of the build rows this batch matched."""
        assert self.expansion
        cap = batch.capacity
        B = self.build_size
        dev = batch.device
        jt = self.node.join_type
        (_, probe_keys), _, key_ok, _ = self._probe_keys(batch)
        live = batch.active_mask()
        all_keys = torch.cat([self.build_keys, probe_keys])
        is_probe = torch.cat(
            [torch.zeros((B,), dtype=torch.int64, device=dev),
             torch.ones((cap,), dtype=torch.int64, device=dev)]
        )
        orig = torch.cat([_iota(B, dev), _iota(cap, dev)])
        idxb = _index_bits(max(B, cap))
        packed = False
        if self.key_range is not None:
            lo, hi = self.key_range
            span = hi - lo + 2
            packed = int(span).bit_length() + 1 + idxb <= 63
        if packed:
            # one packed word: (key code, is_probe, row index)
            merged = (_key_codes(all_keys, lo, span) << (1 + idxb)) | (is_probe << idxb) | orig
            s = torch.sort(merged, stable=True).values
            o_s = s & ((1 << idxb) - 1)
            p_s = (s >> idxb) & 1
            k_s = _take(probe_keys, o_s)  # RAW keys: immune to code collisions
        else:
            k_s, p_s, o_s = sort_operands((all_keys, is_probe, orig), num_keys=2)
        last_build = _last_build_row(p_s, o_s)
        cand = last_build.clamp(0, B - 1)
        hit_s = (p_s == 1) & (last_build >= 0) & (_take(self.build_keys, cand) == k_s)
        hit_s = hit_s & _take(self.build_valid, cand)  # dead slots never match
        # back to the batch's row order: probe rows hold distinct row ids, so
        # a scatter places each one (build rows go to a spare slot); the JAX
        # package sorts again by (is_build, row id) to the same effect
        slot = torch.where(p_s == 1, o_s, torch.full_like(o_s, cap))
        cand_p = torch.zeros((cap + 1,), dtype=torch.int64, device=dev).scatter_(0, slot, cand)[:cap]
        hit_p = torch.zeros((cap + 1,), dtype=torch.bool, device=dev).scatter_(0, slot, hit_s)[:cap]
        hit = hit_p & key_ok & live
        starts = _take(self.run_start, cand_p)
        counts = _take(self.run_count, cand_p)
        if jt in (JoinType.LEFT, JoinType.FULL):
            sizes = torch.where(live, torch.where(hit, counts, torch.ones_like(counts)),
                                torch.zeros_like(counts))
        else:  # INNER
            sizes = torch.where(hit, counts, torch.zeros_like(counts))
        if jt != JoinType.FULL:
            return sizes, starts, hit, sizes.sum()
        # FULL: a build row is matched when a hit probe row owns its key's
        # run, i.e. the run's start; one scatter marks the starts of the
        # hit runs and a gather by run start spreads the mark over each run.
        # The JAX package merges the keys once more, probes before equal
        # build keys, and routes the flags back by a sort; the flags are
        # the same.  Null-key build rows (the sentinel) match nothing.
        marks = torch.zeros((B + 1,), dtype=torch.bool, device=dev)
        marks.scatter_(0, torch.where(hit, starts, torch.full_like(starts, B)), hit)
        matched = marks[:B].index_select(0, self.run_start) & (self.build_keys != _KEY_SENTINEL)
        return sizes, starts, hit, sizes.sum(), matched

    def expand(self, batch: Batch, spans, out_cap: int) -> Batch:
        """Phase 2: materialize the joined rows into an [out_cap] batch (one
        row per probe row and matching build row; an unmatched LEFT row once,
        with the build side NULL)."""
        from ..ops.segpool import dense_starts, owner_rows

        node = self.node
        cap = batch.capacity
        jt = node.join_type
        sizes, run_starts, hit = spans[0], spans[1], spans[2]
        out_starts = dense_starts(sizes)
        total = out_starts[-1] + sizes[-1]
        rowid = owner_rows(out_starts, out_cap)
        pos = _iota(out_cap, batch.device)
        offset = pos - _take(out_starts, rowid)
        build_pos = (_take(run_starts, rowid) + offset).clamp(0, self.build_size - 1)
        row_hit = _take(hit, rowid)

        left_schema = node.left.output_schema
        right_key_to_left = dict(zip(node.right_keys, node.left_keys))
        out_cols: List[Column] = []
        for name, dtype in zip(node.output_schema.names, node.output_schema.types):
            if name in left_schema:
                out_cols.append(batch.column(name).flatten(cap).gather(rowid))
            elif name in right_key_to_left:
                # a right key equals the probe's key on matched rows
                src = batch.column(right_key_to_left[name])
                values, _ = src.decode(cap)
                gv = row_hit if jt in (JoinType.LEFT, JoinType.FULL) else None
                out_cols.append(
                    Column.flat(_take(values, rowid).to(dtype.device_dtype), dtype, gv, src.strings)
                )
            else:
                values, validity = self.build_cols[name]
                g = _take(values, build_pos)
                gv = None if validity is None else _take(validity, build_pos)
                if jt in (JoinType.LEFT, JoinType.FULL):
                    gv = row_hit if gv is None else (gv & row_hit)
                out_cols.append(Column.flat(g, dtype, gv, self.build_tables.get(name)))
        return Batch(
            tuple(out_cols),
            total.to(torch.int32),
            None,
            node.output_schema,
            out_cap,
        )

    # ---- FULL join: the unmatched-build tail --------------------------------
    def init_matched(self) -> torch.Tensor:
        """[B] matched flags before the first tile: none."""
        return torch.zeros((self.build_size,), dtype=torch.bool, device=self.device)

    def full_tail(self, matched: torch.Tensor) -> Batch:
        """The FULL join's last batch: the build rows no tile matched (the
        null-key rows among them), compacted to the front, the probe side
        NULL.  Its capacity is the build size."""
        from ..ops.compact import compaction_indices

        node = self.node
        B = self.build_size
        dev = self.device
        perm, count = compaction_indices(~matched & self.build_valid)
        left_schema = node.left.output_schema
        out_cols: List[Column] = []
        for name, dtype in zip(node.output_schema.names, node.output_schema.types):
            if name in self.build_cols:
                values, validity = self.build_cols[name]
                g = _take(values, perm)
                gv = None if validity is None else _take(validity, perm)
                out_cols.append(Column.flat(g, dtype, gv, self.build_tables.get(name)))
            elif name in left_schema:
                out_cols.append(Column.flat(
                    torch.zeros((B,), dtype=dtype.device_dtype, device=dev),
                    dtype,
                    torch.zeros((B,), dtype=torch.bool, device=dev),
                ))
            else:
                raise KeyError(f"FULL join: no build column for {name!r}")
        return Batch(tuple(out_cols), count, None, node.output_schema, B)

    # ---- fused probe ----------------------------------------------------
    def _probe_fused(self, batch: Batch) -> Optional[Batch]:
        """ONE merge sort + one last-build propagation.

          1. packs (key code | is_probe | live | key-valid | ok | low) into
             one int64 word per row — build rows put their ENTIRE bit-packed
             payload (bp_packed) in the low field, probe rows their row id;
          2. sorts ONCE; the probe's output columns follow through the sort's
             permutation (build slots hold the build key so downstream
             presorted grouping sees intact runs);
          3. one pass propagates the last build word to each probe row: the
             candidate's key code AND payload arrive in one scan — the
             reference's equivalent is its vectorized hash-table probe
             (velox/exec/HashTable.cpp:360);
          4. emits the batch in MERGED order (capacity B + cap) with build
             slots masked dead — no reorder sort; downstream operators handle
             selection masks and the output stays key-sorted for the
             presorted-aggregation path.

        Returns None (statically) when preconditions fail; the caller falls
        back to the classification-sort path."""
        plan = self._fused_static(batch.capacity)
        if plan is None:
            return None
        word, ops, vbits, meta = self._fused_pre(batch, plan)
        s, perm = torch.sort(word, stable=True)
        moved = tuple(op.index_select(0, perm) for op in tuple(ops) + tuple(vbits))
        return self._fused_post(plan, s, moved, meta, bool(vbits))

    def _fused_static(self, cap: int):
        """Static eligibility + bit-layout plan for the fused probe.
        None = not eligible."""
        node = self.node
        B = self.build_size
        if self.expansion or B == 0 or self.key_range is None:
            return None
        if self.build_keys_hi is not None or not self.allow_fused:
            return None
        left_schema = node.left.output_schema
        right_key_to_left = dict(zip(node.right_keys, node.left_keys))
        out_build = [
            n
            for n in node.output_columns
            if n in self.build_cols
            and not (n in left_schema or n in right_key_to_left)
        ]
        # complex-typed probe columns cannot ride as flat sort operands
        for name in node.output_columns:
            if name in left_schema and left_schema.type_of(name).is_complex:
                return None
        idxb = _index_bits(cap)
        tier1 = (not out_build) or (self.bp_plan is not None)
        if tier1:
            pb = self.bp_plan.total_bits if (out_build and self.bp_plan) else 0
            L = max(idxb, pb)
        else:
            L = max(idxb, _index_bits(B))
        lo, hi = self.key_range
        span = hi - lo + 2
        kb = int(span).bit_length()
        if kb + 4 + L > 63:
            if tier1 and out_build:
                # retry without the packed payload (tier 2 gathers instead)
                tier1 = False
                L = max(idxb, _index_bits(B))
                if kb + 4 + L > 63:
                    return None
            else:
                return None
        # the left columns the output needs
        needed_left: List[str] = []
        for name in node.output_schema.names:
            ln = name if name in left_schema else right_key_to_left.get(name)
            if ln is not None and ln not in needed_left:
                needed_left.append(ln)
        return {
            "cap": cap,
            "B": B,
            "tier1": tier1,
            "L": L,
            "lo": lo,
            "span": span,
            "out_build": out_build,
            "needed_left": needed_left,
            "left_schema": left_schema,
            "right_key_to_left": right_key_to_left,
        }

    def probe_output_capacity(self, cap: int) -> int:
        """Output capacity of probe() for a probe batch of capacity cap."""
        if self._fused_static(cap) is not None:
            return self.build_size + cap
        return cap

    def _fused_pre(self, batch: Batch, plan):
        """Everything before the fused probe's sort: packed words + the probe
        columns that follow the sort.  Returns (word, ops, vbits_tuple, meta)
        with meta: left name -> (op index, validity bit | -1, strings)."""
        node = self.node
        cap, B, L = plan["cap"], plan["B"], plan["L"]
        tier1 = plan["tier1"]
        lo, span = plan["lo"], plan["span"]
        out_build = plan["out_build"]
        dev = batch.device

        # ---- probe keys + masks
        (_, probe_keys), vb, ok, _ = self._probe_keys(batch)
        live = batch.active_mask()

        code_b = _key_codes(self.build_keys, lo, span)
        pcode = _key_codes(probe_keys, lo, span)
        ok = ok & (pcode >= 1) & (pcode <= span - 1)

        if tier1 and out_build:
            low_b = self.bp_packed
        elif tier1:
            low_b = torch.zeros((B,), dtype=torch.int64, device=dev)
        else:
            low_b = _iota(B, dev)
        word_b = (code_b << (4 + L)) | low_b
        flags = 8 | (live.to(torch.int64) << 2) | (vb.to(torch.int64) << 1) | ok.to(torch.int64)
        word_p = (((pcode << 4) | flags) << L) | _iota(cap, dev)
        word = torch.cat([word_b, word_p])

        # ---- carried probe columns (the left side of every output column)
        ops: List[torch.Tensor] = []
        meta = {}
        vbits = None
        bit = 0
        single_key = self.normalizer is None
        for ln in plan["needed_left"]:
            col = batch.column(ln)
            values, validity = col.decode(cap)
            if single_key and ln == node.left_keys[0]:
                # build slots keep their own key value so runs of equal keys
                # stay contiguous through dead slots (presorted grouping)
                pad = self.build_keys.to(values.dtype)
            else:
                pad = torch.zeros((B,), dtype=values.dtype, device=dev)
            ops.append(torch.cat([pad, values]))
            vbit = -1
            if validity is not None:
                add = torch.cat(
                    [torch.zeros((B,), dtype=torch.int64, device=dev), validity.to(torch.int64)]
                )
                vbits = add << bit if vbits is None else vbits | (add << bit)
                vbit = bit
                bit += 1
            meta[ln] = (len(ops) - 1, vbit, col.strings)
        return word, tuple(ops), (vbits,) if vbits is not None else (), meta

    def _fused_post(self, plan, s: torch.Tensor, payloads, meta, has_vbits: bool):
        """Everything after the fused probe's sort: the candidate build word
        per probe row + output-column assembly in merged order."""
        node = self.node
        jt = node.join_type
        cap, B, L = plan["cap"], plan["B"], plan["L"]
        tier1 = plan["tier1"]
        left_schema = plan["left_schema"]
        right_key_to_left = plan["right_key_to_left"]
        out_vbits = payloads[-1] if has_vbits else None

        # ---- one scan: candidate build word per probe row
        is_probe = ((s >> (3 + L)) & 1).to(torch.bool)
        # ``s`` is sorted, so the last build word is the running maximum of
        # the build words (build words are non-negative: -1 = none)
        lastb = last_flagged(~is_probe, s, -1)
        own_code = s >> (4 + L)
        cand_code = lastb >> (4 + L)  # -1 rows: negative, never equal
        live_s = ((s >> (2 + L)) & 1).to(torch.bool)
        vb_s = ((s >> (1 + L)) & 1).to(torch.bool)
        ok_s = ((s >> L) & 1).to(torch.bool)
        hit = is_probe & ok_s & (lastb >= 0) & (cand_code == own_code)

        if jt in (JoinType.INNER, JoinType.LEFT_SEMI):
            live_out = live_s & hit
        elif jt == JoinType.ANTI:
            live_out = live_s & ~hit
            if node.null_aware and self.n_valid_build_keys > 0:
                # NOT IN over a non-empty set: a NULL probe key compares
                # unknown against every element -> never passes (out-of-range
                # NON-null keys do pass — they are definitely not in the set)
                live_out = live_out & vb_s
        else:  # LEFT: probe-preserving
            live_out = live_s
        live_out = live_out & is_probe

        # ---- output columns, merged order
        lastb_low = lastb & ((1 << L) - 1)
        n_all = B + cap
        out_cols: List[Column] = []
        for name, dtype in zip(node.output_schema.names, node.output_schema.types):
            if name in left_schema:
                i, vbit, strings = meta[name]
                gv = None if vbit < 0 else ((out_vbits >> vbit) & 1).to(torch.bool)
                out_cols.append(Column.flat(payloads[i], dtype, gv, strings))
            elif name in right_key_to_left:
                i, _, _ = meta[right_key_to_left[name]]
                validity = hit if jt == JoinType.LEFT else None
                out_cols.append(
                    Column.flat(payloads[i].to(dtype.device_dtype), dtype, validity)
                )
            else:  # build column
                values, validity = self.build_cols[name]
                if tier1:
                    fi = self.bp_fields.index(("v", name))
                    g = self.bp_plan.unpack(lastb_low, fi).to(dtype.device_dtype)
                    gv = None
                    if ("n", name) in self.bp_fields:
                        ni = self.bp_fields.index(("n", name))
                        gv = self.bp_plan.unpack(lastb_low, ni) != 0
                else:
                    g = _take(values, lastb_low)
                    gv = None if validity is None else _take(validity, lastb_low)
                if jt == JoinType.LEFT:
                    gv = hit if gv is None else (gv & hit)
                out_cols.append(Column.flat(g, dtype, gv, self.build_tables.get(name)))
        return Batch(
            tuple(out_cols),
            torch.full((), n_all, dtype=torch.int32, device=s.device),
            live_out,
            node.output_schema,
            n_all,
        )

    # ---- hashed probe ---------------------------------------------------
    def hashable(self) -> bool:
        """Whether the hashed probe can serve this join: the build is
        unique, in one key limb and not a distributed rank-local one."""
        return (
            self.allow_fused and not self.expansion
            and self.build_keys_hi is None and self.build_size > 0
        )

    def _hashed_keys(self, batch: Batch):
        """(probe keys, the rows whose key may match, the rows whose key is
        not NULL): a single key in its stored width where its column is flat,
        a composite key packed as the build packed it."""
        cap = batch.capacity
        if self.normalizer is None:
            col = batch.column(self.node.left_keys[0])
            stored = col.encoding == Encoding.FLAT and col.data.dtype in (
                torch.int8, torch.int16, torch.int32, torch.int64
            )
            keys, validity = (col.data, col.validity) if stored else col.decode(cap)
            return keys, validity, validity
        (_, packed), not_null, key_ok, _ = self._probe_keys(batch)
        return packed, key_ok, not_null

    def _probe_hashed(self, batch: Batch) -> Batch:
        """One lookup a probe row in a hash table of the build keys (K5).

        The output keeps the probe batch's rows, order and capacity: left
        columns pass through, a right key takes its left key's values, build
        columns come from the matched slot (the packed payload where there
        is one).  Selection and validity follow ``_fused_post``."""
        node = self.node
        jt = node.join_type
        cap = batch.capacity
        if self._table is None:
            n = self.n_valid_build_keys
            lo, hi = self.key_range if self.key_range is not None else (1, 0)
            self._table = build_hash_table(self.build_keys[:n], lo, hi)
        keys, key_ok, not_null = self._hashed_keys(batch)
        dense = lambda t: None if t is None else t.contiguous()  # noqa: E731
        slot = hash_probe(
            self._table, keys.contiguous(), batch.length.to(torch.int32),
            dense(batch.selection), dense(key_ok),
        )
        hit = slot >= 0
        if jt in (JoinType.INNER, JoinType.LEFT_SEMI):
            selection = hit
        elif jt == JoinType.ANTI:
            selection = ~hit
            if node.null_aware and self.n_valid_build_keys > 0 and not_null is not None:
                # NOT IN over a non-empty set: a NULL probe key never passes
                selection = selection & not_null
            if batch.selection is not None:
                selection = selection & batch.selection
        else:  # LEFT: probe-preserving
            selection = batch.selection
        idx = slot.clamp(min=0)
        word = None
        left_schema = node.left.output_schema
        right_key_to_left = dict(zip(node.right_keys, node.left_keys))
        out_cols: List[Column] = []
        for name, dtype in zip(node.output_schema.names, node.output_schema.types):
            if name in left_schema:
                out_cols.append(batch.column(name))
                continue
            if name in right_key_to_left:
                src = batch.column(right_key_to_left[name])
                values, _ = src.decode(cap)
                validity = hit if jt == JoinType.LEFT else None
                out_cols.append(
                    Column.flat(values.to(dtype.device_dtype), dtype, validity, src.strings)
                )
                continue
            values, validity = self.build_cols[name]
            if self.bp_plan is not None:
                if word is None:
                    word = self.bp_packed.index_select(0, idx)
                g = self.bp_plan.unpack(word, self.bp_fields.index(("v", name)))
                g = g.to(dtype.device_dtype)
                gv = None
                if ("n", name) in self.bp_fields:
                    gv = self.bp_plan.unpack(word, self.bp_fields.index(("n", name))) != 0
            else:
                g = values.index_select(0, idx)
                gv = None if validity is None else validity.index_select(0, idx)
            if jt == JoinType.LEFT:
                gv = hit if gv is None else (gv & hit)
            out_cols.append(Column.flat(g, dtype, gv, self.build_tables.get(name)))
        return Batch(
            tuple(out_cols), batch.length, selection, node.output_schema, cap, batch.row_offset
        )

    # ---- probe ---------------------------------------------------------
    def probe(self, batch: Batch) -> Batch:
        assert not self.expansion, "expansion joins go through probe_spans / expand"
        node = self.node
        cap = batch.capacity
        dev = batch.device
        left_schema = node.left.output_schema
        jt = node.join_type
        if node.null_aware and self.build_has_null_key:
            # NOT IN (..., NULL): x NOT IN S is never TRUE when S holds a
            # NULL (it is FALSE or UNKNOWN) — the whole result is empty
            out_cols = [batch.column(n) for n in node.output_schema.names]
            return Batch(
                tuple(out_cols),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((cap,), dtype=torch.bool, device=dev),
                node.output_schema,
                cap,
            )

        if self.hashed:
            return self._probe_hashed(batch)
        fused = self._probe_fused(batch)
        if fused is not None:
            return fused

        (probe_keys_hi, probe_keys), _, key_ok, probe_vals = self._probe_keys(batch)
        perm, pos, hit, live = self._lookup_sorted(
            probe_keys, batch.active_mask(), key_ok, probe_keys_hi
        )

        out_cols: List[Column] = []
        right_key_to_left = dict(zip(node.right_keys, node.left_keys))
        for name, dtype in zip(node.output_schema.names, node.output_schema.types):
            if name in left_schema:
                col = batch.column(name)
                if dtype.is_complex:
                    # ARRAY/MAP/ROW probe columns: spans move with the rows,
                    # element pools stay put (as in the expansion probe)
                    out_cols.append(col.flatten(cap).gather(perm))
                    continue
                values, validity = col.decode(cap)
                g = _take(values, perm)
                gv = None if validity is None else _take(validity, perm)
                out_cols.append(Column.flat(g, dtype, gv, col.strings))
            elif name in right_key_to_left:
                # a right key equals the corresponding left key on matched rows
                left_name = right_key_to_left[name]
                values = _take(
                    probe_vals[list(node.left_keys).index(left_name)], perm
                )
                validity = hit if jt == JoinType.LEFT else None
                out_cols.append(
                    Column.flat(values.to(dtype.device_dtype), dtype, validity)
                )
            else:
                values, validity = self.build_cols[name]
                gathered = _take(values, pos)
                gv = None if validity is None else _take(validity, pos)
                if jt == JoinType.LEFT:
                    gv = hit if gv is None else (gv & hit)
                out_cols.append(
                    Column.flat(gathered, dtype, gv, self.build_tables.get(name))
                )
        # rows were re-ordered: live rows form a key-sorted prefix; the batch's
        # length/selection are rebuilt from the lookup's liveness
        return Batch(
            tuple(out_cols),
            torch.full((), cap, dtype=torch.int32, device=dev),
            live,
            node.output_schema,
            cap,
        )


# ---------------------------------------------------------------------------
# Non-equi filters on existence joins and N:M LEFT joins: plan rewrites


def _filter_refs(e) -> set:
    from ..expr.ir import FieldAccess

    out = set()

    def walk(x):
        if isinstance(x, FieldAccess):
            out.add(x.name)
        for c in x.children:
            walk(c)

    walk(e)
    return out


def rewrite_filtered_existence_joins(node):
    """Lower LEFT_SEMI / ANTI joins that carry a non-equi filter.

    The reference evaluates the filter per candidate match inside HashProbe
    (velox/exec/HashProbe.cpp filter evaluation); this engine's existence
    joins deduplicate the build side and keep a single candidate per probe
    row, so a filter needs ALL matches.  Rewrite (plan-level, before
    linearization):

        uid     = AssignUniqueId(probe)
        matched = distinct uids of (uid INNER JOIN build ON keys, filter f)
        result  = uid SEMI/ANTI JOIN matched ON uid

    The probe subtree executes twice (once inside ``matched``); uids derive
    from global row offsets, so both executions agree.  RIGHT_SEMI flips to
    LEFT_SEMI first (the same lowering _linearize applies).  A filtered FULL
    or null-aware ANTI join lowers through ``rewrite_full_filter`` /
    ``rewrite_null_aware_anti_filter``.  The rewrite walks every input of a
    node (UNION ALL and MergeExchange inputs too).
    """
    from ..plan.nodes import (
        AggregationNode,
        AggregationStep,
        AssignUniqueIdNode,
        PlanNode,
    )

    kids = {}
    for attr in ("source", "left", "right"):
        child = getattr(node, attr, None)
        if isinstance(child, PlanNode):
            kids[attr] = rewrite_filtered_existence_joins(child)
    inputs = getattr(node, "inputs", None)
    if inputs and all(isinstance(i, PlanNode) for i in inputs):
        kids["inputs"] = tuple(rewrite_filtered_existence_joins(i) for i in inputs)
    if kids:
        node = dataclasses.replace(node, **kids)
    if not isinstance(node, HashJoinNode) or node.filter is None:
        return node
    jt = node.join_type
    if jt == JoinType.RIGHT_SEMI:
        node = dataclasses.replace(
            node,
            left=node.right,
            right=node.left,
            left_keys=node.right_keys,
            right_keys=node.left_keys,
            join_type=JoinType.LEFT_SEMI,
        )
        jt = JoinType.LEFT_SEMI
    if jt == JoinType.FULL:
        return rewrite_full_filter(node)
    if jt not in (JoinType.LEFT_SEMI, JoinType.ANTI):
        return node
    if node.null_aware:
        return rewrite_null_aware_anti_filter(node)
    uid_name = f"__ejf_{node.id}"
    probe, build = node.left, node.right
    uid = AssignUniqueIdNode(probe, uid_name)
    # the INNER join's output must carry every column the filter reads
    # (_linearize evaluates the filter above the join)
    refs = _filter_refs(node.filter)
    inner_out = [uid_name] + [
        c
        for c in refs
        if c != uid_name and (c in probe.output_schema or c in build.output_schema)
    ]
    inner = HashJoinNode(
        uid, build, JoinType.INNER, node.left_keys, node.right_keys,
        tuple(inner_out), node.filter,
    )
    matched = AggregationNode(inner, AggregationStep.SINGLE, (uid_name,), (), ())
    return HashJoinNode(
        uid, matched, jt, (uid_name,), (uid_name,), tuple(node.output_columns),
        id=node.id,
    )


def rewrite_left_filter_nm(node: HashJoinNode) -> HashJoinNode:
    """LEFT join + non-equi filter over a duplicate-key (N:M) build.

    The single-candidate null-out path (the executor's ``left_join_filter``
    step) cannot see all matches, so lower to supported primitives (reference
    behavior: HashProbe evaluates the filter per expanded match and emits the
    probe row null-extended when every match fails):

        uid     = AssignUniqueId(probe)
        inner   = uid INNER JOIN build ON keys, filter f   (N:M, filtered)
        result  = uid LEFT JOIN inner ON uid               (N:M, no filter)
    """
    from ..plan.nodes import AssignUniqueIdNode

    if node.join_type == JoinType.RIGHT:
        node = dataclasses.replace(
            node,
            left=node.right,
            right=node.left,
            left_keys=node.right_keys,
            right_keys=node.left_keys,
            join_type=JoinType.LEFT,
        )
    assert node.join_type == JoinType.LEFT and node.filter is not None
    uid_name = f"__ljf_{node.id}"
    uid = AssignUniqueIdNode(node.left, uid_name)
    ls = node.left.output_schema
    rs = node.right.output_schema
    refs = _filter_refs(node.filter)
    inner_out = [uid_name] + [
        c
        for c in dict.fromkeys(list(node.output_columns) + sorted(refs))
        if c in rs or (c in refs and c in ls)
    ]
    inner = HashJoinNode(
        uid, node.right, JoinType.INNER, node.left_keys, node.right_keys,
        tuple(inner_out), node.filter,
    )
    return HashJoinNode(
        uid, inner, JoinType.LEFT, (uid_name,), (uid_name,),
        tuple(node.output_columns), id=node.id + "_ljf",
    )


def rewrite_null_aware_anti_filter(node: HashJoinNode) -> "PlanNode":
    """Null-aware ANTI join (NOT IN) carrying a non-equi filter.

    Reference semantics (velox/exec/HashProbe.cpp null-aware anti-join filter
    handling): a probe row is emitted iff NO build row b satisfies
    ``(keys equal OR probe key IS NULL OR build key IS NULL) AND filter(p,b)``
    — a NULL on either side makes the key comparison UNKNOWN, which NOT IN
    treats as a possible match, but the filter can still disqualify it.
    Lowered to supported primitives:

        uid = AssignUniqueId(probe)
        m1  = distinct uid of (uid INNER JOIN build ON keys, filter)
        m2  = distinct uid of (uid CROSS build[key IS NULL], filter)
        m3  = distinct uid of (uid[key IS NULL] CROSS build, filter)
        out = uid ANTI JOIN (m1 UNION ALL m2 UNION ALL m3) ON uid

    The cross joins only touch the NULL-key subsets (m2's build side, m3's
    probe side), so they stay small in practice.
    """
    from ..dtypes import BIGINT, BOOLEAN
    from ..expr.ir import Call, Constant, FieldAccess, Special, SpecialForm
    from ..plan.nodes import (
        AggregationNode,
        AggregationStep,
        AssignUniqueIdNode,
        FilterNode,
        ProjectNode,
        UnionAllNode,
    )

    probe, build = node.left, node.right
    ls, rs = probe.output_schema, build.output_schema
    uid_name = f"__naf_{node.id}"
    uid = AssignUniqueIdNode(probe, uid_name)
    refs = _filter_refs(node.filter)
    probe_cols = [uid_name] + [c for c in refs if c in ls or c in node.left_keys]
    build_cols = [c for c in rs.names if c in refs or c in node.right_keys]
    inner_out = tuple(dict.fromkeys(probe_cols + build_cols))

    def distinct_uids(join):
        return AggregationNode(join, AggregationStep.SINGLE, (uid_name,), (), ())

    def any_null(schema, keys):
        tests = [
            Call(BOOLEAN, "is_null", (FieldAccess(schema.type_of(k), k),))
            for k in keys
        ]
        return tests[0] if len(tests) == 1 else Special(BOOLEAN, SpecialForm.OR, tuple(tests))

    def with_const_key(src, cols, key_name):
        names, exprs = [], []
        for c in cols:
            names.append(c)
            exprs.append(FieldAccess(src.output_schema.type_of(c), c))
        names.append(key_name)
        exprs.append(Constant(BIGINT, 1))
        return ProjectNode(src, tuple(names), tuple(exprs))

    def cross_matches(left_src, right_src):
        xl, xr = f"__naf_xl_{node.id}", f"__naf_xr_{node.id}"
        cl = with_const_key(left_src, probe_cols, xl)
        cr = with_const_key(right_src, build_cols, xr)
        join = HashJoinNode(cl, cr, JoinType.INNER, (xl,), (xr,), inner_out, node.filter)
        return distinct_uids(join)

    m1 = distinct_uids(
        HashJoinNode(
            uid, build, JoinType.INNER, node.left_keys, node.right_keys,
            inner_out, node.filter,
        )
    )
    m2 = cross_matches(uid, FilterNode(build, any_null(rs, node.right_keys)))
    m3 = cross_matches(FilterNode(uid, any_null(ls, node.left_keys)), build)
    matched = UnionAllNode((m1, m2, m3))
    return HashJoinNode(
        uid, matched, JoinType.ANTI, (uid_name,), (uid_name,),
        tuple(node.output_columns), id=node.id,
    )


def rewrite_full_filter(node: HashJoinNode) -> "PlanNode":
    """FULL join + non-equi filter: matched pairs failing the filter count as
    unmatched on BOTH sides (reference: HashProbe filter + the FULL epilogue
    re-checking match flags).  Lowered to supported primitives:

        uidl  = AssignUniqueId(probe);  uidr = AssignUniqueId(build)
        inner = uidl INNER JOIN uidr ON keys, filter f
        left  = uidl LEFT JOIN inner ON uidl       (probe side + matches)
        ub    = uidr ANTI inner ON uidr            (builds with no pass)
        out   = left UNION ALL project(ub, probe cols as typed NULLs)
    """
    from ..expr.ir import Constant, FieldAccess
    from ..plan.nodes import AssignUniqueIdNode, ProjectNode, UnionAllNode

    ul, ur = f"__ffl_{node.id}", f"__ffr_{node.id}"
    uidl = AssignUniqueIdNode(node.left, ul)
    uidr = AssignUniqueIdNode(node.right, ur)
    ls, rs = node.left.output_schema, node.right.output_schema
    refs = _filter_refs(node.filter)
    inner_out = [ul, ur] + [
        c
        for c in dict.fromkeys(list(node.output_columns) + sorted(refs))
        if c in rs or (c in refs and c in ls)
    ]
    inner = HashJoinNode(
        uidl, uidr, JoinType.INNER, node.left_keys, node.right_keys,
        tuple(inner_out), node.filter,
    )
    left = HashJoinNode(uidl, inner, JoinType.LEFT, (ul,), (ul,), tuple(node.output_columns))
    build_cols = [c for c in node.output_columns if c in rs]
    unmatched = HashJoinNode(uidr, inner, JoinType.ANTI, (ur,), (ur,), tuple(build_cols))
    names, exprs = [], []
    for c in node.output_columns:
        names.append(c)
        if c in rs:
            exprs.append(FieldAccess(rs.type_of(c), c))
        else:
            exprs.append(Constant(ls.type_of(c), None))
    ub = ProjectNode(unmatched, tuple(names), tuple(exprs))
    return UnionAllNode((left, ub), id=node.id + "_ff")
