"""Collect aggregates: array_agg / set_agg / map_agg / histogram / map_union,
entropy, multimap_agg, approx_most_frequent, approx_percentile and the
sketch rewrites' per-group finishers.

Counterpart of the JAX package's ``exec/collect_agg.py``.  Reference:
velox/functions/prestosql/aggregates/{ArrayAgg,SetAgg,MapAgg,Histogram,
MapUnion}Aggregate.cpp — accumulators there are per-group HashStringAllocator
lists.  Here, as in the JAX package, there is no per-group dynamic state: the
device filters and compacts the rows; group assembly happens on the host over
the key-sorted row stream, vectorized with numpy (run-length slicing),
producing HostSegments columns directly.  Its sorts within groups are the JAX
package's ``np.lexsort`` calls; the executor runs them on its device
(``lexsort``), with the same order.  The result size equals
the input size, so materializing rows costs no more than the answer itself.

``approx_percentile`` is lowered by the sketch rewrite (``exec/sketch.py``)
whenever its arguments allow; what reaches this module is exact.  The
rewrite's internal ``__kll_quantile``, ``__dd_quantile`` and
``__bloom_assemble`` finish a group from its few bounded-state rows: a
quantile from the rank-compressed ECDF or the log-bucket histogram, and the
Spark wire format of a bloom filter from its OR-ed words.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..dtypes import BIGINT, DataType, TypeKind, array as array_t, map_ as map_t
from ..vector.complex import HostSegments
from ..vector.string_table import StringTable

COLLECT_AGG_NAMES = (
    "array_agg",
    "set_agg",
    "map_agg",
    "histogram",
    "map_union",
    "approx_percentile",
    "approx_most_frequent",
    "entropy",
    "multimap_agg",
    "__dd_quantile",
    "__kll_quantile",
    "__bloom_assemble",
)


@dataclasses.dataclass
class CollectAggregate:
    """Marker 'bound aggregate' for the collect family (list-valued state)."""

    name: str
    result_type: DataType
    arg_types: Tuple[DataType, ...]
    arg_roles: Tuple[str, ...]
    # kept for interface parity with BoundAggregate where harmless
    acc_dtypes: Tuple = ()
    acc_ops: Tuple = ()

    @property
    def num_args(self) -> int:
        return len(self.arg_roles)


def bind_collect(name: str, types: Tuple[DataType, ...]) -> CollectAggregate:
    if name == "array_agg":
        (t,) = types
        return CollectAggregate(name, array_t(t), types, ("value",))
    if name == "set_agg":
        (t,) = types
        return CollectAggregate(name, array_t(t), types, ("value",))
    if name == "map_agg":
        k, v = types
        return CollectAggregate(name, map_t(k, v), types, ("value", "value"))
    if name == "histogram":
        (t,) = types
        return CollectAggregate(name, map_t(t, BIGINT), types, ("value",))
    if name == "map_union":
        (m,) = types
        assert m.kind == TypeKind.MAP, "map_union takes a MAP argument"
        return CollectAggregate(name, m, types, ("value",))
    if name == "entropy":
        # log2 entropy of the value distribution (reference:
        # prestosql/aggregates/EntropyAggregates.cpp) — exact from counts
        from ..dtypes import DOUBLE

        (t,) = types
        return CollectAggregate(name, DOUBLE, types, ("value",))
    if name == "multimap_agg":
        # (k, v) -> map(k, array(v)) (reference: MultiMapAggAggregate.cpp)
        k, v = types
        return CollectAggregate(
            name, map_t(k, array_t(v)), types, ("value", "value")
        )
    if name == "approx_percentile":
        # (x, percentage) or (x, weight, percentage), exact: the sketch
        # rewrite lowers every form it can bound (string and decimal x stay)
        if len(types) == 3:
            return CollectAggregate(
                name, types[0], types, ("value", "value", "plain")
            )
        assert len(types) == 2, "approx_percentile(x, [w,] percentage)"
        return CollectAggregate(name, types[0], types, ("value", "plain"))
    if name == "approx_most_frequent":
        # (buckets, value, capacity) -> map(value, count); exact top-k
        # (reference: ApproxMostFrequentStreamSummary.h space-saving sketch)
        assert len(types) == 3, "approx_most_frequent(buckets, value, capacity)"
        return CollectAggregate(
            name, map_t(types[1], BIGINT), types, ("plain", "value", "plain")
        )
    if name == "__dd_quantile":
        # (dd_bucket, count, percentage) -> quantile from the bounded
        # log-bucket histogram (exec/sketch.py DDSketch rewrite)
        from ..dtypes import DOUBLE

        assert len(types) == 3
        return CollectAggregate(
            name, DOUBLE, types, ("plain", "plain", "plain")
        )
    if name == "__kll_quantile":
        # (x, cum_rank, total, percentage) -> quantile from the rank-
        # compressed per-group ECDF (exec/sketch.py kll rewrite; rank error
        # <= 2/kll_points, velox/functions/lib/KllSketch.h's contract shape)
        from ..dtypes import DOUBLE

        assert len(types) == 4
        return CollectAggregate(
            name, DOUBLE, types, ("plain", "plain", "plain", "plain")
        )
    if name == "__bloom_assemble":
        # (word_idx, or_bits, num_words) -> Spark-format serialized bloom
        # filter (exec/sketch.py bloom_filter_agg rewrite; reference:
        # sparksql/aggregates/BloomFilterAggAggregate.cpp)
        from ..dtypes import VARBINARY

        assert len(types) == 3
        return CollectAggregate(
            name, VARBINARY, types, ("plain", "plain", "plain")
        )
    raise KeyError(name)


def _percentage(agg: CollectAggregate, args, index: int, n: int) -> float:
    """The (constant) percentage argument of a group-sorted run, as a float."""
    if not n:
        return 0.5
    pt = agg.arg_types[index]
    p_raw = float(np.asarray(args[index])[0])
    return p_raw / 10.0**pt.scale if pt.kind == TypeKind.DECIMAL else p_raw


def _runs(arrs: Sequence[np.ndarray], n: int) -> np.ndarray:
    """Start indices of equal-key runs over already-sorted arrays."""
    if n == 0:
        return np.zeros(0, np.int64)
    diff = np.zeros(n, dtype=bool)
    diff[0] = True
    for a in arrs:
        diff[1:] |= a[1:] != a[:-1]
    return np.flatnonzero(diff)


def compute_collect(
    agg: CollectAggregate,
    gids: np.ndarray,
    starts: np.ndarray,
    num_groups: int,
    args: Sequence[np.ndarray],
    validities: Sequence[Optional[np.ndarray]],
    tables: Sequence[Optional[StringTable]],
    lexsort: Callable = np.lexsort,
):
    """Compute one collect aggregate over group-sorted rows.

    ``gids``: group id per (sorted) row; ``starts``: first row of each group.
    ``lexsort``: a stable sort with ``np.lexsort``'s contract (the last key
    most significant), by default ``np.lexsort``; the executor passes one
    that sorts on its device.  Returns (column_value, row_validity|None)
    where column_value is a HostSegments (complex result).
    """
    n = len(gids)
    lengths = np.diff(np.append(starts, n))

    if agg.name == "array_agg":
        # Presto array_agg keeps nulls
        v = args[0]
        val = validities[0]
        seg = HostSegments(
            agg.result_type,
            lengths.astype(np.int32),
            (v.copy(),),
            (None if val is None else val.copy(),),
            (tables[0],),
        )
        return seg, None

    if agg.name == "set_agg":
        v, val = args[0], validities[0]
        null_key = (
            (~val).astype(np.int8) if val is not None else np.zeros(n, np.int8)
        )
        order = lexsort((v, null_key, gids))
        vs, nk, gs = v[order], null_key[order], gids[order]
        keep = np.zeros(n, dtype=bool)
        if n:
            keep[0] = True
            keep[1:] = (gs[1:] != gs[:-1]) | (vs[1:] != vs[:-1]) | (nk[1:] != nk[:-1])
        sizes = np.bincount(gs[keep], minlength=num_groups)
        seg = HostSegments(
            agg.result_type,
            sizes.astype(np.int32),
            (vs[keep],),
            (None if val is None else (nk[order][keep] == 0),),
            (tables[0],),
        )
        return seg, None

    if agg.name == "map_agg":
        k, v = args[0], args[1]
        kval = validities[0]
        vval = validities[1]
        live = np.ones(n, dtype=bool) if kval is None else kval.copy()
        order = lexsort((k, gids))
        ks, vs, gs, lv = k[order], v[order], gids[order], live[order]
        vv = None if vval is None else vval[order]
        keep = lv.copy()
        if n:
            dup = (gs[1:] == gs[:-1]) & (ks[1:] == ks[:-1])
            keep[1:] &= ~dup
        sizes = np.bincount(gs[keep], minlength=num_groups)
        seg = HostSegments(
            agg.result_type,
            sizes.astype(np.int32),
            (ks[keep], vs[keep]),
            (None, None if vv is None else vv[keep]),
            (tables[0], tables[1]),
        )
        return seg, None

    if agg.name == "histogram":
        v, val = args[0], validities[0]
        live = np.ones(n, dtype=bool) if val is None else val
        order = lexsort((v, gids))
        vs, gs, lv = v[order], gids[order], live[order]
        vs2, gs2 = vs[lv], gs[lv]
        m = len(vs2)
        run_starts = _runs([gs2, vs2], m)
        counts = np.diff(np.append(run_starts, m)).astype(np.int64)
        sizes = np.bincount(gs2[run_starts], minlength=num_groups)
        seg = HostSegments(
            agg.result_type,
            sizes.astype(np.int32),
            (vs2[run_starts], counts),
            (None, None),
            (tables[0], None),
        )
        return seg, None

    if agg.name == "map_union":
        # args[0] is a HostSegments column of MAP rows (gids-sorted)
        seg: HostSegments = args[0]
        k, v = seg.children
        kv_val = seg.child_validities[1]
        row_gids = np.repeat(gids, seg.sizes.astype(np.int64))
        order = lexsort((k, row_gids))
        ks, gs = k[order], row_gids[order]
        vs = v[order]
        keep = np.ones(len(ks), dtype=bool)
        if len(ks):
            keep[1:] = ~((gs[1:] == gs[:-1]) & (ks[1:] == ks[:-1]))
        sizes = np.bincount(gs[keep], minlength=num_groups)
        out = HostSegments(
            agg.result_type,
            sizes.astype(np.int32),
            (ks[keep], vs[keep]),
            (None, None if kv_val is None else kv_val[order][keep]),
            seg.string_tables,
        )
        return out, None

    if agg.name == "entropy":
        v, val = args[0], validities[0]
        live = np.ones(n, dtype=bool) if val is None else val
        order = lexsort((v, gids))
        vs, gs, lv = v[order], gids[order], live[order]
        vs2, gs2 = vs[lv], gs[lv]
        m = len(vs2)
        run_starts = _runs([gs2, vs2], m)
        counts = np.diff(np.append(run_starts, m)).astype(np.float64)
        rg = gs2[run_starts]
        totals = np.bincount(gs2, minlength=num_groups).astype(np.float64)
        tot_per_run = totals[rg]
        p = counts / np.maximum(tot_per_run, 1.0)
        contrib = -p * np.log2(p)
        gfirst = _runs([rg], len(rg))
        out = np.zeros(num_groups)
        if len(rg):
            sums = np.add.reduceat(contrib, gfirst)
            out[rg[gfirst]] = sums
        return out, totals > 0

    if agg.name == "multimap_agg":
        k, v = args[0], args[1]
        kval = validities[0]
        vval = validities[1]
        live = np.ones(n, dtype=bool) if kval is None else kval
        order = lexsort((k, gids))  # stable: value order preserved per key
        ks, vs, gs, lv = k[order], v[order], gids[order], live[order]
        vv = None if vval is None else vval[order]
        ks2, vs2, gs2 = ks[lv], vs[lv], gs[lv]
        vv2 = None if vv is None else vv[lv]
        m = len(ks2)
        entry_starts = _runs([gs2, ks2], m)  # one entry per (group, key)
        entry_sizes = np.diff(np.append(entry_starts, m)).astype(np.int32)
        sizes = np.bincount(gs2[entry_starts], minlength=num_groups)
        inner = HostSegments(
            agg.result_type.value_type,
            entry_sizes,
            (vs2,),
            (vv2,),
            (tables[1],),
        )
        seg = HostSegments(
            agg.result_type,
            sizes.astype(np.int32),
            (ks2[entry_starts], inner),
            (None, None),
            (tables[0], None),
        )
        return seg, None

    if agg.name == "approx_percentile":
        v, val = args[0], validities[0]
        weighted = len(agg.arg_types) == 3
        p = _percentage(agg, args, 2 if weighted else 1, n)
        live = np.ones(n, dtype=bool) if val is None else val
        order = lexsort((v, gids))
        vs, gs, lv = v[order], gids[order], live[order]
        vs2, gs2 = vs[lv], gs[lv]
        counts = np.bincount(gs2, minlength=num_groups)
        firsts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        if weighted:
            # weight w repeats the value w times (reference:
            # aggregates/ApproxPercentileAggregate.cpp weighted path): pick
            # the first value whose within-group cumulative weight reaches
            # ceil(p * total_weight).  cumw is globally nondecreasing, so a
            # global searchsorted with per-group targets + a clip to the
            # group's range finds it without per-group loops.
            w = np.asarray(args[1]).astype(np.int64)[order][lv]
            w = np.maximum(w, 0)
            ends = firsts + counts
            if len(w):
                cumw = np.cumsum(w)
                base = np.where(firsts > 0, cumw[np.maximum(firsts - 1, 0)], 0)
                totals = np.where(
                    counts > 0, cumw[np.maximum(ends - 1, 0)] - base, 0
                )
                target = base + np.maximum(np.ceil(p * totals), 1)
                idx = np.searchsorted(cumw, target, side="left")
                idx = np.clip(idx, firsts, np.maximum(ends - 1, firsts))
            else:
                idx = np.zeros(num_groups, np.int64)
        else:
            idx = firsts + np.minimum(
                np.maximum(counts - 1, 0),
                np.floor(p * counts).astype(np.int64),
            )
        if len(vs2):
            out = vs2[np.clip(idx, 0, len(vs2) - 1)]
        else:
            out = np.zeros(num_groups, v.dtype)
        return out, counts > 0

    if agg.name == "__bloom_assemble":
        # per-group: scatter (word_idx -> or_bits) into a zeroed word array
        # and emit the Spark wire format (utils/spark_bloom.serialize).
        # Rows whose word is NULL carry an all-NULL x group (the rewrite is
        # null-propagating, not filtering); a group with NO live rows
        # yields a NULL filter, matching the reference
        # (BloomFilterAggAggregateTest emptyInput/nullBloomFilter).
        from ..utils.spark_bloom import serialize

        w = np.asarray(args[0]).astype(np.int64)
        bits = np.asarray(args[1]).astype(np.int64).view(np.uint64)
        live = (
            np.asarray(validities[0], dtype=bool)
            if validities[0] is not None
            else np.ones(n, dtype=bool)
        )
        if validities[1] is not None:
            live = live & np.asarray(validities[1], dtype=bool)
        nwords = int(np.asarray(args[2])[0]) if n else 4
        out = np.empty(num_groups, dtype=object)
        valid = np.zeros(num_groups, dtype=bool)
        for g in range(num_groups):
            s = starts[g]
            e = starts[g + 1] if g + 1 < num_groups else n
            lv = live[s:e]
            if not lv.any():
                out[g] = None
                continue
            words = np.zeros(nwords, dtype=np.uint64)
            words[w[s:e][lv]] = bits[s:e][lv]
            out[g] = serialize(words)
            valid[g] = True
        return out, valid

    if agg.name == "__dd_quantile":
        from .sketch import dd_bucket_value

        b = np.asarray(args[0]).astype(np.int64)
        c = np.asarray(args[1]).astype(np.int64)
        p = _percentage(agg, args, 2, n)
        order = lexsort((b, gids))
        bs, gs, cs = b[order], gids[order], c[order]
        totals = np.zeros(num_groups, np.int64)
        np.add.at(totals, gs, cs)
        # rank convention matches the exact path: element index
        # floor(p * count), clipped into range
        rank = np.minimum(
            np.maximum(totals - 1, 0), np.floor(p * totals).astype(np.int64)
        )
        cum = np.cumsum(cs)
        first = np.ones(len(gs), dtype=bool)
        first[1:] = gs[1:] != gs[:-1]
        fidx = np.flatnonzero(first)
        base = np.zeros(len(gs), np.int64)
        if len(fidx):
            base_vals = np.concatenate([[0], cum[fidx[1:] - 1]])
            base = np.repeat(base_vals, np.diff(np.append(fidx, len(gs))))
        cum_in = cum - base
        hit = cum_in > rank[gs]
        pos = np.arange(len(gs))
        # first qualifying bucket row per group
        sel = np.full(num_groups, len(gs), np.int64)
        np.minimum.at(sel, gs[hit], pos[hit])
        chosen = np.clip(sel, 0, max(len(gs) - 1, 0))
        vals = dd_bucket_value(bs[chosen]) if len(bs) else np.zeros(num_groups)
        out = np.where(totals > 0, vals, 0.0)
        return out, totals > 0

    if agg.name == "__kll_quantile":
        x = np.asarray(args[0]).astype(np.float64)
        cum = np.asarray(args[1]).astype(np.int64)
        tot = np.asarray(args[2]).astype(np.int64)
        p = _percentage(agg, args, 3, n)
        # rank convention matches the exact path: element index
        # floor(p * count), clipped into range; pick the first compressed
        # ECDF point whose cumulative rank covers it
        order = lexsort((cum, gids))
        xs, gs, cs = x[order], gids[order], cum[order]
        totals = np.zeros(num_groups, np.int64)
        if len(gs):
            np.maximum.at(totals, gs, tot[order])
        rank = np.minimum(
            np.maximum(totals - 1, 0), np.floor(p * totals).astype(np.int64)
        )
        hit = cs > rank[gs]
        pos = np.arange(len(gs))
        sel = np.full(num_groups, len(gs), np.int64)
        if len(gs):
            np.minimum.at(sel, gs[hit], pos[hit])
        chosen = np.clip(sel, 0, max(len(gs) - 1, 0))
        vals = xs[chosen] if len(xs) else np.zeros(num_groups)
        return np.where(totals > 0, vals, 0.0), totals > 0

    if agg.name == "approx_most_frequent":
        buckets = int(np.asarray(args[0])[0]) if n else 0
        v, val = args[1], validities[1]
        live = np.ones(n, dtype=bool) if val is None else val
        order = lexsort((v, gids))
        vs, gs, lv = v[order], gids[order], live[order]
        vs2, gs2 = vs[lv], gs[lv]
        m = len(vs2)
        run_starts = _runs([gs2, vs2], m)
        counts = np.diff(np.append(run_starts, m)).astype(np.int64)
        rg = gs2[run_starts]
        rv = vs2[run_starts]
        # top-k per group by (count desc, value asc)
        order2 = lexsort((rv, -counts, rg))
        rg2, rv2, rc2 = rg[order2], rv[order2], counts[order2]
        gcounts = np.bincount(rg2, minlength=num_groups)
        gfirst = np.concatenate([[0], np.cumsum(gcounts)[:-1]])
        rank = np.arange(len(rg2)) - np.repeat(gfirst, gcounts)
        keep = rank < buckets
        sizes = np.bincount(rg2[keep], minlength=num_groups)
        # present entries in (value asc) order within each group
        order3 = lexsort((rv2[keep], rg2[keep]))
        seg = HostSegments(
            agg.result_type,
            sizes.astype(np.int32),
            (rv2[keep][order3], rc2[keep][order3]),
            (None, None),
            (tables[1], None),
        )
        return seg, None

    raise KeyError(agg.name)
