"""Collect aggregates: array_agg / set_agg / map_agg / histogram / map_union,
entropy, multimap_agg and approx_most_frequent.

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

The JAX package's sketch-backed names (``approx_percentile``, which its
sketch rewrite lowers, and the rewrite's internal ``__dd_quantile``,
``__kll_quantile``, ``__bloom_assemble``) come with the sketch slice and
raise ``KeyError`` by name here.
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
    "approx_most_frequent",
    "entropy",
    "multimap_agg",
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
    if name == "approx_most_frequent":
        # (buckets, value, capacity) -> map(value, count); exact top-k
        # (reference: ApproxMostFrequentStreamSummary.h space-saving sketch)
        assert len(types) == 3, "approx_most_frequent(buckets, value, capacity)"
        return CollectAggregate(
            name, map_t(types[1], BIGINT), types, ("plain", "value", "plain")
        )
    raise KeyError(name)


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
