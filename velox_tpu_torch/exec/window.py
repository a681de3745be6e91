"""Window operator: partitioned, ordered analytic functions.

Counterpart of the JAX package's ``exec/window.py``.  Reference:
velox/exec/Window.h:38 + WindowBuild (Sort/Streaming), WindowPartition,
velox/exec/WindowFunction.h:34; function set from
velox/functions/prestosql/window/.

The reference accumulates all input, sorts it into partitions and runs
per-partition function loops.  Here one device tile holds whole partitions
and every function is a pass over the sorted tile:

  sort rows by (partition keys, order keys), dead rows last  ->  partition /
  peer run boundaries  ->  every window function is a *segmented scan*
  (running frames), a *run reduction + gather-back* (full frames), a
  *guarded shift* (lead / lag), a prefix-sum difference or a sparse-table
  range query (k-bounded frames).

The sort is ``ops/sortkey.py sort_operands`` (stable sorts from the last key
to the first, so ties keep their input order, which decides ``row_number``
among peers); the payload follows the permutation by ``index_select``.  DESC
keys are negated, as in the JAX package.  A nullable key sorts as (null
flag, value zeroed under NULL), so all NULL keys are one partition or peer
group, placed as ``SortKey.nulls_first`` says; the JAX package reads the
raw values under NULLs there.

Scope: ROWS and RANGE frames — UNBOUNDED PRECEDING .. CURRENT ROW (the SQL
default, with RANGE peer semantics), full-partition frames, and k-bounded
ROWS / RANGE frames (positional offsets, sparse tables for min / max,
``rank_in_segments`` for RANGE bounds).  Inputs larger than one tile are cut
into chunks of whole partitions by the executor
(``runner._materialize_window``).

Not ported yet: ``count(*) over (...)`` raises, as it does in the JAX
package (its argument ``*`` is looked up as a column).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

import torch

from ..dtypes import BIGINT, DOUBLE, DataType, RowType, TypeKind
from ..ops.segmented import (
    SortedRuns,
    identity_for,
    rank_in_segments,
    segmented_scan,
    sparse_table,
    sparse_table_query,
)
from ..ops.sortkey import sort_operands
from ..plan.nodes import PlanNode, SortKey, _next_id
from ..vector.column import Batch, Column, _take_clamped as _take


@dataclasses.dataclass(frozen=True)
class WindowCall:
    """One window function call: name(arg?) with optional lead/lag params."""

    name: str
    arg: Optional[str] = None  # input column name
    offset: int = 1  # lead/lag offset; also nth_value's n and ntile's buckets
    full_frame: bool = False  # aggregate over the whole partition
    # frame (preceding, following); None component = UNBOUNDED.  Absent
    # (frame is None) = the SQL default RANGE UNBOUNDED PRECEDING..CURRENT ROW.
    frame: Optional[Tuple[Optional[int], Optional[int]]] = None
    # 'rows' (positional offsets) or 'range' (order-key value offsets,
    # PlanNode.h:1989 WindowFrame kRange with k bounds)
    frame_unit: str = "rows"
    # lead/lag/first/last IGNORE NULLS (reference: WindowFunction.h kIgnoreNulls)
    ignore_nulls: bool = False

    def result_type(self, input_type: Optional[DataType]) -> DataType:
        if self.name in ("row_number", "rank", "dense_rank", "ntile", "count"):
            return BIGINT
        if self.name in (
            "percent_rank", "cume_dist", "avg",
            "variance", "var_samp", "var_pop",
            "stddev", "stddev_samp", "stddev_pop",
        ):
            return DOUBLE
        if self.name == "sum":
            from .aggregates import _sum_result_type

            return _sum_result_type(input_type)
        return input_type  # lead/lag/first_value/last_value/nth_value/min/max


@dataclasses.dataclass
class WindowNode(PlanNode):
    source: PlanNode
    partition_keys: Tuple[str, ...]
    order_keys: Tuple[SortKey, ...]
    calls: Tuple[WindowCall, ...]
    call_names: Tuple[str, ...]
    id: str = dataclasses.field(default_factory=lambda: _next_id("window"))

    def __post_init__(self):
        self.sources = (self.source,)
        in_schema = self.source.output_schema
        names = list(in_schema.names)
        types = list(in_schema.types)
        for call, out_name in zip(self.calls, self.call_names):
            arg_t = in_schema.type_of(call.arg) if call.arg else None
            names.append(out_name)
            types.append(call.result_type(arg_t))
        self.output_schema = RowType(names, types)


_CALL_RE = re.compile(
    r"^\s*(?P<fn>[a-z_]+)\s*\(\s*(?P<args>[^)]*)\)\s*"
    r"(?P<ignore>(ignore|respect)\s+nulls\s*)?"
    r"(?P<frame>(rows|range)\s+between\s+.*)?$",
    re.IGNORECASE,
)
_BOUND_RE = re.compile(
    r"^(unbounded\s+(preceding|following)|current\s+row|(\d+)\s+(preceding|following))$",
    re.IGNORECASE,
)

_VARIANCE = (
    "variance", "var_samp", "var_pop", "stddev", "stddev_samp", "stddev_pop",
)
# the functions whose result is one of their argument's values
_VALUE_FUNCTIONS = ("lead", "lag", "first_value", "last_value", "nth_value")


def _parse_bound(text: str, is_start: bool) -> Optional[int]:
    """Returns offset semantics: ints are distances; None = unbounded."""
    m = _BOUND_RE.match(text.strip())
    if not m:
        raise ValueError(f"cannot parse frame bound {text!r}")
    t = text.strip().lower()
    if t.startswith("unbounded"):
        return None
    if t == "current row":
        return 0
    k = int(m.group(3))
    return k if (("preceding" in t) == is_start) else -k


def parse_window_call(text: str) -> WindowCall:
    """'rank()' | 'sum(x)' | 'lag(x, 2)' |
    'sum(x) rows between 2 preceding and current row' -> WindowCall."""
    m = _CALL_RE.match(text.strip())
    if not m:
        raise ValueError(f"cannot parse window call {text!r}")
    fn = m.group("fn").lower()
    args = [a.strip() for a in m.group("args").split(",") if a.strip()]
    frame = None
    unit = "rows"
    if m.group("frame"):
        text_f = m.group("frame").strip()
        unit = "range" if text_f.lower().startswith("range") else "rows"
        body = re.sub(r"^(rows|range)\s+between\s+", "", text_f, flags=re.IGNORECASE)
        start_s, end_s = re.split(r"\s+and\s+", body, flags=re.IGNORECASE)
        frame = (_parse_bound(start_s, True), _parse_bound(end_s, False))
    ignore = bool(m.group("ignore")) and m.group("ignore").lower().startswith("ignore")
    if fn in ("lead", "lag"):
        return WindowCall(
            fn, args[0], int(args[1]) if len(args) > 1 else 1, ignore_nulls=ignore
        )
    if fn in ("first_value", "last_value"):
        return WindowCall(fn, args[0], full_frame=True, ignore_nulls=ignore)
    if fn == "nth_value":
        return WindowCall(fn, args[0], offset=int(args[1]))
    if fn in _VARIANCE:
        if frame is None:
            # SQL default frame, peer-inclusive (RANGE ... CURRENT ROW)
            frame, unit = (None, 0), "range"
        return WindowCall(fn, args[0], frame=frame, frame_unit=unit)
    if fn in ("sum", "avg", "count", "min", "max"):
        return WindowCall(fn, args[0] if args else None, frame=frame, frame_unit=unit)
    if fn in ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist"):
        return WindowCall(fn)
    if fn == "ntile":
        return WindowCall(fn, None, offset=int(args[0]))
    raise KeyError(f"unknown window function {fn!r}")


def _null_flagged(decoded, nulls_first: bool) -> Tuple[torch.Tensor, ...]:
    """A sort key as (null flag, value zeroed under NULL), or (value,) when
    the column has no validity.  The flag sorts ascending: NULLs last unless
    ``nulls_first``."""
    values, validity = decoded
    if validity is None:
        return (values,)
    flag = validity if nulls_first else ~validity
    return flag, torch.where(validity, values, torch.zeros_like(values))


def _floordiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


class WindowExec:
    """Computes all window columns over one sorted device tile."""

    def __init__(self, node: WindowNode, capacity: int):
        self.node = node
        self.capacity = capacity

    def apply(self, batch: Batch) -> Batch:
        node = self.node
        cap = batch.capacity
        dev = batch.device
        in_schema = node.source.output_schema
        mask = batch.active_mask()

        # every key is (null flag, value zeroed under NULL): all NULL keys
        # form one partition / peer group, and an order key's flag sorts its
        # NULLs first or last whatever the direction (SortKey.nulls_first;
        # NULLS LAST by default).  A key with no validity needs no flag.
        pkeys = [_null_flagged(batch.column(k).decode(cap), False) for k in node.partition_keys]
        okeys = []
        for sk in node.order_keys:
            v, validity = batch.column(sk.name).decode(cap)
            if not sk.ascending:
                v = -v if v.dtype.is_floating_point else -v.to(torch.int64)
            okeys.append(_null_flagged((v, validity), sk.nulls_first))

        # one stable lexicographic sort (dead rows last); every input column
        # and validity follows the permutation, so the output is the sorted
        # batch with the window columns appended
        idx = torch.arange(cap, dtype=torch.int64, device=dev)
        pflat = [t for key in pkeys for t in key]
        oflat = [t for key in okeys for t in key]
        keys = [~mask] + pflat + oflat
        sorted_ops = sort_operands(keys + [idx], num_keys=len(keys))
        s_mask = ~sorted_ops[0]
        s_pkeys = sorted_ops[1 : 1 + len(pflat)]
        s_oflat = sorted_ops[1 + len(pflat) : len(keys)]
        # an order key's value is the last tensor of its (flag?, value) group
        s_okeys, s_oflags, at = [], [], 0
        for key in okeys:
            at += len(key)
            s_okeys.append(s_oflat[at - 1])
            s_oflags.append(s_oflat[at - 2] if len(key) == 2 else None)
        perm = sorted_ops[-1]
        s_cols: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
        for col in batch.columns:
            values, validity = col.decode(cap)
            s_cols.append((
                values.index_select(0, perm),
                None if validity is None else validity.index_select(0, perm),
            ))

        part_diff = torch.zeros((cap,), dtype=torch.bool, device=dev)
        for kv in s_pkeys:
            part_diff = part_diff | (kv != torch.roll(kv, 1))
        part_boundary = s_mask & ((idx == 0) | part_diff)
        peer_diff = part_diff
        for kv in s_oflat:
            peer_diff = peer_diff | (kv != torch.roll(kv, 1))
        peer_boundary = s_mask & ((idx == 0) | peer_diff)
        # RANGE k frames search order-key values inside a partition; the NULL
        # rows of the key sit together at one end of it and span only
        # themselves, so the search runs over (partition, null flag) runs
        range_diff = part_diff
        for flag in s_oflags[:1]:
            if flag is not None:
                range_diff = range_diff | (flag != torch.roll(flag, 1))
        range_boundary = s_mask & ((idx == 0) | range_diff)

        part_runs = SortedRuns(part_boundary, s_mask)
        part_id = part_runs.run_index  # per-row partition ordinal
        part_slot = part_id.clamp(0, cap - 1)
        part_start = segmented_scan(idx, part_boundary, "first")
        rn = idx - part_start + 1
        peer_start = segmented_scan(idx, peer_boundary, "first")
        rank = peer_start - part_start + 1
        ones = torch.ones((cap,), dtype=torch.int64, device=dev)
        size_per_row = _take(part_runs.reduce(ones, s_mask, "sum"), part_slot)

        lazy = {}

        def part_last():
            """Per row, its partition's last live row."""
            if "part_last" not in lazy:
                lazy["part_last"] = _take(part_runs.reduce(idx, s_mask, "max"), part_slot)
            return lazy["part_last"]

        def peer_last():
            """Per row, the last row of its peer group (the default frame's
            end)."""
            if "peer_last" not in lazy:
                peer_runs = SortedRuns(peer_boundary, s_mask)
                lazy["peer_last"] = _take(
                    peer_runs.reduce(idx, s_mask, "max"),
                    peer_runs.run_index.clamp(0, cap - 1),
                )
            return lazy["peer_last"]

        def arg_of(call: WindowCall):
            if call.arg is None:
                return None, None
            return s_cols[in_schema.index_of(call.arg)]

        def decimal_scale(call: WindowCall) -> int:
            if call.arg is not None:
                t = in_schema.type_of(call.arg)
                if t.kind == TypeKind.DECIMAL:
                    return t.scale
            return 0

        def valid_rows(validity):
            return s_mask if validity is None else (s_mask & validity)

        out_cols: List[torch.Tensor] = []
        out_validity: List[Optional[torch.Tensor]] = []
        for call in node.calls:
            values, validity = arg_of(call)
            name = call.name
            if name == "row_number":
                out, ok = rn, None
            elif name == "rank":
                out, ok = rank, None
            elif name == "dense_rank":
                out = segmented_scan(peer_boundary.to(torch.int64), part_boundary, "sum")
                ok = None
            elif name == "percent_rank":
                denom = (size_per_row - 1).clamp(min=1).to(torch.float64)
                out = torch.where(
                    size_per_row > 1, (rank - 1) / denom, torch.zeros_like(denom)
                )
                ok = None
            elif name == "cume_dist":
                # rows <= current peer group = index of the peer run's last row + 1
                out = (peer_last() - part_start + 1).to(torch.float64) / size_per_row.clamp(min=1)
                ok = None
            elif name == "ntile":
                n = call.offset
                size = size_per_row.clamp(min=1)
                base = _floordiv(size, n)
                rem = size - base * n
                r0 = rn - 1
                cut = rem * (base + 1)
                tile_id = torch.where(
                    r0 < cut,
                    _floordiv(r0, (base + 1).clamp(min=1)),
                    rem + _floordiv(r0 - cut, base.clamp(min=1)),
                )
                out, ok = tile_id + 1, None
            elif name in ("lead", "lag") and call.ignore_nulls:
                # k-th non-null before/after: rank rows among VALID rows and
                # gather from the stable-partitioned valid prefix
                valid_row = valid_rows(validity)
                order = torch.argsort((~valid_row).to(torch.uint8), stable=True)
                valid64 = valid_row.to(torch.int64)
                cnt = torch.cumsum(valid64, 0)  # valids <= idx
                total_valid = cnt[-1]
                if name == "lag":
                    # valids strictly before idx = cnt - valid(idx)
                    target = cnt - valid64 - call.offset
                else:
                    target = cnt + call.offset - 1
                ok = (target >= 0) & (target < total_valid)
                pos = _take(order, target.clamp(0, cap - 1))
                ok = ok & (_take(part_id, pos) == part_id) & s_mask
                out = _take(values, pos)
            elif name in ("first_value", "last_value") and call.ignore_nulls:
                valid_row = valid_rows(validity)
                if name == "first_value":
                    cand = torch.where(valid_row, idx, torch.full_like(idx, cap))
                    at = _take(part_runs.reduce(cand, s_mask, "min"), part_slot)
                    ok = at < cap
                else:
                    cand = torch.where(valid_row, idx, torch.full_like(idx, -1))
                    at = _take(part_runs.reduce(cand, s_mask, "max"), part_slot)
                    ok = at >= 0
                out = _take(values, at.clamp(0, cap - 1))
            elif name in ("lead", "lag"):
                k = call.offset if name == "lag" else -call.offset
                out = torch.roll(values, k, 0)
                # the source row must be alive too (padding rows inherit the
                # last partition's run index)
                ok = (torch.roll(part_id, k, 0) == part_id) & s_mask & torch.roll(s_mask, k, 0)
                ok = ok & ((idx >= k) if k > 0 else (idx < cap + k))
                if validity is not None:
                    ok = ok & torch.roll(validity, k, 0)
            elif name == "first_value":
                out = segmented_scan(values, part_boundary, "first")
                ok = None if validity is None else segmented_scan(validity, part_boundary, "first")
            elif name == "last_value":
                last_pos = part_last()
                out = _take(values, last_pos)
                ok = None if validity is None else _take(validity, last_pos)
            elif name == "nth_value":
                pos = part_start + (call.offset - 1)
                # visible once the default frame (up to the current peer
                # group's last row) includes the nth row
                ok = (pos <= part_last()) & (pos <= peer_last())
                out = _take(values, pos.clamp(0, cap - 1))
                if validity is not None:
                    ok = ok & _take(validity, pos.clamp(0, cap - 1))
            elif name in ("sum", "avg", "count", "min", "max") + _VARIANCE and call.frame is not None:
                out, ok = self._framed(
                    call, values, validity, s_mask, s_okeys, idx, ones, part_boundary,
                    part_id, part_start, part_last(), decimal_scale(call),
                    range_boundary,
                )
            elif name in ("sum", "min", "max", "avg", "count"):
                if call.arg is None:  # count() with no argument
                    base_vals, v_mask = ones, s_mask
                else:
                    base_vals, v_mask = values, valid_rows(validity)
                acc_dtype = torch.float64 if base_vals.dtype.is_floating_point else torch.int64
                op = {"sum": "sum", "avg": "sum", "count": "sum", "min": "min", "max": "max"}[name]
                masked = torch.where(
                    v_mask,
                    base_vals.to(acc_dtype),
                    torch.full((cap,), identity_for(op, acc_dtype), dtype=acc_dtype, device=dev),
                )
                running = segmented_scan(masked, part_boundary, op)
                counts_run = segmented_scan(v_mask.to(torch.int64), part_boundary, "sum")
                # default SQL frame is RANGE ... CURRENT ROW: peers share the
                # value at the *last* peer row
                lp = peer_last()
                running = _take(running, lp)
                counts = _take(counts_run, lp)
                if name == "count":
                    out, ok = counts, None
                elif name == "avg":
                    out = running.to(torch.float64) / counts.clamp(min=1) / (10.0 ** decimal_scale(call))
                    ok = counts > 0
                else:
                    out, ok = running, counts > 0
            else:
                raise KeyError(f"unknown window function {name!r}")
            out_cols.append(out)
            out_validity.append(ok)

        # assemble the output batch (sorted order)
        cols: List[Column] = []
        for (values, validity), col, dtype in zip(s_cols, batch.columns, in_schema.types):
            cols.append(Column.flat(values, dtype, validity, col.strings))
        out_types = node.output_schema.types[len(in_schema):]
        for call, arr, validity, dtype in zip(node.calls, out_cols, out_validity, out_types):
            # a function that returns its argument's values keeps its string
            # dictionary (the JAX package drops it, so a VARCHAR lag there
            # comes back as bare codes)
            strings = None
            if call.name in _VALUE_FUNCTIONS and dtype.is_string:
                strings = batch.columns[in_schema.index_of(call.arg)].strings
            cols.append(Column.flat(arr.to(dtype.device_dtype), dtype, validity, strings))
        return Batch(tuple(cols), batch.length, s_mask, node.output_schema, cap)

    @staticmethod
    def _framed(
        call, values, validity, s_mask, s_okeys, idx, ones, part_boundary,
        part_id, part_start, part_last, scale, range_boundary,
    ):
        """A sum / avg / count / min / max / variance over a k-bounded frame.

        ROWS: positional offsets clamped to the partition.  RANGE: order-key
        value offsets resolved to row positions by ``rank_in_segments`` (the
        reference's kPreceding / kFollowing RANGE bounds, PlanNode.h:1989).
        Sums come from prefix-sum differences, min / max from a sparse
        table."""
        cap = idx.shape[0]
        name = call.name
        if call.arg is None:
            base_vals, v_mask = ones, s_mask
        else:
            base_vals = values
            v_mask = s_mask if validity is None else (s_mask & validity)
        acc_dtype = torch.float64 if base_vals.dtype.is_floating_point else torch.int64
        k_pre, k_post = call.frame
        if call.frame_unit == "range" and (k_pre is not None or k_post is not None):
            if len(s_okeys) != 1:
                raise NotImplementedError("RANGE k frames need exactly one ORDER BY key")
            okey = s_okeys[0]
            range_id = torch.cumsum(range_boundary.to(torch.int64), 0)
            seg = torch.where(s_mask, range_id, torch.full_like(range_id, 1 << 40))
            if k_pre is None:
                lo = part_start
            else:
                lo = rank_in_segments(seg, okey, seg, okey - k_pre, inclusive=False)
            if k_post is None:
                hi = part_last
            else:
                hi = rank_in_segments(seg, okey, seg, okey + k_post, inclusive=True) - 1
        else:
            lo = part_start if k_pre is None else torch.maximum(idx - k_pre, part_start)
            hi = part_last if k_post is None else torch.minimum(idx + k_post, part_last)
        lo = torch.maximum(lo, part_start).clamp(0, cap - 1)
        hi = torch.minimum(hi, part_last).clamp(0, cap - 1)
        empty = hi < lo
        lo_prev = (lo - 1).clamp(0, cap - 1)
        has_prev = lo > part_start

        def fdiff(pref):
            at_lo = torch.where(has_prev, _take(pref, lo_prev), torch.zeros_like(pref))
            return _take(pref, hi) - at_lo

        wcnt = fdiff(segmented_scan(v_mask.to(torch.int64), part_boundary, "sum"))
        if name in _VARIANCE:
            # the variance family over the frame via prefix sums of x, x^2
            vf = base_vals.to(torch.float64) / (10.0 ** scale)
            vf = torch.where(v_mask, vf, torch.zeros_like(vf))
            ws = fdiff(segmented_scan(vf, part_boundary, "sum"))
            wss = fdiff(segmented_scan(vf * vf, part_boundary, "sum"))
            wn = wcnt.to(torch.float64)
            m2 = (wss - ws * ws / wn.clamp(min=1.0)).clamp(min=0.0)
            pop = name.endswith("_pop")
            denom = wn if pop else (wn - 1.0).clamp(min=1.0)
            out = m2 / denom.clamp(min=1.0)
            if name.startswith("stddev"):
                out = torch.sqrt(out)
            return out, (~empty) & (wn >= (1 if pop else 2))
        if name in ("min", "max"):
            ident = identity_for(name, acc_dtype)
            masked = torch.where(
                v_mask, base_vals.to(acc_dtype), torch.full((cap,), ident, dtype=acc_dtype, device=idx.device)
            )
            out = sparse_table_query(sparse_table(masked, name), lo, hi, name, ident)
            return out, ~empty & (wcnt > 0)
        masked = torch.where(v_mask, base_vals.to(acc_dtype), torch.zeros((), dtype=acc_dtype, device=idx.device))
        wsum = fdiff(segmented_scan(masked, part_boundary, "sum"))
        if name == "count":
            return torch.where(empty, torch.zeros_like(wcnt), wcnt), None
        if name == "avg":
            return wsum.to(torch.float64) / wcnt.clamp(min=1) / (10.0 ** scale), ~empty & (wcnt > 0)
        return wsum, ~empty & (wcnt > 0)
