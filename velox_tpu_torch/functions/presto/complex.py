"""Presto array / map / row functions and the lambda (higher-order) functions.

Counterpart of the JAX package's ``functions/presto/complex.py``.  Reference:
velox/functions/prestosql/ArrayFunctions.h, MapFunctions.h and the lambda
family (velox/functions/prestosql/Transform.cpp, Filter.cpp, Reduce.cpp,
ZipWith.cpp) built on velox/expression/LambdaExpr.h + ComplexViewTypes.h.

An ARRAY/MAP value is per-row spans over fixed element pools
(``expr/seg.py SegValue``).  Three evaluation regimes, as in the JAX package:

* span lookups (cardinality, element_at, slice) — pure gathers on any layout;
* pool passes (transform, filter, min/max, distinct) — normalize the pool to
  row order once (memoized), then the whole pool is processed in one pass;
  lambdas evaluate their body over the *pool* with outer columns gathered
  per element through rowid;
* offset iteration (reduce with an arbitrary, non-associative lambda) — a
  loop over element offsets, each step processing every row at once
  (iterations = longest array, read once from the device).

These are dispatched by name from the expression compiler
(``expr/compiler.py EvalContext._call``) because their argument values are
SegValues / Lambda nodes rather than flat tensors; the registry entries below
exist for parse-time type resolution only.  Positions are int64 here (the JAX
package's are int32); every multi-operand ``lax.sort`` is a chain of stable
``torch.sort`` calls (``ops/sortkey.py sort_operands``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...dtypes import (
    BIGINT,
    BOOLEAN,
    DOUBLE,
    RowType,
    TypeKind,
    array as array_t,
    map_ as map_t,
)
from ...expr.ir import Call, Expr, FieldAccess, Lambda
from ...expr.registry import ANY, DEFAULT_REGISTRY, INTEGER as INT_M, NUMERIC
from ...expr.seg import Elems, SegValue
from ...ops.segmented import rank_in_segments, segmented_scan
from ...ops.segpool import (
    compact_pool,
    dense_starts,
    owner_rows,
    segment_any,
    segment_reduce,
)
from ...ops.sortkey import sort_operands

# sentinel above every pool position / row id (the JAX package's int32 max)
_BIG = 2**62


def _and(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _or(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _result(ctx, values, validity=None, errors=None, strings=None):
    from ...expr.compiler import EvalResult

    return EvalResult(values, validity, errors, strings)


def _take(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """values[indices] with indices clamped into range (``mode="clip"``)."""
    idx = indices.to(torch.int64).clamp(0, max(values.shape[0] - 1, 0))
    return values.index_select(0, idx)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _shift_prev(x: torch.Tensor) -> torch.Tensor:
    """``x`` rolled by one (jnp.roll(x, 1)): slot i holds x[i - 1]."""
    return torch.roll(x, 1, 0)


def _same_as_prev(*keys: torch.Tensor) -> torch.Tensor:
    """True where every key equals the previous slot's; False at slot 0."""
    same = None
    for k in keys:
        eq = k == _shift_prev(k)
        same = eq if same is None else (same & eq)
    same = same.clone()
    if same.numel():
        same[0] = False
    return same


def _stable_partition(keep: torch.Tensor) -> torch.Tensor:
    """Permutation putting kept slots first, each side in its order
    (``jnp.argsort(~keep, stable=True)``)."""
    return torch.sort((~keep).to(torch.uint8), stable=True).indices


# ---------------------------------------------------------------------------
# lambda evaluation


def _free_fields(expr: Expr, bound: frozenset) -> List[FieldAccess]:
    out: Dict[str, FieldAccess] = {}

    def walk(e: Expr, bound_names):
        if isinstance(e, FieldAccess):
            if e.name not in bound_names and e.name not in out:
                out[e.name] = e
            return
        if isinstance(e, Lambda):
            bound_names = bound_names | set(e.params)
        for c in e.children:
            walk(c, bound_names)

    walk(expr, set(bound))
    return list(out.values())


def _eval_lambda(
    ctx,
    lam: Lambda,
    bindings: List[Elems],
    size: int,
    rowid: Optional[torch.Tensor],
):
    """Evaluate a lambda body over ``size`` slots.

    ``bindings`` supplies the parameter element pools; free (captured) outer
    columns are gathered per slot through ``rowid`` (None = slots are rows).
    Returns an EvalResult over the slots.
    """
    from ...expr.compiler import EvalContext
    from ...vector.column import Batch, Column

    names = list(lam.params)
    cols: List[Column] = []
    for elems in bindings:
        if isinstance(elems.values, SegValue):
            cols.append(elems.values.to_column(elems.validity))
        else:
            cols.append(
                Column.flat(elems.values, elems.dtype, elems.validity, elems.strings)
            )
    types = [e.dtype for e in bindings]
    for fa in _free_fields(lam.body, frozenset(lam.params)):
        col = ctx.batch.column(fa.name)
        values, validity = col.decode(ctx.capacity)
        if rowid is not None:
            values = _take(values, rowid)
            if validity is not None:
                validity = _take(validity, rowid)
        names.append(fa.name)
        types.append(fa.dtype)
        cols.append(Column.flat(values, fa.dtype, validity, col.strings))
    pseudo = Batch.make(
        RowType(names, types), cols, size, capacity=size, device=ctx.device
    )
    sub = EvalContext(pseudo, ctx.registry)
    return sub.evaluate(lam.body)


# ---------------------------------------------------------------------------
# shared helpers


def _seg_arg(ctx, e: Expr):
    r = ctx.evaluate(e)
    assert isinstance(r.values, SegValue), f"{e} did not produce a SegValue"
    return r


def _elem_result(ctx, elems: Elems, pos, ok, row_validity, errors):
    """Gather pool elements at per-row positions -> EvalResult."""
    taken = elems.take(pos.clamp(0, elems.pool_cap - 1))
    validity = _and(_and(taken.validity, ok), row_validity)
    if validity is None:
        validity = ok
    return _result(ctx, taken.values, validity, errors, strings=taken.strings)


def _broadcast_rows(values, validity, rowid):
    v = _take(values, rowid)
    val = None if validity is None else _take(validity, rowid)
    return v, val


def _null_key(elems: Elems) -> torch.Tensor:
    """1 for a NULL element, 0 otherwise (NULLs sort after values)."""
    if elems.validity is None:
        return torch.zeros(
            (elems.pool_cap,), dtype=torch.int64, device=elems.values.device
        )
    return (~elems.validity).to(torch.int64)


def _row_key(norm) -> torch.Tensor:
    """Owning row of each live pool slot; dead slots sort last."""
    return torch.where(norm.emask, norm.rowid, torch.full_like(norm.rowid, _BIG))


# ---------------------------------------------------------------------------
# array functions


def _cardinality(ctx, expr: Call):
    r = ctx.evaluate(expr.args[0])
    seg = r.values
    return _result(ctx, seg.sizes.to(torch.int64), r.validity, r.errors)


def _array_index(ctx, expr: Call, strict: bool):
    r = _seg_arg(ctx, expr.args[0])
    seg: SegValue = r.values
    i = ctx.evaluate(expr.args[1])
    idx = i.values.to(torch.int64)
    sizes = seg.sizes.to(torch.int64)
    eff = torch.where(idx < 0, sizes + idx, idx - 1)
    oob = (eff < 0) | (eff >= sizes) | (idx == 0)
    pos = seg.starts.to(torch.int64) + eff
    row_validity = _and(r.validity, i.validity)
    errors = _or(r.errors, i.errors)
    if strict:
        err = oob if row_validity is None else (oob & row_validity)
        errors = _or(errors, err)
        return _elem_result(
            ctx, seg.children[0], pos, torch.ones_like(oob), row_validity, errors
        )
    return _elem_result(ctx, seg.children[0], pos, ~oob, row_validity, errors)


def _map_lookup(ctx, expr: Call, strict: bool):
    r = _seg_arg(ctx, expr.args[0])
    k = ctx.evaluate(expr.args[1])
    norm = r.values.normalized()
    keys, vals = norm.children
    k_pool, k_val = _broadcast_rows(k.values, k.validity, norm.rowid)
    match = norm.emask & (keys.values == k_pool)
    if keys.validity is not None:
        match = match & keys.validity
    if k_val is not None:
        match = match & k_val
    pool_cap = keys.pool_cap
    pos_arr = torch.where(match, _arange(pool_cap, ctx.device), _BIG)
    first = segment_reduce(
        pos_arr, norm.starts, norm.sizes, norm.rowid, norm.emask, "min", init=_BIG
    )
    found = first != _BIG
    row_validity = _and(r.validity, k.validity)
    errors = _or(r.errors, k.errors)
    if strict:
        miss = ~found if row_validity is None else (~found & row_validity)
        errors = _or(errors, miss)
        return _elem_result(
            ctx, vals, first, torch.ones_like(found), row_validity, errors
        )
    return _elem_result(ctx, vals, first, found, row_validity, errors)


def _subscript(ctx, expr: Call):
    if expr.args[0].dtype.kind == TypeKind.MAP:
        return _map_lookup(ctx, expr, strict=True)
    return _array_index(ctx, expr, strict=True)


def _element_at(ctx, expr: Call):
    if expr.args[0].dtype.kind == TypeKind.MAP:
        return _map_lookup(ctx, expr, strict=False)
    return _array_index(ctx, expr, strict=False)


def _contains(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    x = ctx.evaluate(expr.args[1])
    norm = r.values.normalized()
    elems = norm.children[0]
    x_pool, x_val = _broadcast_rows(x.values, x.validity, norm.rowid)
    ev = elems.validity
    match = norm.emask & (elems.values == x_pool)
    if ev is not None:
        match = match & ev
    if x_val is not None:
        match = match & x_val
    args4 = (norm.starts, norm.sizes, norm.rowid, norm.emask)
    has = segment_any(match, *args4)
    has_null = (
        segment_any(norm.emask & ~ev, *args4)
        if ev is not None
        else torch.zeros_like(has)
    )
    # Presto: TRUE on match; NULL if no match but a null element exists
    validity = has | ~has_null
    validity = _and(validity, _and(r.validity, x.validity))
    return _result(ctx, has, validity, _or(r.errors, x.errors))


def _array_position(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    x = ctx.evaluate(expr.args[1])
    norm = r.values.normalized()
    elems = norm.children[0]
    x_pool, x_val = _broadcast_rows(x.values, x.validity, norm.rowid)
    match = norm.emask & (elems.values == x_pool)
    if elems.validity is not None:
        match = match & elems.validity
    if x_val is not None:
        match = match & x_val
    pos = _arange(elems.pool_cap, ctx.device)
    offset = pos - _take(norm.starts, norm.rowid) + 1
    cand = torch.where(match, offset, _BIG)
    first = segment_reduce(
        cand, norm.starts, norm.sizes, norm.rowid, norm.emask, "min", init=_BIG
    )
    out = torch.where(first == _BIG, 0, first).to(torch.int64)
    validity = _and(r.validity, x.validity)
    return _result(ctx, out, validity, _or(r.errors, x.errors))


def _array_minmax(op: str):
    """array_min / array_max.  VARCHAR elements compare by their place in
    the dictionary's sorted order (the JAX package compares their codes,
    which follow insertion order: ROADMAP Queue 3)."""

    def fn(ctx, expr: Call):
        r = _seg_arg(ctx, expr.args[0])
        norm = r.values.normalized()
        elems = norm.children[0]
        args4 = (norm.starts, norm.sizes, norm.rowid, norm.emask)
        if elems.dtype.is_string and elems.strings is not None:
            ranks = np.asarray(elems.strings.sort_permutation(), np.int64)
            code_of = np.empty(len(ranks), np.int64)
            code_of[ranks] = np.arange(len(ranks))
            best = segment_reduce(_order_key(elems), *args4, op)
            out = _take(torch.as_tensor(code_of, device=ctx.device), best).to(elems.values.dtype)
        else:
            out = segment_reduce(elems.values, *args4, op)
        nonempty = norm.sizes > 0
        validity = nonempty
        if elems.validity is not None:
            # Presto: NULL if the array contains a null element
            has_null = segment_any(norm.emask & ~elems.validity, *args4)
            validity = validity & ~has_null
        validity = _and(validity, r.validity)
        return _result(ctx, out, validity, r.errors, strings=elems.strings)

    return fn


def _array_sum(ctx, expr: Call):
    """Per-row sum of elements, null elements skipped (Spark semantics)."""
    r = _seg_arg(ctx, expr.args[0])
    norm = r.values.normalized()
    elems = norm.children[0]
    v = elems.values
    if not v.dtype.is_floating_point:
        v = v.to(torch.int64)
    out = segment_reduce(
        v,
        norm.starts,
        norm.sizes,
        norm.rowid,
        norm.emask,
        "sum",
        value_mask=elems.validity,
    )
    return _result(ctx, out, r.validity, r.errors)


def _order_key(elems: Elems) -> torch.Tensor:
    """Ordering key for pool elements: strings order by their rank in the
    dictionary's sorted order, floats by ``float_to_ordered_i64`` (NaN after
    every number, subnormals in IEEE order), integers as they are."""
    from ...exec.sort import float_to_ordered_i64

    v = elems.values
    if elems.dtype.is_string and elems.strings is not None:
        ranks = torch.as_tensor(
            np.asarray(elems.strings.sort_permutation(), np.int64), device=v.device
        )
        return _take(ranks, v)
    if v.dtype.is_floating_point:
        return float_to_ordered_i64(v)
    return v.to(torch.int64)


def _array_sort(ctx, expr: Call, desc: bool = False):
    r = _seg_arg(ctx, expr.args[0])
    norm = r.values.normalized()
    elems = norm.children[0]
    order = _order_key(elems)
    if desc:
        # bitwise NOT of the order-preserving int64 (exec/sort.py); NULLs
        # stay last (Presto array_sort_desc keeps nulls last too)
        order = ~order
    ops = [_row_key(norm), _null_key(elems), order, elems.values]
    if elems.validity is not None:
        ops.append(elems.validity)
    sorted_ops = sort_operands(ops, num_keys=3)
    values = sorted_ops[3]
    validity = sorted_ops[4] if elems.validity is not None else None
    out = SegValue(
        norm.starts,
        norm.sizes,
        (Elems(values, validity, elems.dtype, elems.strings),),
        r.values.dtype,
    )
    return _result(ctx, out, r.validity, r.errors)


def _array_sort_desc(ctx, expr: Call):
    return _array_sort(ctx, expr, desc=True)


def _array_union(ctx, expr: Call):
    """array_union(x, y) = array_distinct(concat(x, y)) — the reference's
    ArrayUnionFunction builds the same dedup-of-concat (ArraySetOps)."""
    inner = Call(expr.dtype, "concat", (expr.args[0], expr.args[1]))
    return _array_distinct(ctx, Call(expr.dtype, "array_distinct", (inner,)))


def _row_sums(values: torch.Tensor, live: torch.Tensor, starts, sizes) -> torch.Tensor:
    """Per-row segment sums over a row-contiguous pool: cumsum differences
    at [start, start+size)."""
    masked = torch.where(live, values, torch.zeros_like(values))
    c = torch.cumsum(masked, 0)
    end = (starts + sizes - 1).clamp(0, masked.shape[0] - 1)
    upper = _take(c, end)
    lower = torch.where(
        starts > 0, _take(c, (starts - 1).clamp(min=0)), torch.zeros_like(upper)
    )
    return torch.where(sizes > 0, upper - lower, torch.zeros_like(upper))


def _array_normalize(ctx, expr: Call):
    """array_normalize(x, p): divide by the p-norm; zero norm returns the
    input unchanged (reference: ArrayNormalizeFunction.h)."""
    r = _seg_arg(ctx, expr.args[0])
    pr = ctx.evaluate(expr.args[1])
    p = pr.values.to(torch.float64)
    norm_ = r.values.normalized()
    elems = norm_.children[0]
    v = elems.values.to(torch.float64)
    live = norm_.emask
    if elems.validity is not None:
        live = live & elems.validity
    rid = norm_.rowid.clamp(0, ctx.capacity - 1)
    p_elem = _take(p, rid)
    total = _row_sums(v.abs() ** p_elem, live, norm_.starts, norm_.sizes)
    norm_val = total ** (1.0 / p.clamp(min=1e-300))
    scale = torch.where(norm_val > 0, 1.0 / norm_val, torch.ones_like(norm_val))
    out_v = v * _take(scale, rid)
    out = SegValue(
        norm_.starts,
        norm_.sizes,
        (Elems(out_v, elems.validity, DOUBLE, None),),
        expr.dtype,
    )
    return _result(
        ctx, out, _and(r.validity, pr.validity), _or(r.errors, pr.errors)
    )


def _first_occurrence(norm, elems) -> torch.Tensor:
    """Keep-first dedup flags over a normalized pool (array_distinct core):
    sort by (row, null?, value) carrying position; the first of each equal
    run wins; the flags route back to pool order by position."""
    pos = _arange(elems.pool_cap, elems.values.device)
    rk, nk, vv, ps = sort_operands(
        [_row_key(norm), _null_key(elems), elems.values, pos], num_keys=3
    )
    keep_sorted = ~_same_as_prev(rk, nk, vv)
    keep = torch.empty_like(keep_sorted)
    keep[ps] = keep_sorted
    return keep


def _array_distinct(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    norm = r.values.normalized()
    elems = norm.children[0]
    keep = _first_occurrence(norm, elems) & norm.emask
    return _compacted(ctx, r, norm, elems, keep, r.values.dtype)


def _compacted(ctx, r, norm, elems, keep, dtype, row_validity=None, errors=None):
    pools = [elems.values]
    if elems.validity is not None:
        pools.append(elems.validity)
    starts, sizes, new_pools, _, _ = compact_pool(
        keep, norm.starts, norm.sizes, norm.rowid, norm.emask, tuple(pools)
    )
    validity = new_pools[1] if elems.validity is not None else None
    out = SegValue(
        starts,
        sizes,
        (Elems(new_pools[0], validity, elems.dtype, elems.strings),),
        dtype,
    )
    if row_validity is None and errors is None:
        row_validity, errors = r.validity, r.errors
    return _result(ctx, out, row_validity, errors)


def _slice(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    seg: SegValue = r.values
    s = ctx.evaluate(expr.args[1])
    n = ctx.evaluate(expr.args[2])
    start1 = s.values.to(torch.int64)
    length = n.values.to(torch.int64).clamp(min=0)
    sizes = seg.sizes.to(torch.int64)
    eff = torch.where(start1 < 0, sizes + start1, start1 - 1)
    errors = (start1 == 0) | (n.values.to(torch.int64) < 0)
    eff_c = torch.minimum(eff.clamp(min=0), sizes)
    new_sizes = torch.minimum(length, sizes - eff_c).clamp(min=0)
    new_starts = seg.starts.to(torch.int64) + eff_c
    row_validity = _and(_and(r.validity, s.validity), n.validity)
    if row_validity is not None:
        errors = errors & row_validity
    out = SegValue(new_starts, new_sizes, seg.children, seg.dtype)
    return _result(
        ctx, out, row_validity, _or(_or(r.errors, s.errors), _or(n.errors, errors))
    )


def _reverse(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    norm = r.values.normalized()
    starts_p = _take(norm.starts, norm.rowid)
    sizes_p = _take(norm.sizes, norm.rowid)
    pos = _arange(norm.children[0].pool_cap, ctx.device)
    src = starts_p + sizes_p - 1 - (pos - starts_p)
    src = torch.where(norm.emask, src, pos)
    new_children = tuple(ch.take(src) for ch in norm.children)
    out = SegValue(norm.starts, norm.sizes, new_children, r.values.dtype)
    return _result(ctx, out, r.validity, r.errors)


def _concat_arrays(ctx, expr: Call):
    results = [_seg_arg(ctx, a) for a in expr.args]
    segs = [r.values for r in results]
    elem_t = segs[0].dtype.element
    if elem_t.is_complex:
        raise NotImplementedError("concat of nested arrays")
    tables = {id(s.children[0].strings) for s in segs if s.children[0].strings}
    if len(tables) > 1:
        raise TypeError("concat: VARCHAR arrays must share one dictionary")
    sizes_list = [s.sizes.to(torch.int64) for s in segs]
    out_sizes = sum(sizes_list[1:], sizes_list[0])
    out_starts = dense_starts(out_sizes)
    pool_cap = sum(s.pool_cap for s in segs)
    rowid = owner_rows(out_starts, pool_cap)
    pos = _arange(pool_cap, ctx.device)
    offset = pos - _take(out_starts, rowid)
    # which source array does this offset fall in, and at which index
    big_values = torch.cat([s.children[0].values for s in segs])
    any_validity = any(s.children[0].validity is not None for s in segs)
    big_validity = (
        torch.cat([s.children[0].validity_or_true() for s in segs])
        if any_validity
        else None
    )
    src = torch.zeros((pool_cap,), dtype=torch.int64, device=ctx.device)
    chosen = torch.zeros((pool_cap,), dtype=torch.bool, device=ctx.device)
    prefix_sizes = torch.zeros((pool_cap,), dtype=torch.int64, device=ctx.device)
    base = 0
    for s in segs:
        sz = _take(s.sizes.to(torch.int64), rowid)
        st = _take(s.starts.to(torch.int64), rowid)
        local = offset - prefix_sizes
        here = (~chosen) & (local < sz)
        src = torch.where(here, base + st + local, src)
        chosen = chosen | here
        prefix_sizes = prefix_sizes + sz
        base += s.pool_cap
    values = _take(big_values, src)
    validity = None if big_validity is None else _take(big_validity, src)
    strings = next((s.children[0].strings for s in segs if s.children[0].strings), None)
    row_validity = None
    errors = None
    for r in results:
        row_validity = _and(row_validity, r.validity)
        errors = _or(errors, r.errors)
    out = SegValue(
        out_starts,
        out_sizes,
        (Elems(values, validity, elem_t, strings),),
        segs[0].dtype,
    )
    return _result(ctx, out, row_validity, errors)


def _flatten(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    outer = r.values.normalized()
    inner_elems = outer.children[0]
    assert isinstance(inner_elems.values, SegValue)
    inner: SegValue = inner_elems.values
    inner_norm = inner.normalized()  # dense by outer pool slot == by row
    out_sizes = segment_reduce(
        inner.sizes.to(torch.int64),
        outer.starts,
        outer.sizes,
        outer.rowid,
        outer.emask,
        "sum",
        init=0,
    )
    out = SegValue(
        dense_starts(out_sizes), out_sizes, inner_norm.children, expr.dtype
    )
    return _result(ctx, out, r.validity, r.errors)


def _array_constructor(ctx, expr: Call):
    k = len(expr.args)
    cap = ctx.capacity
    if k == 0:
        zeros = torch.zeros((cap,), dtype=torch.int64, device=ctx.device)
        out = SegValue(
            zeros,
            zeros,
            (
                Elems(
                    torch.zeros(
                        (8,), dtype=expr.dtype.element.device_dtype, device=ctx.device
                    ),
                    None,
                    expr.dtype.element,
                ),
            ),
            expr.dtype,
        )
        return _result(ctx, out)
    results = [ctx.evaluate(a) for a in expr.args]
    errors = None
    for r in results:
        errors = _or(errors, r.errors)
    if expr.dtype.element.is_complex:
        return _array_constructor_nested(ctx, expr, results, errors)
    want = expr.dtype.element.device_dtype
    values = torch.stack([r.values.to(want) for r in results], dim=1).reshape(cap * k)
    any_validity = any(r.validity is not None for r in results)
    validity = None
    if any_validity:
        validity = torch.stack(
            [r.validity_or_true(cap) for r in results], dim=1
        ).reshape(cap * k)
    strings = None
    for a in expr.args:
        if a.dtype.is_string:
            from ...expr.compiler import _strings_of

            strings = _strings_of(a, ctx.batch)
            break
    sizes = torch.full((cap,), k, dtype=torch.int64, device=ctx.device)
    starts = _arange(cap, ctx.device) * k
    out = SegValue(
        starts,
        sizes,
        (Elems(values, validity, expr.dtype.element, strings),),
        expr.dtype,
    )
    return _result(ctx, out, None, errors)


def _array_constructor_nested(ctx, expr: Call, results, errors):
    """ARRAY[a, b, ...] where elements are themselves ARRAY/MAP values.

    Outer rows get k elements; the outer element pool interleaves the k
    arguments' spans, rebased onto one concatenated inner pool.
    """
    k = len(results)
    cap = ctx.capacity
    segs: List[SegValue] = [r.values for r in results]
    inner0 = segs[0].children
    for s in segs[1:]:
        for a, b in zip(inner0, s.children):
            if isinstance(a.values, SegValue) or isinstance(b.values, SegValue):
                raise NotImplementedError("ARRAY[...] nesting beyond two levels")
            if a.strings is not b.strings:
                raise TypeError("ARRAY[...]: element dictionaries must match")
    bases = []
    off = 0
    for s in segs:
        bases.append(off)
        off += s.pool_cap
    nested_starts = torch.stack(
        [s.starts.to(torch.int64) + b for s, b in zip(segs, bases)], dim=1
    ).reshape(cap * k)
    nested_sizes = torch.stack(
        [s.sizes.to(torch.int64) for s in segs], dim=1
    ).reshape(cap * k)
    elem_validity = None
    if any(r.validity is not None for r in results):
        elem_validity = torch.stack(
            [r.validity_or_true(cap) for r in results], dim=1
        ).reshape(cap * k)
    new_children = []
    for ci in range(len(inner0)):
        values = torch.cat([s.children[ci].values for s in segs])
        any_v = any(s.children[ci].validity is not None for s in segs)
        validity = (
            torch.cat([s.children[ci].validity_or_true() for s in segs])
            if any_v
            else None
        )
        new_children.append(
            Elems(values, validity, inner0[ci].dtype, inner0[ci].strings)
        )
    inner_seg = SegValue(
        nested_starts, nested_sizes, tuple(new_children), expr.dtype.element
    )
    out = SegValue(
        _arange(cap, ctx.device) * k,
        torch.full((cap,), k, dtype=torch.int64, device=ctx.device),
        (Elems(inner_seg, elem_validity, expr.dtype.element),),
        expr.dtype,
    )
    return _result(ctx, out, None, errors)


def _repeat(ctx, expr: Call):
    from ...expr.ir import Constant

    count = expr.args[1]
    if not isinstance(count, Constant):
        raise NotImplementedError("repeat(x, n) needs a constant n")
    k = max(int(count.value or 0), 0)
    return _array_constructor(
        ctx, Call(expr.dtype, "array_constructor", (expr.args[0],) * k)
    )


def _aligned_values(elems_list):
    """Comparable values across pools: strings from different dictionaries
    remap into one combined dictionary (a host array + one gather)."""
    if not elems_list[0].dtype.is_string:
        return [e.values for e in elems_list], elems_list[0].strings
    tables = [e.strings for e in elems_list]
    if all(t is tables[0] for t in tables):
        return [e.values for e in elems_list], tables[0]
    from ...vector.string_table import StringTable

    combined = StringTable()
    out = []
    for e, t in zip(elems_list, tables):
        values = t.values() if t is not None else [""]
        remap = torch.as_tensor(
            np.asarray([combined.intern(v) for v in values], np.int32),
            device=e.values.device,
        )
        out.append(_take(remap, e.values))
    return out, combined


def _membership(ra, rb):
    """For each element of a's pool: does b's same-row segment contain it?

    One combined sort by (row, null?, value, source) with b's elements first,
    then an inclusive segmented max of "saw b" over equal-value runs — a's
    duplicates and nulls all resolve in the same pass.  Returns
    (na, match_a[bool over a's pool]).
    """
    na = ra.values.normalized()
    nb = rb.values.normalized()
    ea, eb = na.children[0], nb.children[0]
    Pa, Pb = ea.pool_cap, eb.pool_cap
    dev = ea.values.device
    rid = torch.cat([_row_key(na), _row_key(nb)])
    nullk = torch.cat([_null_key(ea), _null_key(eb)])
    (av, bv), _ = _aligned_values([ea, eb])
    val = torch.cat([av, bv.to(av.dtype)])
    src = torch.cat(
        [
            torch.ones((Pa,), dtype=torch.int64, device=dev),
            torch.zeros((Pb,), dtype=torch.int64, device=dev),
        ]
    )  # b sorts first at equal keys
    pos = torch.cat([_arange(Pa, dev), _arange(Pb, dev)])
    rs, ns, vs, ss, ps = sort_operands([rid, nullk, val, src, pos], num_keys=4)
    boundary = ~_same_as_prev(rs, ns, vs)
    from_b = (ss == 0).to(torch.int64)
    saw_b = segmented_scan(from_b, boundary, "max")
    # route back to a's pool positions (a slots have src=1)
    match_a = torch.zeros((Pa,), dtype=torch.bool, device=dev)
    is_a = ss == 1
    match_a[ps[is_a]] = saw_b[is_a] > 0
    return na, match_a


def _array_setop(which: str):
    def fn(ctx, expr: Call):
        ra = _seg_arg(ctx, expr.args[0])
        rb = _seg_arg(ctx, expr.args[1])
        na, match_a = _membership(ra, rb)
        elems = na.children[0]
        row_validity = _and(ra.validity, rb.validity)
        errors = _or(ra.errors, rb.errors)
        if which == "overlap":
            args4 = (na.starts, na.sizes, na.rowid, na.emask)
            ev = elems.validity
            valid_match = match_a
            if ev is not None:
                valid_match = match_a & ev
            has = segment_any(valid_match & na.emask, *args4)
            # NULL if no definite match but a null element exists on either side
            has_null = (
                segment_any(na.emask & ~ev, *args4)
                if ev is not None
                else torch.zeros_like(has)
            )
            validity = _and(has | ~has_null, row_validity)
            return _result(ctx, has, validity, errors)
        keep = _first_occurrence(na, elems)
        keep = keep & (match_a if which == "intersect" else ~match_a)
        return _compacted(ctx, ra, na, elems, keep, expr.dtype, row_validity, errors)

    return fn


def _cosine_similarity(ctx, expr: Call):
    """cosine_similarity(map(K, double), map(K, double)) — dot product over
    matching keys / (norm_a * norm_b).

    Matching uses map key uniqueness: one combined sort by (row, key, source)
    places b's entry directly before a's entry of the same key, so the
    matched value is a shift-by-one compare.
    """
    ra = _seg_arg(ctx, expr.args[0])
    rb = _seg_arg(ctx, expr.args[1])
    na = ra.values.normalized()
    nb = rb.values.normalized()
    ka, va = na.children[0], na.children[1]
    kb, vb = nb.children[0], nb.children[1]
    Pa, Pb = ka.pool_cap, kb.pool_cap
    dev = ka.values.device
    rid = torch.cat([_row_key(na), _row_key(nb)])
    (kav, kbv), _ = _aligned_values([ka, kb])
    key = torch.cat([kav.to(torch.int64), kbv.to(torch.int64)])
    src = torch.cat(
        [
            torch.ones((Pa,), dtype=torch.int64, device=dev),
            torch.zeros((Pb,), dtype=torch.int64, device=dev),
        ]
    )
    val = torch.cat([va.values.to(torch.float64), vb.values.to(torch.float64)])
    pos = torch.cat([_arange(Pa, dev), _arange(Pb, dev)])
    s_rid, s_key, s_src, s_val, s_pos = sort_operands(
        [rid, key, src, val, pos], num_keys=3
    )
    prev_match = (
        (s_src == 1)
        & (_shift_prev(s_src) == 0)
        & (s_rid == _shift_prev(s_rid))
        & (s_key == _shift_prev(s_key))
    ).clone()
    prev_match[0] = False
    prod = torch.where(prev_match, s_val * _shift_prev(s_val), torch.zeros_like(s_val))
    # route products back to a-pool order
    prod_a = torch.zeros((Pa,), dtype=torch.float64, device=dev)
    is_a = s_src == 1
    prod_a[s_pos[is_a]] = prod[is_a]
    dot = _row_sums(prod_a, na.emask, na.starts, na.sizes)
    va_live = na.emask & va.validity_or_true()
    vb_live = nb.emask & vb.validity_or_true()
    norm_a = torch.sqrt(
        _row_sums(va.values.to(torch.float64) ** 2, va_live, na.starts, na.sizes)
    )
    norm_b = torch.sqrt(
        _row_sums(vb.values.to(torch.float64) ** 2, vb_live, nb.starts, nb.sizes)
    )
    out = dot / (norm_a * norm_b)
    return _result(ctx, out, _and(ra.validity, rb.validity), _or(ra.errors, rb.errors))


def _row_sizes(kr: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-row entry counts of a compacted pool whose slots carry their row
    (dead slots ``_BIG``): kept entries with row <= r, differenced."""
    n = kr.shape[0]
    upto = rank_in_segments(
        torch.zeros((n,), dtype=torch.int64, device=kr.device),
        kr.to(torch.int64),
        torch.zeros((cap,), dtype=torch.int64, device=kr.device),
        _arange(cap, kr.device),
        inclusive=True,
    )
    prev = torch.cat([torch.zeros((1,), dtype=upto.dtype, device=upto.device), upto[:-1]])
    return upto - prev


def _map_concat(ctx, expr: Call):
    """map_concat(m1, m2, ...): union of entries; later maps win on key clashes
    (reference: MapConcat.cpp)."""
    results = [_seg_arg(ctx, a) for a in expr.args]
    norms = [r.values.normalized() for r in results]
    cap = ctx.capacity
    dev = ctx.device
    rid = torch.cat([_row_key(n) for n in norms])
    key_aligned, key_table = _aligned_values([n.children[0] for n in norms])
    val_aligned, val_table = _aligned_values([n.children[1] for n in norms])
    keyv = torch.cat([k.to(torch.int64) for k in key_aligned])
    # later maps sort first at equal keys so their entry survives the dedup
    src = torch.cat(
        [
            torch.full((n.children[0].pool_cap,), len(norms) - i, dtype=torch.int64, device=dev)
            for i, n in enumerate(norms)
        ]
    )
    vals = torch.cat([v.to(val_aligned[0].dtype) for v in val_aligned])
    vvalid = torch.cat([n.children[1].validity_or_true() for n in norms])
    rs, ks, _, vs, vv = sort_operands([rid, keyv, src, vals, vvalid], num_keys=3)
    dup = _same_as_prev(rs, ks)
    keep = ~dup & (rs != _BIG)
    # stable partition keeps (row, key) order; the pool is then normalized
    perm = _stable_partition(keep)
    total = keep.sum()
    kk = ks.index_select(0, perm)
    kv = vs.index_select(0, perm)
    kvv = vv.index_select(0, perm)
    kr = rs.index_select(0, perm)
    # dropped slots (beyond the kept prefix) must not count toward any row
    kr = torch.where(_arange(kr.shape[0], dev) < total, kr, _BIG)
    sizes = _row_sizes(kr, cap)
    key_t = expr.dtype.key_type
    val_t = expr.dtype.value_type
    row_validity = None
    errors = None
    for r in results:
        row_validity = _and(row_validity, r.validity)
        errors = _or(errors, r.errors)
    out = SegValue(
        dense_starts(sizes),
        sizes,
        (
            Elems(kk.to(key_t.device_dtype), None, key_t, key_table),
            Elems(kv, kvv, val_t, val_table),
        ),
        expr.dtype,
    )
    return _result(ctx, out, row_validity, errors)


def _split(ctx, expr: Call):
    """split(s, delim) -> array(varchar) (reference: SplitFunctions.cpp).

    The string dictionary is known before evaluation: each distinct value
    splits once on the host into a shared parts pool; per-row spans then
    expand into a dense pool sized capacity x longest split."""
    from ...expr.compiler import _strings_of
    from ...expr.ir import Constant
    from ...vector.string_table import StringTable

    s = ctx.evaluate(expr.args[0])
    delim_e = expr.args[1]
    if not isinstance(delim_e, Constant) or not isinstance(delim_e.value, str):
        raise TypeError("split() needs a literal delimiter")
    table = _strings_of(expr.args[0], ctx.batch)
    if table is None:
        raise TypeError("split() requires a dictionary-backed string input")
    # reuse the bind-time parts dictionary when present (expr.ir.StringsCall)
    # so static provenance and the evaluated codes agree; intern() is
    # deterministic, so re-filling it here yields identical codes
    out_table = getattr(expr, "strings", None) or StringTable()
    cs, cz, pool, max_parts = _split_parts(table, delim_e.value, out_table, ctx.device)
    cap = ctx.capacity
    if cap * max(max_parts, 1) > (1 << 26):
        raise NotImplementedError(
            "split(): dictionary has very long splits; output pool too large"
        )
    dev = ctx.device
    codes = s.values.to(torch.int64)
    sizes = _take(cz, codes)
    if s.validity is not None:
        sizes = torch.where(s.validity, sizes, 0)
    out_starts = dense_starts(sizes)
    pool_cap = max(_next_pow2(cap * max(max_parts, 1)), 8)
    rowid = owner_rows(out_starts, pool_cap)
    offset = _arange(pool_cap, dev) - _take(out_starts, rowid)
    src = _take(cs, _take(codes, rowid)) + offset
    values = _take(pool, src)
    out = SegValue(
        out_starts,
        sizes,
        (Elems(values, None, expr.dtype.element, out_table),),
        expr.dtype,
    )
    return _result(ctx, out, s.validity, s.errors)


_SPLIT_CACHE: Dict[tuple, tuple] = {}


def _split_parts(table, delim: str, out_table, device):
    """Every dictionary entry of ``table`` split once on the host: per code
    its first part's position in a shared parts pool and its part count,
    the pool of part codes in ``out_table``, and the longest split — on
    ``device``.  Kept for the next tile and run over the same dictionary
    (the JAX package splits once per trace); a dictionary that grew, or
    another one, splits anew.  At most four splits are kept."""
    key = (id(table), len(table), delim, id(out_table), str(device))
    hit = _SPLIT_CACHE.get(key)
    if hit is not None and hit[0] is table and hit[1] is out_table:
        return hit[2]
    code_starts, code_sizes, pool_codes = [], [], []
    for v in table.values():
        parts = v.split(delim) if v else []
        code_starts.append(len(pool_codes))
        code_sizes.append(len(parts))
        pool_codes.extend(out_table.intern(p) for p in parts)
    parts = (
        torch.as_tensor(np.asarray(code_starts, np.int64), device=device),
        torch.as_tensor(np.asarray(code_sizes, np.int64), device=device),
        torch.as_tensor(np.asarray(pool_codes or [0], np.int32), device=device),
        max(code_sizes, default=0),
    )
    if len(_SPLIT_CACHE) >= 4:
        _SPLIT_CACHE.pop(next(iter(_SPLIT_CACHE)))
    _SPLIT_CACHE[key] = (table, out_table, parts)
    return parts


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _sequence(ctx, expr: Call):
    """sequence(lo, hi) with literal bounds -> per-row constant array."""
    from ...expr.ir import Constant

    lo_e, hi_e = expr.args[0], expr.args[1]
    if not (isinstance(lo_e, Constant) and isinstance(hi_e, Constant)):
        raise NotImplementedError("sequence() needs literal bounds here")
    lo, hi = int(lo_e.value), int(hi_e.value)
    step = 1 if hi >= lo else -1
    values = list(range(lo, hi + step, step))
    if len(values) > 10000:
        raise ValueError("sequence exceeds 10000 entries (Presto's cap)")
    elems = tuple(Constant(lo_e.dtype, v) for v in values)
    return _array_constructor(
        ctx, Call(expr.dtype, "array_constructor", elems)
    )


def _array_join_gate(ctx, expr: Call):
    """array_join is lowered by the string-construction plan rewrite
    (exec/strcast.py) when it is a top-level projected output; any other
    position needs the joined string's VALUE on the device, which has no
    dictionary form.  Reference: ArrayJoin in
    velox/functions/prestosql/ArrayFunctions."""
    raise NotImplementedError(
        "array_join builds a data-dependent string; supported only as a "
        "top-level projected output column (rendered at materialization)"
    )


def _row_constructor(ctx, expr: Call):
    """row(a, b, ...) -> ROW value (reference: RowConstructor.cpp)."""
    from ...expr.seg import StructValue

    results = [ctx.evaluate(a) for a in expr.args]
    errors = None
    fields = []
    for a, r in zip(expr.args, results):
        errors = _or(errors, r.errors)
        strings = None
        if a.dtype.is_string:
            from ...expr.compiler import _strings_of

            strings = _strings_of(a, ctx.batch)
        fields.append(Elems(r.values, r.validity, a.dtype, strings))
    return _result(ctx, StructValue(tuple(fields), expr.dtype), None, errors)


def _row_field(ctx, expr: Call):
    """r.name / subscript(ROW, 'name') field access (reference:
    FieldReference.cpp dereference on ROW inputs)."""
    from ...expr.ir import Constant

    r = ctx.evaluate(expr.args[0])
    assert isinstance(expr.args[1], Constant)
    el = r.values.field(expr.args[1].value)
    validity = _and(el.validity, r.validity)
    return _result(ctx, el.values, validity, r.errors, strings=el.strings)


def _map_zip_with(ctx, expr: Call):
    """map_zip_with(m1, m2, (k, v1, v2) -> e): union of keys; absent side's
    value is NULL (reference: MapZipWithFunction.cpp)."""
    r1 = _seg_arg(ctx, expr.args[0])
    r2 = _seg_arg(ctx, expr.args[1])
    lam: Lambda = expr.args[2]
    norms = [r1.values.normalized(), r2.values.normalized()]
    cap = ctx.capacity
    dev = ctx.device
    P1 = norms[0].children[0].pool_cap
    P2 = norms[1].children[0].pool_cap
    rid = torch.cat([_row_key(n) for n in norms])
    key_aligned, key_table = _aligned_values([n.children[0] for n in norms])
    keyv = torch.cat([k.to(torch.int64) for k in key_aligned])
    src = torch.cat(
        [
            torch.zeros((P1,), dtype=torch.int64, device=dev),
            torch.ones((P2,), dtype=torch.int64, device=dev),
        ]
    )
    v1s, v2s = norms[0].children[1], norms[1].children[1]
    V1, V2 = v1s.pool_cap, v2s.pool_cap
    v1_all = torch.cat([v1s.values, torch.zeros((V2,), dtype=v1s.values.dtype, device=dev)])
    v2_all = torch.cat([torch.zeros((V1,), dtype=v2s.values.dtype, device=dev), v2s.values])
    val1_ok = torch.cat(
        [v1s.validity_or_true(), torch.zeros((V2,), dtype=torch.bool, device=dev)]
    )
    val2_ok = torch.cat(
        [torch.zeros((V1,), dtype=torch.bool, device=dev), v2s.validity_or_true()]
    )
    rs, ks, ss, w1, w2, o1, o2 = sort_operands(
        [rid, keyv, src, v1_all, v2_all, val1_ok, val2_ok], num_keys=3
    )
    # a (row, key) run has at most 2 entries (keys unique per map; m1 first)
    nxt_same = ((rs == torch.roll(rs, -1, 0)) & (ks == torch.roll(ks, -1, 0))).clone()
    nxt_same[-1] = False
    dup = _same_as_prev(rs, ks)
    keep = ~dup & (rs != _BIG)
    v1 = torch.where(ss == 0, w1, torch.zeros_like(w1))
    v1ok = (ss == 0) & o1
    w2_next = torch.roll(w2, -1, 0)
    o2_next = torch.roll(o2, -1, 0)
    v2 = torch.where(
        ss == 1, w2, torch.where(nxt_same, w2_next, torch.zeros_like(w2))
    )
    v2ok = torch.where(ss == 1, o2, nxt_same & o2_next)
    # compact kept entries to a dense row-ordered pool
    perm = _stable_partition(keep)
    total = keep.sum()
    pool_total = rs.shape[0]

    def take(a):
        return a.index_select(0, perm)

    kk, kr = take(ks), take(rs)
    kv1, kv1ok, kv2, kv2ok = take(v1), take(v1ok), take(v2), take(v2ok)
    emask = _arange(pool_total, dev) < total
    kr = torch.where(emask, kr, _BIG)
    sizes = _row_sizes(kr, cap)
    starts = dense_starts(sizes)
    rowid = torch.where(kr == _BIG, cap, kr)
    key_t = expr.dtype.key_type
    k_el = Elems(kk.to(key_t.device_dtype), None, key_t, key_table)
    v1t = expr.args[0].dtype.value_type
    v2t = expr.args[1].dtype.value_type
    body = _eval_lambda(
        ctx,
        lam,
        [
            k_el,
            Elems(kv1.to(v1t.device_dtype), kv1ok, v1t, v1s.strings),
            Elems(kv2.to(v2t.device_dtype), kv2ok, v2t, v2s.strings),
        ],
        pool_total,
        rowid.clamp(0, cap - 1),
    )
    row_validity = _and(r1.validity, r2.validity)
    errors = _or(r1.errors, r2.errors)
    if body.errors is not None:
        err_rows = segment_reduce(
            (body.errors & emask).to(torch.int64),
            starts,
            sizes,
            rowid.clamp(0, cap - 1),
            emask,
            "sum",
            init=0,
        )
        errors = _or(errors, err_rows > 0)
    out = SegValue(
        starts,
        sizes,
        (
            k_el,
            Elems(body.values, body.validity, lam.dtype, _body_strings(ctx, lam)),
        ),
        expr.dtype,
    )
    return _result(ctx, out, row_validity, errors)


def _spark_size(ctx, expr: Call):
    """Spark legacy size(): -1 for NULL input (sparksql/Size.cpp)."""
    r = ctx.evaluate(expr.args[0])
    seg = r.values
    sizes = seg.sizes.to(torch.int64)
    if r.validity is not None:
        sizes = torch.where(r.validity, sizes, -1)
    return _result(ctx, sizes, None, r.errors)


def _map_keys(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    seg = r.values
    out = SegValue(seg.starts, seg.sizes, (seg.children[0],), expr.dtype)
    return _result(ctx, out, r.validity, r.errors)


def _map_values(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    seg = r.values
    out = SegValue(seg.starts, seg.sizes, (seg.children[1],), expr.dtype)
    return _result(ctx, out, r.validity, r.errors)


def _map_constructor(ctx, expr: Call):
    ka = _seg_arg(ctx, expr.args[0])
    va = _seg_arg(ctx, expr.args[1])
    kn = ka.values.normalized()
    vn = va.values.normalized()
    mismatch = kn.sizes != vn.sizes
    row_validity = _and(ka.validity, va.validity)
    if row_validity is not None:
        mismatch = mismatch & row_validity
    errors = _or(_or(ka.errors, va.errors), mismatch)
    k_el, v_el = kn.children[0], vn.children[0]
    width = max(k_el.pool_cap, v_el.pool_cap)
    # align pool capacities by padding the smaller one
    k_el = _pad_elems(k_el, width)
    v_el = _pad_elems(v_el, width)
    out = SegValue(kn.starts, kn.sizes, (k_el, v_el), expr.dtype)
    return _result(ctx, out, row_validity, errors)


def _pad_elems(el: Elems, width: int) -> Elems:
    cur = el.pool_cap
    if cur >= width:
        return el
    pad = width - cur
    dev = el.values.device
    values = torch.cat([el.values, torch.zeros((pad,), dtype=el.values.dtype, device=dev)])
    validity = (
        None
        if el.validity is None
        else torch.cat([el.validity, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    )
    return Elems(values, validity, el.dtype, el.strings)


# ---------------------------------------------------------------------------
# higher-order (lambda) functions


def _pool_errors(errors, body, norm):
    """OR a lambda's per-element errors into its rows' errors."""
    if body.errors is None:
        return errors
    return _or(
        errors,
        segment_any(
            body.errors & norm.emask, norm.starts, norm.sizes, norm.rowid, norm.emask
        ),
    )


def _transform(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    lam: Lambda = expr.args[1]
    norm = r.values.normalized()
    elems = norm.children[0]
    body = _eval_lambda(ctx, lam, [elems], elems.pool_cap, norm.rowid)
    errors = _pool_errors(r.errors, body, norm)
    out = SegValue(
        norm.starts,
        norm.sizes,
        (Elems(body.values, body.validity, lam.dtype, _body_strings(ctx, lam)),),
        expr.dtype,
    )
    return _result(ctx, out, r.validity, errors)


def _body_strings(ctx, lam: Lambda):
    if not lam.dtype.is_string:
        return None
    from ...expr.compiler import _strings_of

    return _strings_of(lam.body, ctx.batch)


def _filter(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    lam: Lambda = expr.args[1]
    norm = r.values.normalized()
    elems = norm.children[0]
    body = _eval_lambda(ctx, lam, [elems], elems.pool_cap, norm.rowid)
    keep = body.values.to(torch.bool)
    if body.validity is not None:
        keep = keep & body.validity
    errors = _pool_errors(r.errors, body, norm)
    return _compacted(ctx, r, norm, elems, keep, expr.dtype, r.validity, errors)


def _match(kind: str):
    def fn(ctx, expr: Call):
        r = _seg_arg(ctx, expr.args[0])
        lam: Lambda = expr.args[1]
        norm = r.values.normalized()
        elems = norm.children[0]
        body = _eval_lambda(ctx, lam, [elems], elems.pool_cap, norm.rowid)
        v = body.values.to(torch.bool)
        valid = body.validity if body.validity is not None else torch.ones_like(v)
        args4 = (norm.starts, norm.sizes, norm.rowid, norm.emask)
        exists_true = segment_any(v & valid, *args4)
        exists_false = segment_any(~v & valid, *args4)
        has_null = segment_any(~valid & norm.emask, *args4)
        # Kleene over the element set: a deciding element wins; otherwise a
        # null lambda result makes the answer NULL
        if kind == "any":
            hit, decided = exists_true, exists_true
        elif kind == "all":
            hit, decided = ~exists_false, exists_false
        else:  # none
            hit, decided = ~exists_true, exists_true
        validity = decided | ~has_null
        validity = _and(validity, r.validity)
        errors = _pool_errors(r.errors, body, norm)
        return _result(ctx, hit, validity, errors)

    return fn


def _reduce(ctx, expr: Call):
    """reduce(array(T), S, (S, T) -> S, S -> R): a loop over element offsets,
    every row at once; the longest array (one device read) bounds it."""
    r = _seg_arg(ctx, expr.args[0])
    init = ctx.evaluate(expr.args[1])
    merge: Lambda = expr.args[2]
    final: Optional[Lambda] = expr.args[3] if len(expr.args) > 3 else None
    seg: SegValue = r.values
    elems = seg.children[0]
    cap = ctx.capacity
    starts = seg.starts.to(torch.int64)
    sizes = seg.sizes.to(torch.int64)
    max_size = int(sizes.max()) if cap else 0
    state_t = expr.args[1].dtype
    state = init.values
    state_valid = init.validity_or_true(cap)
    err = torch.zeros((cap,), dtype=torch.bool, device=ctx.device)
    evalid = elems.validity_or_true()
    for j in range(max_size):
        idx = (starts + j).clamp(0, elems.pool_cap - 1)
        ev = _take(elems.values, idx)
        e_val = _take(evalid, idx)
        active = j < sizes
        out = _eval_lambda(
            ctx,
            merge,
            [
                Elems(state, state_valid, state_t),
                Elems(ev, e_val, elems.dtype, elems.strings),
            ],
            cap,
            None,
        )
        state = torch.where(active, out.values.to(state.dtype), state)
        state_valid = torch.where(active, out.validity_or_true(cap), state_valid)
        if out.errors is not None:
            err = err | (out.errors & active)
    errors = _or(_or(r.errors, init.errors), err)
    if final is not None:
        out = _eval_lambda(
            ctx, final, [Elems(state, state_valid, state_t)], cap, None
        )
        state, state_valid = out.values, out.validity_or_true(cap)
        if out.errors is not None:
            errors = _or(errors, out.errors)
    validity = _and(state_valid, r.validity)
    return _result(ctx, state, validity, errors)


def _zip_with(ctx, expr: Call):
    ra = _seg_arg(ctx, expr.args[0])
    rb = _seg_arg(ctx, expr.args[1])
    lam: Lambda = expr.args[2]
    a: SegValue = ra.values
    b: SegValue = rb.values
    sa = a.sizes.to(torch.int64)
    sb = b.sizes.to(torch.int64)
    out_sizes = torch.maximum(sa, sb)
    out_starts = dense_starts(out_sizes)
    pool_cap = a.pool_cap + b.pool_cap
    total = out_starts[-1] + out_sizes[-1]
    rowid = owner_rows(out_starts, pool_cap)
    pos = _arange(pool_cap, ctx.device)
    emask = pos < total
    offset = pos - _take(out_starts, rowid)

    def pick(seg: SegValue, sz):
        st = _take(seg.starts.to(torch.int64), rowid)
        within = offset < _take(sz, rowid)
        idx = (st + offset).clamp(0, seg.pool_cap - 1)
        el = seg.children[0]
        v = _take(el.values, idx)
        valid = _take(el.validity_or_true(), idx) & within
        return Elems(v, valid, el.dtype, el.strings)

    ea = pick(a, sa)
    eb = pick(b, sb)
    body = _eval_lambda(ctx, lam, [ea, eb], pool_cap, rowid)
    errors = _or(ra.errors, rb.errors)
    if body.errors is not None:
        err_rows = segment_reduce(
            (body.errors & emask).to(torch.int64),
            out_starts,
            out_sizes,
            rowid,
            emask,
            "sum",
            init=0,
        )
        errors = _or(errors, err_rows > 0)
    out = SegValue(
        out_starts,
        out_sizes,
        (Elems(body.values, body.validity, lam.dtype, _body_strings(ctx, lam)),),
        expr.dtype,
    )
    return _result(ctx, out, _and(ra.validity, rb.validity), errors)


def _map_filter(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    lam: Lambda = expr.args[1]
    norm = r.values.normalized()
    keys, vals = norm.children
    body = _eval_lambda(ctx, lam, [keys, vals], keys.pool_cap, norm.rowid)
    keep = body.values.to(torch.bool)
    if body.validity is not None:
        keep = keep & body.validity
    pools = [keys.values, vals.values, keys.validity_or_true(), vals.validity_or_true()]
    starts, sizes, new_pools, _, _ = compact_pool(
        keep, norm.starts, norm.sizes, norm.rowid, norm.emask, tuple(pools)
    )
    errors = _pool_errors(r.errors, body, norm)
    out = SegValue(
        starts,
        sizes,
        (
            Elems(new_pools[0], new_pools[2], keys.dtype, keys.strings),
            Elems(new_pools[1], new_pools[3], vals.dtype, vals.strings),
        ),
        expr.dtype,
    )
    return _result(ctx, out, r.validity, errors)


def _transform_map(which: str):
    def fn(ctx, expr: Call):
        r = _seg_arg(ctx, expr.args[0])
        lam: Lambda = expr.args[1]
        norm = r.values.normalized()
        keys, vals = norm.children
        body = _eval_lambda(ctx, lam, [keys, vals], keys.pool_cap, norm.rowid)
        new_el = Elems(body.values, body.validity, lam.dtype, _body_strings(ctx, lam))
        children = (new_el, vals) if which == "keys" else (keys, new_el)
        errors = _pool_errors(r.errors, body, norm)
        out = SegValue(norm.starts, norm.sizes, children, expr.dtype)
        return _result(ctx, out, r.validity, errors)

    return fn


# ---------------------------------------------------------------------------
# dispatch table + type-resolution signatures

COMPLEX_FNS: Dict[str, Callable] = {
    "cardinality": _cardinality,
    "subscript": _subscript,
    "element_at": _element_at,
    "contains": _contains,
    "array_position": _array_position,
    "array_min": _array_minmax("min"),
    "array_max": _array_minmax("max"),
    "array_sum": _array_sum,
    "array_sort": _array_sort,
    "array_sort_desc": _array_sort_desc,
    "array_distinct": _array_distinct,
    "array_union": _array_union,
    "array_normalize": _array_normalize,
    "slice": _slice,
    "reverse": _reverse,
    "concat": _concat_arrays,
    "flatten": _flatten,
    "array_constructor": _array_constructor,
    "repeat": _repeat,
    "map_keys": _map_keys,
    "map_values": _map_values,
    "map": _map_constructor,
    "transform": _transform,
    "filter": _filter,
    "any_match": _match("any"),
    "all_match": _match("all"),
    "none_match": _match("none"),
    "reduce": _reduce,
    "zip_with": _zip_with,
    "map_filter": _map_filter,
    "map_zip_with": _map_zip_with,
    "transform_keys": _transform_map("keys"),
    "transform_values": _transform_map("values"),
    "array_intersect": _array_setop("intersect"),
    "array_except": _array_setop("except"),
    "arrays_overlap": _array_setop("overlap"),
    "map_concat": _map_concat,
    "cosine_similarity": _cosine_similarity,
    "array_join": _array_join_gate,
    "row": _row_constructor,
    "row_field": _row_field,
    "split": _split,
    "sequence": _sequence,
    # Spark package (velox/functions/sparksql): aliases + legacy size()
    "size": _spark_size,
    "array_contains": _contains,
    "sort_array": _array_sort,
    "array": _array_constructor,        # Spark's call-form constructor
    "aggregate": _reduce,               # Spark name for reduce()
    "map_from_arrays": _map_constructor,  # same shape as Presto map(k, v)
}


def is_complex_call(name: str, args) -> bool:
    if name not in COMPLEX_FNS:
        return False
    if name in ("array_constructor", "array", "row", "split", "sequence"):
        return True
    return any(a.dtype.is_complex or isinstance(a, Lambda) for a in args)


# ---- registry entries (type resolution only) ------------------------------

_A = TypeKind.ARRAY
_M = TypeKind.MAP


def _stub(*_a, **_k):  # pragma: no cover
    raise RuntimeError("complex functions are dispatched by the compiler")


def _elem_type(ts):
    return ts[0].element


def _value_type(ts):
    return ts[0].value_type


def _register_all():
    from ...dtypes import VARCHAR, row as row_t
    from ...expr.registry import STRINGY

    reg = DEFAULT_REGISTRY
    reg.register("cardinality", [_A], BIGINT, _stub)
    reg.register("cardinality", [_M], BIGINT, _stub)
    reg.register("subscript", [_A, INT_M], _elem_type, _stub)
    reg.register("subscript", [_M, ANY], _value_type, _stub)
    reg.register("element_at", [_A, INT_M], _elem_type, _stub)
    reg.register("element_at", [_M, ANY], _value_type, _stub)
    reg.register("contains", [_A, ANY], BOOLEAN, _stub)
    reg.register("array_position", [_A, ANY], BIGINT, _stub)
    reg.register("array_min", [_A], _elem_type, _stub)
    reg.register("array_max", [_A], _elem_type, _stub)
    reg.register(
        "array_sum",
        [_A],
        lambda ts: BIGINT if ts[0].element.is_integer else ts[0].element,
        _stub,
    )
    reg.register("array_sort", [_A], lambda ts: ts[0], _stub)
    reg.register("array_sort_desc", [_A], lambda ts: ts[0], _stub)
    reg.register("array_distinct", [_A], lambda ts: ts[0], _stub)
    reg.register("array_union", [_A, _A], lambda ts: ts[0], _stub)
    reg.register("array_normalize", [_A, NUMERIC], lambda ts: array_t(DOUBLE), _stub)
    reg.register("slice", [_A, INT_M, INT_M], lambda ts: ts[0], _stub)
    reg.register("reverse", [_A], lambda ts: ts[0], _stub)
    reg.register("concat", [_A, _A], lambda ts: ts[0], _stub, variadic=True)
    reg.register("flatten", [_A], lambda ts: ts[0].element, _stub)
    reg.register("repeat", [ANY, INT_M], lambda ts: array_t(ts[0]), _stub)
    reg.register("map_keys", [_M], lambda ts: array_t(ts[0].key_type), _stub)
    reg.register("map_values", [_M], lambda ts: array_t(ts[0].value_type), _stub)
    reg.register("map", [_A, _A], lambda ts: map_t(ts[0].element, ts[1].element), _stub)
    reg.register("cosine_similarity", [_M, _M], DOUBLE, _stub)
    reg.register("array_join", [_A, TypeKind.VARCHAR], VARCHAR, _stub)
    reg.register("array_join", [_A, TypeKind.VARCHAR, TypeKind.VARCHAR], VARCHAR, _stub)
    # lambda-taking functions: the lambda arg matches ANY (its dtype is the
    # body's result type)
    reg.register("transform", [_A, ANY], lambda ts: array_t(ts[1]), _stub)
    reg.register("filter", [_A, ANY], lambda ts: ts[0], _stub)
    reg.register("any_match", [_A, ANY], BOOLEAN, _stub)
    reg.register("all_match", [_A, ANY], BOOLEAN, _stub)
    reg.register("none_match", [_A, ANY], BOOLEAN, _stub)
    reg.register("reduce", [_A, ANY, ANY], lambda ts: ts[1], _stub)
    reg.register("reduce", [_A, ANY, ANY, ANY], lambda ts: ts[3], _stub)
    # Spark names (sparksql/Register.cpp): array(...), aggregate, map_from_arrays
    reg.register(
        "array", [ANY], lambda ts: array_t(ts[0] if ts else BIGINT), _stub,
        variadic=True,
    )
    reg.register("aggregate", [_A, ANY, ANY], lambda ts: ts[1], _stub)
    reg.register("aggregate", [_A, ANY, ANY, ANY], lambda ts: ts[3], _stub)
    reg.register(
        "map_from_arrays",
        [_A, _A],
        lambda ts: map_t(ts[0].element, ts[1].element),
        _stub,
    )
    reg.register("zip_with", [_A, _A, ANY], lambda ts: array_t(ts[2]), _stub)
    reg.register("map_filter", [_M, ANY], lambda ts: ts[0], _stub)
    reg.register(
        "map_zip_with", [_M, _M, ANY], lambda ts: map_t(ts[0].key_type, ts[2]), _stub
    )
    reg.register(
        "transform_keys", [_M, ANY], lambda ts: map_t(ts[1], ts[0].value_type), _stub
    )
    reg.register(
        "transform_values", [_M, ANY], lambda ts: map_t(ts[0].key_type, ts[1]), _stub
    )
    reg.register("array_intersect", [_A, _A], lambda ts: ts[0], _stub)
    reg.register("array_except", [_A, _A], lambda ts: ts[0], _stub)
    reg.register("arrays_overlap", [_A, _A], BOOLEAN, _stub)
    reg.register("map_concat", [_M, _M], lambda ts: ts[0], _stub, variadic=True)
    reg.register("split", [STRINGY, STRINGY], array_t(VARCHAR), _stub)
    reg.register("sequence", [INT_M, INT_M], lambda ts: array_t(ts[0]), _stub)
    reg.register(
        "row",
        [ANY],
        lambda ts: row_t([f"f{i}" for i in range(len(ts))], list(ts)),
        _stub,
        variadic=True,
    )
    # Spark package
    reg.register("size", [_A], BIGINT, _stub)
    reg.register("size", [_M], BIGINT, _stub)
    reg.register("array_contains", [_A, ANY], BOOLEAN, _stub)
    reg.register("sort_array", [_A], lambda ts: ts[0], _stub)


_register_all()
