"""Long-decimal (HUGEINT-backed) execution as a plan rewrite.

Counterpart of the JAX package's ``exec/hugeint.py`` (the same rewrite, over
this package's plan nodes and the torch ``__i128_*`` functions of
ops/int128.py).  Reference: velox/type/Type.h:665 (DECIMAL(p>18) backed by
int128 HUGEINT), DecimalUtil.h arithmetic, DecimalAggregate.h sums.

No 128-bit device type exists, so a long-decimal column is TWO int64 limb
columns (``c__hi``, ``c__lo``; value = hi*2^64 + uint64(lo)), and
long-decimal expressions lower onto the branch-free ``__i128_*`` device
functions as a plan rewrite that ``LocalExecutor`` applies when it is
constructed.  Everything downstream (tiling, joins, grouping) then sees
plain BIGINT columns.

Covered: scans/Values with long-decimal columns, filter/project expressions
(+, -, negation, full 128x128 multiply, exact round-half-away division,
comparisons, rescaling casts in both directions, narrowing casts to short
DECIMAL / BIGINT / DOUBLE), GROUP BY and equi-join on long-decimal keys,
ORDER BY/TopN, and sum/count/avg/min/max aggregation — sums accumulate in
four 32-bit pieces per value (each piece sum is exact in int64 for < 2^31
rows) and recombine into limbs on device.  Rescale overflow, narrow
overflow, long x long multiply overflow past 128 bits, and non-finite /
out-of-range floating-point casts all surface as per-row query errors
(the reference throws VeloxUserError via __int128 builtins /
DecimalUtil::rescaleDouble); try(...) nulls them per row instead.
Unsupported shapes raise NotImplementedError naming the construct.  Results
surface as (n, 2) [lo, hi] numpy columns; Table.to_pandas renders them as
exact ``decimal.Decimal`` objects.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..dtypes import BIGINT, BOOLEAN, DOUBLE, DataType, RowType
from ..expr.ir import Call, Constant, Expr, FieldAccess, Special, SpecialForm
from ..io.table import Table
from ..ops.int128 import np_from_int, register_i128_functions
from ..plan.nodes import (
    AggregationNode,
    FilterNode,
    PlanNode,
    ProjectNode,
    TableScanNode,
    ValuesNode,
)


def _hi(name: str) -> str:
    return f"{name}__hi"


def _lo(name: str) -> str:
    return f"{name}__lo"


def split_table(table: Table) -> Table:
    """Physical form of a table with long-decimal columns: each becomes two
    BIGINT limb columns (numpy views over the (n, 2) [lo, hi] storage)."""
    names, types, cols, validities = [], [], {}, {}
    for name, dtype in zip(table.schema.names, table.schema.types):
        if dtype.is_long_decimal:
            arr = np.asarray(table.columns[name])
            assert arr.ndim == 2 and arr.shape[1] == 2, (
                f"long-decimal column {name!r} must be (n, 2) [lo, hi] int64"
            )
            names += [_hi(name), _lo(name)]
            types += [BIGINT, BIGINT]
            cols[_hi(name)] = arr[:, 1]
            cols[_lo(name)] = arr[:, 0]
            v = table.validities.get(name)
            if v is not None:
                validities[_lo(name)] = v
                validities[_hi(name)] = v
        else:
            names.append(name)
            types.append(dtype)
            cols[name] = table.columns[name]
            if name in table.validities:
                validities[name] = table.validities[name]
    return Table(
        RowType(names, types), cols, dict(table.string_tables), validities
    )


def merge_result(table: Table, logical: RowType) -> Table:
    """Re-pack limb pairs in a result into (n, 2) long-decimal columns."""
    cols, validities = {}, {}
    for name, dtype in zip(logical.names, logical.types):
        if dtype.is_long_decimal:
            lo = np.asarray(table.columns[_lo(name)])
            hi = np.asarray(table.columns[_hi(name)])
            cols[name] = np.stack([lo, hi], axis=1)
            v = table.validities.get(_lo(name))
            if v is not None:
                validities[name] = v
        else:
            cols[name] = table.columns[name]
            if name in table.validities:
                validities[name] = table.validities[name]
    return Table(logical, cols, dict(table.string_tables), validities)


def _widen_const(e: Expr, target: DataType) -> Expr:
    """Rescale a short-decimal (or integer) literal to a long-decimal target
    — exact host-side python-int arithmetic."""
    from ..dtypes import TypeKind, decimal as _decimal

    if not isinstance(e, Constant) or e.dtype.is_long_decimal:
        return e
    if e.dtype.kind == TypeKind.DECIMAL:
        shift = target.scale - e.dtype.scale
    elif e.dtype.is_integer:
        shift = target.scale
    else:
        return e
    if shift < 0:
        return e
    return Constant(
        _decimal(38, target.scale), int(e.value) * 10**shift
    )


def _const_limbs(v: int) -> Tuple[Constant, Constant]:
    h, l = np_from_int([int(v)])
    return Constant(BIGINT, int(h[0])), Constant(BIGINT, int(l[0]))


class _Lowerer:
    """Expression lowering against a physical (limb-split) schema."""

    def __init__(self, schema: RowType):
        self.schema = schema

    def _mul_pow10(self, hi: Expr, lo: Expr, k: int) -> Tuple[Expr, Expr]:
        """(hi, lo) * 10**k, exact, with a per-row overflow error lane
        (reference: DecimalUtil rescale throws on overflow)."""
        if k == 0:
            return hi, lo
        if k > 38:
            raise NotImplementedError(
                f"decimal rescale by 10^{k} exceeds the 38-digit surface"
            )
        factor = 10**k
        fh, fl = _const_limbs(factor)
        th, tl = _const_limbs((2**127 - 1) // factor)
        out_lo = Call(BIGINT, "__i128_mul64_lo", (lo, fl))
        out_lo = Call(BIGINT, "__i128_guard_abs_le", (out_lo, hi, lo, th, tl))
        out_hi = Call(BIGINT, "__i128_mul_hi", (hi, lo, fh, fl))
        return out_hi, out_lo

    def _div_pair(
        self, nh: Expr, nl: Expr, dh: Expr, dl: Expr
    ) -> Tuple[Expr, Expr]:
        """Round-half-away 128/128 quotient limbs (err lane on divide-by-0)."""
        return (
            Call(BIGINT, "__i128_div_hi", (nh, nl, dh, dl)),
            Call(BIGINT, "__i128_div_lo", (nh, nl, dh, dl)),
        )

    def _rescale(
        self, hi: Expr, lo: Expr, shift: int
    ) -> Tuple[Expr, Expr]:
        """Scale a limb pair by 10**shift: up = exact guarded multiply,
        down = round-half-away divide (reference: rescaleWithRoundUp)."""
        if shift >= 0:
            return self._mul_pow10(hi, lo, shift)
        dh, dl = _const_limbs(10 ** (-shift))
        return self._div_pair(hi, lo, dh, dl)

    def pair(self, e: Expr) -> Tuple[Expr, Expr]:
        """(hi, lo) expressions of a long-decimal-typed node."""
        if isinstance(e, FieldAccess) and e.dtype.is_long_decimal:
            return (
                FieldAccess(BIGINT, _hi(e.name)),
                FieldAccess(BIGINT, _lo(e.name)),
            )
        if isinstance(e, Constant) and e.dtype.is_long_decimal:
            hi, lo = np_from_int([int(e.value)])
            return Constant(BIGINT, int(hi[0])), Constant(BIGINT, int(lo[0]))
        if isinstance(e, Call) and e.name in ("plus", "minus"):
            ea = _widen_const(e.args[0], e.dtype)
            eb = _widen_const(e.args[1], e.dtype)
            ah, al = self.pair(ea)
            bh, bl = self.pair(eb)
            if e.name == "minus":
                bh, bl = (
                    Call(BIGINT, "__i128_neg_hi", (bh, bl)),
                    Call(BIGINT, "__i128_neg_lo", (bl,)),
                )
            return (
                Call(BIGINT, "__i128_add_hi", (ah, al, bh, bl)),
                Call(BIGINT, "__i128_add_lo", (al, bl)),
            )
        if isinstance(e, Special) and e.form == SpecialForm.TRY:
            # TRY over a long-decimal expression: link the hi limb's error
            # lane into the lo limb (arg errors propagate through calls),
            # then TRY each limb — the row nulls consistently in BOTH limbs
            # (merge_result reads the packed column's validity from lo).
            ch, cl = self.pair(e.children[0])
            lo_linked = Call(BIGINT, "__i128_pair_lo", (cl, ch))
            return (
                Special(BIGINT, SpecialForm.TRY, (ch,)),
                Special(BIGINT, SpecialForm.TRY, (lo_linked,)),
            )
        if isinstance(e, Call) and e.name == "negate":
            ah, al = self.pair(e.args[0])
            return (
                Call(BIGINT, "__i128_neg_hi", (ah, al)),
                Call(BIGINT, "__i128_neg_lo", (al,)),
            )
        if (
            isinstance(e, Call)
            and e.name in ("multiply", "widening_multiply")
            and not e.args[0].dtype.is_long_decimal
            and not e.args[1].dtype.is_long_decimal
        ):
            # short x short widening product: exact 64x64 -> 128
            a = self.scalar(e.args[0])
            b = self.scalar(e.args[1])
            return (
                Call(BIGINT, "__i128_mul64_hi", (a, b)),
                Call(BIGINT, "__i128_mul64_lo", (a, b)),
            )
        if isinstance(e, Call) and e.name == "multiply" and (
            e.args[0].dtype.is_long_decimal or e.args[1].dtype.is_long_decimal
        ):
            # full 128x128 product (scales add, no alignment); overflow past
            # 128 bits raises a per-row error through the checked-hi kernel's
            # error lane (reference: DecimalUtil.h __builtin_mul_overflow)
            ah, al = self.pair(e.args[0])
            bh, bl = self.pair(e.args[1])
            return (
                Call(BIGINT, "__i128_mul_chk_hi", (ah, al, bh, bl)),
                Call(BIGINT, "__i128_mul64_lo", (al, bl)),
            )
        if isinstance(e, Call) and e.name == "divide":
            # exact decimal division: rescale the dividend by
            # 10^(rScale - s1 + s2), divide with round-half-away
            # (reference: DecimalUtil::divideWithRoundUp)
            from ..dtypes import TypeKind

            a, b = e.args
            s1 = a.dtype.scale if a.dtype.kind == TypeKind.DECIMAL else 0
            s2 = b.dtype.scale if b.dtype.kind == TypeKind.DECIMAL else 0
            k = e.dtype.scale + s2 - s1
            if k < 0:
                raise NotImplementedError(
                    "decimal division with negative rescale"
                )
            ah, al = self.pair(a)
            bh, bl = self.pair(b)
            nh, nl = self._mul_pow10(ah, al, k)
            return self._div_pair(nh, nl, bh, bl)
        if (
            isinstance(e, Special)
            and e.form in (SpecialForm.CAST, SpecialForm.TRY_CAST)
            and e.dtype.is_long_decimal
        ):
            child = e.children[0]
            if child.dtype.is_long_decimal:
                ch, cl = self.pair(child)
                return self._rescale(ch, cl, e.dtype.scale - child.dtype.scale)
            if child.dtype.is_floating:
                # round(x * 10^scale) half away from zero; non-finite inputs
                # and values past 128 bits raise per-row errors (reference:
                # DecimalUtil::rescaleDouble)
                scaled = Call(
                    DOUBLE,
                    "multiply",
                    (
                        self.scalar(child),
                        Constant(DOUBLE, float(10 ** e.dtype.scale)),
                    ),
                )
                return (
                    Call(BIGINT, "__i128_from_double_hi", (scaled,)),
                    Call(BIGINT, "__i128_from_double_lo", (scaled,)),
                )
            shift = (
                e.dtype.scale - child.dtype.scale
                if child.dtype.kind.name == "DECIMAL"
                else e.dtype.scale
            )
            x = self.scalar(child)
            return self._rescale(Call(BIGINT, "__i128_sar63", (x,)), x, shift)
        if not e.dtype.is_long_decimal and not e.dtype.is_floating:
            # short (int64-representable) value in a long context: exact
            # sign-extension widening (callers align scales first)
            x = self.scalar(e)
            return Call(BIGINT, "__i128_sar63", (x,)), x
        raise NotImplementedError(
            f"long-decimal expression {getattr(e, 'name', type(e).__name__)!r}"
            " is not supported yet (supported: field/literal, +, -, negate,"
            " short*short widening, comparisons, cast to double, sum/count)"
        )

    def scalar(self, e: Expr) -> Expr:
        """Lower a NON-long-decimal-typed expression (rewriting any
        long-decimal subtrees it contains)."""
        if isinstance(e, Call) and e.name in ("eq", "neq", "lt", "lte", "gt", "gte"):
            a, b = e.args
            if a.dtype.is_long_decimal or b.dtype.is_long_decimal:
                long_t = a.dtype if a.dtype.is_long_decimal else b.dtype
                a = _widen_const(a, long_t)
                b = _widen_const(b, long_t)
                if not (a.dtype.is_long_decimal and b.dtype.is_long_decimal):
                    raise NotImplementedError(
                        "comparisons mixing long and short decimals are not "
                        "supported yet (cast explicitly)"
                    )
                if a.dtype.scale != b.dtype.scale:
                    raise NotImplementedError(
                        "long-decimal comparisons require matching scales"
                    )
                ah, al = self.pair(a)
                bh, bl = self.pair(b)
                if e.name in ("gt", "gte"):
                    ah, al, bh, bl = bh, bl, ah, al
                name = {
                    "eq": "__i128_eq", "neq": "__i128_eq",
                    "lt": "__i128_lt", "lte": "__i128_lte",
                    "gt": "__i128_lt", "gte": "__i128_lte",
                }[e.name]
                out = Call(BOOLEAN, name, (ah, al, bh, bl))
                if e.name == "neq":
                    out = Call(BOOLEAN, "not", (out,))
                return out
        if isinstance(e, Special):
            if (
                e.form in (SpecialForm.CAST, SpecialForm.TRY_CAST)
                and e.children[0].dtype.is_long_decimal
                and not e.dtype.is_long_decimal
            ):
                return self._narrow_cast(e.children[0], e.dtype)
            if any(self._has_long(a) for a in e.children):
                args = tuple(self.scalar(a) for a in e.children)
                return Special(e.dtype, e.form, args)
            return e
        if isinstance(e, Call):
            if e.name == "cast" and e.args and e.args[0].dtype.is_long_decimal:
                return self._narrow_cast(e.args[0], e.dtype)
            if e.dtype.is_long_decimal:
                raise NotImplementedError(
                    f"long-decimal-valued call {e.name!r} in a scalar context"
                )
            if any(self._has_long(a) for a in e.args):
                return Call(e.dtype, e.name, tuple(self.scalar(a) for a in e.args))
            return e
        if e.dtype.is_long_decimal:
            raise NotImplementedError(
                f"long-decimal value {type(e).__name__} in a scalar context "
                "is not supported here"
            )
        return e

    def _narrow_cast(self, src: Expr, target: DataType) -> Expr:
        """Cast a long-decimal value to a narrower type: DOUBLE (scaled
        float), short DECIMAL (rescale + range-checked narrow), or an
        integer type (round to scale 0 + narrow).  Reference: CastExpr's
        decimal paths + DecimalUtil::rescaleWithRoundUp."""
        from ..dtypes import TypeKind

        hi, lo = self.pair(src)
        if target.kind == TypeKind.DOUBLE:
            dbl = Call(DOUBLE, "__i128_to_double", (hi, lo))
            return Call(
                DOUBLE, "divide",
                (dbl, Constant(DOUBLE, float(10 ** src.dtype.scale))),
            )
        if target.kind == TypeKind.DECIMAL:
            hi, lo = self._rescale(hi, lo, target.scale - src.dtype.scale)
            return Call(target, "__i128_narrow", (hi, lo))
        if target.kind == TypeKind.BIGINT:
            hi, lo = self._rescale(hi, lo, -src.dtype.scale)
            return Call(target, "__i128_narrow", (hi, lo))
        raise NotImplementedError(
            f"long-decimal cast to {target!r} is not supported yet "
            "(supported: DOUBLE, short DECIMAL, BIGINT)"
        )

    @staticmethod
    def _has_long(e: Expr) -> bool:
        if e.dtype.is_long_decimal:
            return True
        return any(_Lowerer._has_long(c) for c in e.children)


def _schema_has_long(schema: RowType) -> bool:
    return any(t.is_long_decimal for t in schema.types)


def rewrite_long_decimals(root: PlanNode):
    """Lower long-decimal columns/expressions bottom-up.

    Returns (new_root, logical_output | None): when the rewritten plan's
    output carries limb pairs, ``logical_output`` is the RowType the executor
    re-packs the result into (merge_result)."""
    if not _plan_has_long(root):
        return root, None
    register_i128_functions()
    new_root = _rewrite(root)
    logical = root.output_schema
    needs_merge = any(t.is_long_decimal for t in logical.types)
    return new_root, (logical if needs_merge else None)


def _plan_has_long(node: PlanNode) -> bool:
    if _schema_has_long(node.output_schema):
        return True
    return any(_plan_has_long(s) for s in node.sources)


def _rewrite(node: PlanNode) -> PlanNode:
    kids = {}
    for attr in ("source", "left", "right"):
        child = getattr(node, attr, None)
        if isinstance(child, PlanNode):
            kids[attr] = _rewrite(child)
    inputs = getattr(node, "inputs", None)
    if inputs and all(isinstance(i, PlanNode) for i in inputs):
        kids["inputs"] = tuple(_rewrite(i) for i in inputs)

    if isinstance(node, (TableScanNode, ValuesNode)):
        if not _schema_has_long(node.output_schema):
            return node
        phys = split_table(
            node.table.select(list(node.output_schema.names))
        )
        if isinstance(node, TableScanNode):
            if node.subfield_filter is not None:
                lw = _Lowerer(phys.schema)
                new = TableScanNode(phys, tuple(phys.schema.names))
                new.subfield_filter = lw.scalar(node.subfield_filter)
                return new
            return TableScanNode(phys, tuple(phys.schema.names))
        return ValuesNode(phys, id=node.id)

    src = kids.get("source")
    if src is None and not kids:
        return node

    if isinstance(node, FilterNode):
        if not _expr_long(node.predicate):
            return dataclasses.replace(node, **kids)
        lw = _Lowerer(src.output_schema)
        return FilterNode(src, lw.scalar(node.predicate))

    if isinstance(node, ProjectNode):
        if not any(_expr_long(e) for e in node.exprs) and not _schema_has_long(
            node.output_schema
        ):
            return dataclasses.replace(node, **kids)
        lw = _Lowerer(src.output_schema)
        names: List[str] = []
        exprs: List[Expr] = []
        for name, e in zip(node.names, node.exprs):
            if e.dtype.is_long_decimal:
                hi, lo = lw.pair(e)
                names += [_hi(name), _lo(name)]
                exprs += [hi, lo]
            else:
                names.append(name)
                exprs.append(lw.scalar(e))
        return ProjectNode(src, tuple(names), tuple(exprs))

    if isinstance(node, AggregationNode):
        has_long_key = any(
            node.source.output_schema.type_of(k).is_long_decimal
            for k in node.grouping_keys
        )
        has_long_agg = any(
            any(_expr_long(a) for a in call.args) for call in node.aggregates
        )
        if not has_long_key and not has_long_agg:
            return dataclasses.replace(node, **kids)
        return _rewrite_aggregation(node, src)

    from ..plan.nodes import HashJoinNode, OrderByNode, SortKey, TopNNode

    if isinstance(node, (OrderByNode, TopNNode)) and any(
        node.source.output_schema.type_of(k.name).is_long_decimal
        for k in node.keys
        if k.name in node.source.output_schema
    ):
        # ORDER BY a long decimal: sort by (hi, lo-as-unsigned) — the lo limb
        # compares unsigned, so a projected XOR with the sign bit makes it
        # int64-orderable; the helper column drops after the sort
        src = kids.get("source", node.source)
        names = list(src.output_schema.names)
        pre_names = list(names)
        pre_exprs: List[Expr] = [
            FieldAccess(src.output_schema.type_of(n), n) for n in names
        ]
        keys2: List[SortKey] = []
        for k in node.keys:
            t = node.source.output_schema.type_of(k.name) if (
                k.name in node.source.output_schema
            ) else None
            if t is not None and t.is_long_decimal:
                ordn = f"{k.name}__ord"
                pre_names.append(ordn)
                pre_exprs.append(
                    Call(
                        BIGINT,
                        "bitwise_xor",
                        (
                            FieldAccess(BIGINT, _lo(k.name)),
                            Constant(BIGINT, -(2**63)),
                        ),
                    )
                )
                keys2.append(
                    SortKey(_hi(k.name), k.ascending, k.nulls_first)
                )
                keys2.append(SortKey(ordn, k.ascending, k.nulls_first))
            else:
                keys2.append(k)
        pre = ProjectNode(src, tuple(pre_names), tuple(pre_exprs))
        sorted_node = dataclasses.replace(node, source=pre, keys=tuple(keys2))
        return ProjectNode(
            sorted_node,
            tuple(names),
            tuple(
                FieldAccess(pre.output_schema.type_of(n), n) for n in names
            ),
        )

    if isinstance(node, HashJoinNode) and (
        _schema_has_long(node.left.output_schema)
        or _schema_has_long(node.right.output_schema)
    ):
        # long-decimal equi-join keys expand to their limb pairs: equality
        # of (hi, lo) pairs IS equality of the 128-bit values (sign play in
        # lo is irrelevant for equi comparison); payload columns expand too
        if node.filter is not None and _expr_long(node.filter):
            raise NotImplementedError(
                "join filters over long decimals are not supported yet"
            )

        def expand_keys(keys, schema):
            out = []
            for k in keys:
                if schema.type_of(k).is_long_decimal:
                    out += [_hi(k), _lo(k)]
                else:
                    out.append(k)
            return tuple(out)

        ls, rs = node.left.output_schema, node.right.output_schema
        outputs = []
        for c in node.output_columns:
            t = ls.type_of(c) if c in ls else rs.type_of(c)
            if t.is_long_decimal:
                outputs += [_hi(c), _lo(c)]
            else:
                outputs.append(c)
        return dataclasses.replace(
            node,
            left=kids.get("left", node.left),
            right=kids.get("right", node.right),
            left_keys=expand_keys(node.left_keys, ls),
            right_keys=expand_keys(node.right_keys, rs),
            output_columns=tuple(outputs),
        )

    if any(
        _schema_has_long(getattr(node, a).output_schema)
        if isinstance(getattr(node, a, None), PlanNode)
        else False
        for a in ("source", "left", "right")
    ) or _schema_has_long(node.output_schema):
        raise NotImplementedError(
            f"long-decimal columns flowing through {type(node).__name__} are "
            "not supported yet (supported: scan/filter/project/aggregation)"
        )
    return dataclasses.replace(node, **kids) if kids else node


def _expr_long(e: Expr) -> bool:
    return _Lowerer._has_long(e)


def _rewrite_aggregation(node: AggregationNode, src: PlanNode) -> PlanNode:
    """sum/count/avg over long decimals; long-decimal GROUP BY keys become
    limb-pair keys (exact: equal values have equal limb pairs)."""
    lw = _Lowerer(src.output_schema)
    schema = src.output_schema

    keys: List[str] = []
    key_logical: List[Tuple[str, DataType]] = []
    for k in node.grouping_keys:
        t = node.source.output_schema.type_of(k)
        if t.is_long_decimal:
            keys += [_hi(k), _lo(k)]
            key_logical.append((k, t))
        else:
            keys.append(k)

    # pre-projection: 32-bit pieces of each long argument
    pre_names = list(schema.names)
    pre_exprs: List[Expr] = [
        FieldAccess(schema.type_of(n), n) for n in schema.names
    ]
    agg_names: List[str] = []
    agg_calls: List[Call] = []
    post: List[Tuple[str, DataType, List[str]]] = []  # (name, dtype, piece sums)
    minmax: Dict[str, Tuple[str, str, Constant]] = {}
    for out_name, call in zip(node.agg_names, node.aggregates):
        if not any(_expr_long(a) for a in call.args):
            agg_names.append(out_name)
            agg_calls.append(call)
            continue
        if call.name not in ("sum", "count", "avg", "min", "max"):
            raise NotImplementedError(
                f"aggregate {call.name!r} over long decimals is not supported"
                " yet (supported: sum, count, avg, min, max)"
            )
        arg = call.args[0]
        if call.name in ("min", "max"):
            # exact lexicographic (hi, lo) extreme through the pair-combining
            # min_by/max_by machinery: the hi limb is the ordering, the lo
            # limb rides as the payload ENCODED so the machinery's min-payload
            # tie-break realizes the unsigned lo extreme (min: lo^MIN_I64 is
            # the unsigned order; max: additionally complemented)
            hi, lo = lw.pair(arg)
            enc = Constant(
                BIGINT, -(2**63) if call.name == "min" else 2**63 - 1
            )
            hnm, lnm = f"__hg_{out_name}_h", f"__hg_{out_name}_l"
            pre_names += [hnm, lnm]
            pre_exprs += [hi, Call(BIGINT, "bitwise_xor", (lo, enc))]
            agg_names += [f"{hnm}_m", f"{lnm}_m"]
            agg_calls.append(
                Call(BIGINT, call.name, (FieldAccess(BIGINT, hnm),))
            )
            agg_calls.append(
                Call(
                    BIGINT,
                    "min_by" if call.name == "min" else "max_by",
                    (FieldAccess(BIGINT, lnm), FieldAccess(BIGINT, hnm)),
                )
            )
            minmax[out_name] = (f"{hnm}_m", f"{lnm}_m", enc)
            continue
        if call.name == "count":
            # count only needs validity: the lo limb carries it
            _, lo = lw.pair(arg)
            nm = f"__hg_{out_name}_c"
            pre_names.append(nm)
            pre_exprs.append(lo)
            agg_names.append(out_name)
            agg_calls.append(
                Call(call.dtype, "count", (FieldAccess(BIGINT, nm),))
            )
            continue
        hi, lo = lw.pair(arg)
        pieces = []
        for i, piece in enumerate(
            (
                Call(BIGINT, "__i128_p0", (lo,)),
                Call(BIGINT, "__i128_p1u", (lo,)),
                Call(BIGINT, "__i128_p0", (hi,)),
                Call(BIGINT, "__i128_sar32", (hi,)),
            )
        ):
            nm = f"__hg_{out_name}_{i}"
            pre_names.append(nm)
            pre_exprs.append(piece)
            pieces.append(nm)
        sums = []
        for nm in pieces:
            snm = f"{nm}_s"
            agg_names.append(snm)
            agg_calls.append(Call(BIGINT, "sum", (FieldAccess(BIGINT, nm),)))
            sums.append(snm)
        if call.name == "avg":
            cnm = f"__hg_{out_name}_n"
            agg_names.append(cnm)
            agg_calls.append(
                Call(BIGINT, "count", (FieldAccess(BIGINT, pieces[0]),))
            )
            sums.append(cnm)
        post.append((out_name, call.dtype, sums))

    pre = ProjectNode(src, tuple(pre_names), tuple(pre_exprs))
    agg = AggregationNode(
        pre, node.step, tuple(keys), tuple(agg_names), tuple(agg_calls)
    )

    # post-projection: recombine piece sums into limbs on device
    out_names: List[str] = []
    out_exprs: List[Expr] = []
    for k in node.grouping_keys:
        t = node.source.output_schema.type_of(k)
        if t.is_long_decimal:
            for nm in (_hi(k), _lo(k)):
                out_names.append(nm)
                out_exprs.append(FieldAccess(BIGINT, nm))
        else:
            out_names.append(k)
            out_exprs.append(FieldAccess(agg.output_schema.type_of(k), k))
    recombine = {name: sums for name, _, sums in post}
    for out_name, call in zip(node.agg_names, node.aggregates):
        if out_name in minmax:
            hnm, lnm, enc = minmax[out_name]
            out_names += [_hi(out_name), _lo(out_name)]
            out_exprs += [
                FieldAccess(BIGINT, hnm),
                Call(BIGINT, "bitwise_xor", (FieldAccess(BIGINT, lnm), enc)),
            ]
            continue
        if out_name not in recombine:
            out_names.append(out_name)
            out_exprs.append(
                FieldAccess(agg.output_schema.type_of(out_name), out_name)
            )
            continue
        sums = recombine[out_name]
        s = [FieldAccess(BIGINT, nm) for nm in sums[:4]]
        # value = s0 + (s1 << 32) + (s2 << 64) + (s3 << 96), assembled with
        # exact 128-bit adds: pieces are non-negative (s3 sign-carrying)
        zero = Constant(BIGINT, 0)
        a_h, a_l = Call(BIGINT, "__i128_sar63", (s[0],)), s[0]
        b_h, b_l = (
            Call(BIGINT, "__i128_sar32", (s[1],)),
            Call(BIGINT, "__i128_shl32", (s[1],)),
        )
        c_h, c_l = s[2], zero
        d_h, d_l = Call(BIGINT, "__i128_shl32", (s[3],)), zero
        h1 = Call(BIGINT, "__i128_add_hi", (a_h, a_l, b_h, b_l))
        l1 = Call(BIGINT, "__i128_add_lo", (a_l, b_l))
        h2 = Call(BIGINT, "__i128_add_hi", (c_h, c_l, d_h, d_l))
        l2 = Call(BIGINT, "__i128_add_lo", (c_l, d_l))
        hi_e = Call(BIGINT, "__i128_add_hi", (h1, l1, h2, l2))
        lo_e = Call(BIGINT, "__i128_add_lo", (l1, l2))
        call_t = call.dtype
        if call.name == "avg":
            n_e = FieldAccess(BIGINT, sums[4])
            dbl = Call(DOUBLE, "__i128_to_double", (hi_e, lo_e))
            scale = float(10 ** call.args[0].dtype.scale)
            out_names.append(out_name)
            out_exprs.append(
                Call(
                    DOUBLE, "divide",
                    (
                        Call(
                            DOUBLE, "divide",
                            (dbl, Call(DOUBLE, "__i128_cast_double", (n_e,))),
                        ),
                        Constant(DOUBLE, scale),
                    ),
                )
            )
            continue
        out_names += [_hi(out_name), _lo(out_name)]
        out_exprs += [hi_e, lo_e]
    return ProjectNode(agg, tuple(out_names), tuple(out_exprs))
