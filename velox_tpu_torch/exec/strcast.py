"""Data-dependent string CONSTRUCTION as a plan rewrite.

Counterpart of the JAX package's ``exec/strcast.py``.  Reference: velox/expression/CastExpr.cpp (numeric -> VARCHAR casts via
folly::to / DecimalUtil::toString), velox/functions/sparksql/Bin.h (bin),
velox/functions/prestosql/StringFunctions.cpp (chr),
velox/functions/prestosql/ArrayFunctions (array_join).

Device strings are int32 dictionary codes whose tables are known before a
tile is evaluated, so a string whose VALUE depends on device data cannot
exist on the device.  But the engine rarely needs it to: a constructed string is
(a) carried to the output, (b) compared for equality, or (c) used as a
grouping/DISTINCT key — and for injective renderings all three are answered
by the UNDERLYING VALUE.  So construction lowers as a plan rewrite (the same
strategy as exec/hugeint.py and exec/sketch.py): the physical plan carries
the source value under the output name; grouping keys stay numeric (the
rendering is injective, so numeric equality IS string equality); and the
render to actual strings happens ONCE, on the host, at result
materialization — O(result rows), not O(input rows).

Uses that genuinely need the string VALUE on device raise
NotImplementedError naming the construct: ORDER BY a constructed string
whose lexicographic order is not computed on the device (doubles, dates,
decimals, array_join, chained functions; integer and boolean casts and chr
sort by ``__strlex_w*`` words or by value), joining it against a scanned string
column (dictionary codes and raw values don't compare), feeding it to
another string function, or non-count aggregates over it.  array_join is
additionally non-injective ("a,b" from ["a","b"] or ["a,b"]), so it renders
at the output only — never as a key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..dtypes import DataType, RowType, TypeKind, VARCHAR
from ..expr.ir import Call, Expr, FieldAccess, Special, SpecialForm
from ..io.table import Table
from ..plan.nodes import (
    AggregationNode,
    AssignUniqueIdNode,
    EnforceSingleRowNode,
    ExchangeNode,
    FilterNode,
    GroupIdNode,
    HashJoinNode,
    LimitNode,
    LocalPartitionNode,
    MergeExchangeNode,
    OrderByNode,
    PartitionedOutputNode,
    PlanNode,
    ProjectNode,
    TableScanNode,
    TopNNode,
    UnionAllNode,
    UnnestNode,
    ValuesNode,
)
from ..vector.string_table import StringTable


@dataclasses.dataclass(frozen=True)
class RenderSpec:
    """How to turn a physical column back into its constructed string."""

    kind: str  # 'cast' | 'bin' | 'chr' | 'array_join'
    src_type: DataType  # the physical column's type
    sep: Optional[str] = None  # array_join only
    null_repl: Optional[str] = None  # array_join only
    # CHAINED string functions applied host-side after the base render, in
    # order: each entry is (fn name, args template) where the template is
    # the literal argument tuple with None at the string-value position —
    # e.g. upper(cast(x as varchar)) -> post=(("upper", (None,)),);
    # concat('a', cast(x as varchar), '!') -> (("concat", ("a", None, "!")),)
    post: Tuple = ()

    @property
    def injective(self) -> bool:
        # distinct inputs always render to distinct strings for the scalar
        # kinds; array_join is lossy about element boundaries, and chained
        # functions (substr/replace/...) are treated as lossy conservatively
        return self.kind != "array_join" and not self.post


def _substr_chain(v: str, start, length=None) -> str:
    # SQL 1-based indexing; negative start counts from the end (mirrors
    # expr/binding._bind_substr; semantic parity enforced by
    # tests/test_strcast.py::test_chain_matches_plain_string_fn)
    start = int(start)
    if start > 0:
        s = v[start - 1 :]
    elif start < 0:
        s = v[start:]
    else:
        s = v
    return s[: int(length)] if length is not None else s


def _pad_chain(left: bool):
    def fn(v: str, n, fill=" ") -> str:
        n = int(n)
        if len(v) >= n:
            return v
        pad = (str(fill) * n)[: n - len(v)]
        return pad + v if left else v + pad

    return fn


# Host implementations of string->string functions chainable over a
# constructed string (same semantics as the dictionary binders in
# expr/binding._STRING_FN_BINDERS; parity is test-enforced).  Each callable
# takes (rendered value, *literal args) — the value slot's position inside
# the original call is recorded in the args template.
_HOST_CHAIN_FNS: Dict[str, object] = {
    "upper": lambda v: v.upper(),
    "lower": lambda v: v.lower(),
    "trim": lambda v: v.strip(),
    "ltrim": lambda v: v.lstrip(),
    "rtrim": lambda v: v.rstrip(),
    "reverse": lambda v: v[::-1],
    "substr": _substr_chain,
    "substring": _substr_chain,
    "lpad": _pad_chain(True),
    "rpad": _pad_chain(False),
    "replace": lambda v, find, repl="": v.replace(str(find), str(repl)),
    "split_part": lambda v, delim, index: (
        v.split(str(delim))[int(index) - 1]
        if 0 < int(index) <= len(v.split(str(delim)))
        else ""
    ),
    "concat": None,  # positional: handled by the args template directly
}


def _apply_chain(spec: "RenderSpec", strings: List[str]) -> List[str]:
    """Apply the spec's chained functions to base-rendered strings."""
    for fn_name, template in spec.post:
        if fn_name == "concat":
            strings = [
                "".join(v if a is None else str(a) for a in template)
                for v in strings
            ]
            continue
        fn = _HOST_CHAIN_FNS[fn_name]
        lits = [a for a in template if a is not None]
        strings = [fn(v, *lits) for v in strings]
    return strings


def _unsupported(use: str):
    raise NotImplementedError(
        f"a constructed string (cast-to-varchar / bin / chr / array_join) "
        f"is used {use}; only output projection, equality, grouping and "
        "DISTINCT keys are supported for data-dependent strings"
    )


_RENDERABLE = (
    TypeKind.BOOLEAN,
    TypeKind.TINYINT,
    TypeKind.SMALLINT,
    TypeKind.INTEGER,
    TypeKind.BIGINT,
    TypeKind.REAL,
    TypeKind.DOUBLE,
    TypeKind.DATE,
    TypeKind.TIMESTAMP,
    TypeKind.DECIMAL,
)


def _match_construction(e: Expr) -> Optional[Tuple[Expr, RenderSpec]]:
    """Return (underlying value expr, spec) when ``e`` is a string
    construction this rewrite handles, else None."""
    if isinstance(e, Special) and e.form == SpecialForm.TRY and len(e.args) == 1:
        # the renderable constructions cannot error per-row, but the
        # ARGUMENT can (try(cast(a/b as varchar)) must null the row on
        # division by zero, not raise), so the
        # TRY must stay wrapped around the underlying value expression
        inner = _match_construction(e.args[0])
        if inner is not None:
            under, spec = inner
            return Special(under.dtype, SpecialForm.TRY, (under,)), spec
        return None
    if (
        isinstance(e, Special)
        and e.form in (SpecialForm.CAST, SpecialForm.TRY_CAST)
        and e.dtype.kind == TypeKind.VARCHAR
    ):
        child = e.args[0]
        if child.dtype.kind in _RENDERABLE and not child.dtype.is_long_decimal:
            return child, RenderSpec("cast", child.dtype)
        return None
    if isinstance(e, Call) and e.name == "bin" and len(e.args) == 1:
        child = e.args[0]
        if child.dtype.is_integer:
            return child, RenderSpec("bin", child.dtype)
    if isinstance(e, Call) and e.name == "chr" and len(e.args) == 1:
        child = e.args[0]
        if child.dtype.is_integer:
            return child, RenderSpec("chr", child.dtype)
    if isinstance(e, Call) and e.name == "array_join" and len(e.args) in (2, 3):
        from ..expr.ir import Constant

        arr, sep = e.args[0], e.args[1]
        null_repl = e.args[2] if len(e.args) == 3 else None
        if (
            arr.dtype.kind == TypeKind.ARRAY
            and isinstance(sep, Constant)
            and isinstance(sep.value, str)
            and (null_repl is None or isinstance(null_repl, Constant))
        ):
            elem = arr.dtype.element
            if elem.kind == TypeKind.VARCHAR or (
                elem.kind in _RENDERABLE and not elem.is_long_decimal
            ):
                return arr, RenderSpec(
                    "array_join",
                    arr.dtype,
                    sep=sep.value,
                    null_repl=(
                        None if null_repl is None else null_repl.value
                    ),
                )
    return None


_LEX_REGISTERED = False


def _register_lex_functions() -> None:
    """Device functions __strlex_w{0,1,2}(x): bytes 8w..8w+7 of the decimal
    rendering of an integer, packed BIG-endian into one int64 — so int64
    ascending order of (w0, w1, w2) IS the byte-lexicographic order of the
    rendered string.  Positions past the string's end pack as 0 (sorts
    before any character, so "1" < "10" like Presto's VARCHAR order).

    This is what lets ORDER BY cast(int as varchar) run ON DEVICE: the sort
    uses the lex words while the string itself still renders host-side at
    materialization (the strcast contract)."""
    global _LEX_REGISTERED
    if _LEX_REGISTERED:
        return
    _LEX_REGISTERED = True
    import torch

    from ..dtypes import BIGINT
    from ..expr.registry import DEFAULT_REGISTRY, NUMERIC

    def _word(w):
        def impl(ctx, out_t, arg_ts, x):
            xi = x.to(torch.int64)
            neg = xi < 0
            # -|x| is never past int64's range (INT64_MIN included), so the
            # digits come from truncating division of a non-positive value
            m = torch.where(neg, xi, -xi)
            ndig = torch.ones_like(xi)
            for e in range(1, 19):
                ndig = ndig + (m <= -(10**e)).to(torch.int64)
            length = ndig + neg.to(torch.int64)
            pow10 = torch.tensor([10**k for k in range(19)], dtype=torch.int64, device=x.device)
            word = torch.zeros_like(xi)
            for j in range(8 * w, 8 * w + 8):
                e = ndig - 1 - (j - neg.to(torch.int64))
                q = torch.div(m, pow10[e.clamp(0, 18)], rounding_mode="trunc")
                digit = 48 - torch.fmod(q, 10)
                c = torch.where(neg & (j == 0), 45, digit)  # '-'
                c = torch.where(j < length, c, 0)
                word = (word << 8) | c
            return word

        return impl

    for w in range(3):
        DEFAULT_REGISTRY.register(f"__strlex_w{w}", [NUMERIC], BIGINT, _word(w))


def _lex_sortable(spec: RenderSpec) -> Optional[str]:
    """Can ORDER BY this constructed string run on device?  Returns
    'words' (project decimal lex words), 'value' (underlying numeric order
    == string order: chr is codepoint order under UTF-8, booleans render
    "false" < "true"), or None (still gated: doubles/dates/decimals/
    array_join/chained specs)."""
    if spec.post:
        return None
    if spec.kind == "chr":
        return "value"
    if spec.kind == "cast":
        k = spec.src_type.kind
        if k == TypeKind.BOOLEAN:
            return "value"
        if k in (
            TypeKind.TINYINT,
            TypeKind.SMALLINT,
            TypeKind.INTEGER,
            TypeKind.BIGINT,
        ):
            return "words"
    return None


def _match_chain(e: Expr, child_specs: Dict[str, RenderSpec]):
    """Match a chain of host-applicable string functions whose string input
    is a constructed column / construction / another chain: returns
    (underlying physical expr, RenderSpec with the call appended to post),
    else None.  Non-concat functions need the string value in argument 0;
    concat accepts it at any position.  All other arguments must be
    literals."""
    from ..expr.ir import Constant

    if not isinstance(e, Call) or e.name not in _HOST_CHAIN_FNS:
        return None
    if e.dtype.kind != TypeKind.VARCHAR:
        return None
    val_idx = None
    template: List[Optional[object]] = []
    for i, a in enumerate(e.args):
        if isinstance(a, Constant):
            template.append(a.value)
            continue
        if val_idx is not None:
            return None  # two non-literal args
        val_idx = i
        template.append(None)
    if val_idx is None:
        return None
    if e.name != "concat" and val_idx != 0:
        return None  # value must be the operand string for non-concat fns
    arg = e.args[val_idx]
    # resolve the string input: an already-rewritten constructed column,
    # a direct construction, or a nested chain
    if isinstance(arg, FieldAccess) and arg.name in child_specs:
        base_spec = child_specs[arg.name]
        under: Expr = FieldAccess(base_spec.src_type, arg.name)
    else:
        m = _match_construction(arg) or _match_chain(arg, child_specs)
        if m is None:
            return None
        under, base_spec = m
    if base_spec.kind == "array_join":
        # rendering happens per-row for array_join too; chains compose
        pass
    return under, dataclasses.replace(
        base_spec, post=base_spec.post + ((e.name, tuple(template)),)
    )


def _refs(e: Expr, names) -> bool:
    """Does ``e`` reference any of ``names`` (a set) via FieldAccess?"""
    if isinstance(e, FieldAccess):
        return e.name in names
    for c in getattr(e, "children", ()) or ():
        if _refs(c, names):
            return True
    return False


def rewrite_string_construction(root: PlanNode):
    """Returns (new_root, specs | None).  ``specs`` maps output column name
    -> RenderSpec for columns the executor must render at materialization."""
    if not _plan_has_construction(root):
        return root, None
    new_root, specs = _rw(root)
    return new_root, (specs or None)


def _expr_has_construction(e: Expr) -> bool:
    if _match_construction(e) is not None:
        return True
    return any(
        _expr_has_construction(c) for c in (getattr(e, "children", ()) or ())
    )


def _node_exprs(node: PlanNode):
    if isinstance(node, ProjectNode):
        return node.exprs
    if isinstance(node, FilterNode):
        return (node.predicate,)
    if isinstance(node, AggregationNode):
        return node.aggregates
    if isinstance(node, HashJoinNode) and node.filter is not None:
        return (node.filter,)
    return ()


def _plan_has_construction(node: PlanNode) -> bool:
    if any(_expr_has_construction(e) for e in _node_exprs(node)):
        return True
    return any(_plan_has_construction(s) for s in node.sources)


def _retype(e: Expr, cspecs: Dict[str, RenderSpec]) -> Expr:
    """Fix FieldAccess dtypes for columns whose physical type changed."""
    if isinstance(e, FieldAccess) and e.name in cspecs:
        return FieldAccess(cspecs[e.name].src_type, e.name)
    return e


def _rw(node: PlanNode) -> Tuple[PlanNode, Dict[str, RenderSpec]]:
    # rewrite children first
    kids: Dict[str, PlanNode] = {}
    child_specs: Dict[str, RenderSpec] = {}
    for attr in ("source", "left", "right"):
        child = getattr(node, attr, None)
        if isinstance(child, PlanNode):
            new_child, specs = _rw(child)
            kids[attr] = new_child
            child_specs.update(specs)
    inputs = getattr(node, "inputs", None)
    if inputs and all(isinstance(i, PlanNode) for i in inputs):
        rewritten = []
        for i in inputs:
            ni, specs = _rw(i)
            rewritten.append(ni)
            if specs:
                _unsupported("under a UNION (branch renders could disagree)")
        kids["inputs"] = tuple(rewritten)

    if isinstance(node, (TableScanNode, ValuesNode)):
        return node, {}

    cs = set(child_specs)

    if isinstance(node, ProjectNode):
        names: List[str] = []
        exprs: List[Expr] = []
        out_specs: Dict[str, RenderSpec] = {}
        src = kids["source"]
        for name, e in zip(node.names, node.exprs):
            m = _match_construction(e)
            if m is not None:
                under, spec = m
                if _refs(under, cs) or _expr_has_construction(under):
                    _unsupported("inside another string construction")
                names.append(name)
                exprs.append(under)
                out_specs[name] = spec
                continue
            if isinstance(e, FieldAccess) and e.name in child_specs:
                names.append(name)
                exprs.append(_retype(e, child_specs))
                out_specs[name] = child_specs[e.name]
                continue
            ch = _match_chain(e, child_specs)
            if ch is not None:
                # a string function chained over a constructed string: the
                # physical plan carries the underlying value; the chain
                # applies host-side after the base render (render_result)
                under, spec = ch
                names.append(name)
                exprs.append(under)
                out_specs[name] = spec
                continue
            if _refs(e, cs):
                _unsupported("inside another expression")
            if _expr_has_construction(e):
                _unsupported(
                    "nested inside an expression (only a top-level projected "
                    "construction is supported)"
                )
            names.append(name)
            exprs.append(e)
        return ProjectNode(src, tuple(names), tuple(exprs)), out_specs

    if isinstance(node, FilterNode):
        if _refs(node.predicate, cs):
            _unsupported("in a filter predicate")
        if _expr_has_construction(node.predicate):
            _unsupported("in a filter predicate")
        return dataclasses.replace(node, **kids), child_specs

    if isinstance(node, AggregationNode):
        out_specs = {}
        for k in node.grouping_keys:
            if k in child_specs:
                if not child_specs[k].injective:
                    _unsupported(
                        "as a grouping key (array_join is not injective)"
                    )
                out_specs[k] = child_specs[k]
        for name, call in zip(node.agg_names, node.aggregates):
            if any(_expr_has_construction(a) for a in call.args):
                _unsupported("inside an aggregate argument")
            if any(_refs(a, cs) for a in call.args):
                if call.name in ("count", "count_if"):
                    continue  # count only reads validity
                if call.name == "arbitrary":
                    argn = call.args[0]
                    if isinstance(argn, FieldAccess):
                        out_specs[name] = child_specs[argn.name]
                        continue
                _unsupported(f"as an argument of aggregate {call.name}()")
        # rebuild so the agg binds against the physical (numeric) key types
        new = AggregationNode(
            kids["source"],
            node.step,
            node.grouping_keys,
            node.agg_names,
            tuple(
                dataclasses.replace(
                    c, args=tuple(_retype(a, child_specs) for a in c.args)
                )
                for c in node.aggregates
            ),
        )
        return new, out_specs

    if isinstance(node, (OrderByNode, TopNNode)):
        from ..plan.nodes import SortKey

        hit = [k for k in node.keys if k.name in cs]
        if not hit:
            return dataclasses.replace(node, **kids), child_specs
        modes = {k.name: _lex_sortable(child_specs[k.name]) for k in hit}
        if any(m is None for m in modes.values()):
            _unsupported(
                "as a sort key (lexicographic device order is implemented "
                "for integer/boolean casts and chr; doubles/dates/decimals/"
                "array_join/chained strings still gate)"
            )
        _register_lex_functions()
        src = kids["source"]
        sschema = src.output_schema
        base_names = list(sschema.names)
        pass_exprs: List[Expr] = [
            FieldAccess(t, n)
            for n, t in zip(sschema.names, sschema.types)
        ]
        add_names: List[str] = []
        add_exprs: List[Expr] = []
        new_keys: List = []
        from ..dtypes import BIGINT as _BI

        for k in node.keys:
            if k.name not in cs:
                new_keys.append(k)
                continue
            if modes[k.name] == "value":
                # underlying numeric order == rendered-string order
                new_keys.append(k)
                continue
            under_t = child_specs[k.name].src_type
            for w in range(3):
                nm = f"__strlex_{k.name}_{w}"
                add_names.append(nm)
                add_exprs.append(
                    Call(_BI, f"__strlex_w{w}", (FieldAccess(under_t, k.name),))
                )
                new_keys.append(
                    SortKey(nm, k.ascending, k.nulls_first)
                )
        pre = ProjectNode(
            src,
            tuple(base_names + add_names),
            tuple(pass_exprs + add_exprs),
        )
        sorted_node = dataclasses.replace(
            node, source=pre, keys=tuple(new_keys)
        )
        post = ProjectNode(
            sorted_node,
            tuple(base_names),
            tuple(
                FieldAccess(t, n)
                for n, t in zip(sschema.names, sschema.types)
            ),
        )
        return post, child_specs

    if isinstance(node, MergeExchangeNode):
        for k in getattr(node, "keys", ()):
            if k.name in cs:
                _unsupported(
                    "as a merge-exchange sort key (sort the underlying "
                    "value explicitly instead)"
                )
        return dataclasses.replace(node, **kids), child_specs

    if isinstance(node, HashJoinNode):
        if any(k in cs for k in node.left_keys) or any(
            k in cs for k in node.right_keys
        ):
            _unsupported(
                "as a join key (the other side's dictionary codes don't "
                "compare with raw values)"
            )
        if node.filter is not None and _refs(node.filter, cs):
            _unsupported("in a join filter")
        out = {
            n: s for n, s in child_specs.items() if n in node.output_columns
        }
        return dataclasses.replace(node, **kids), out

    if isinstance(node, UnnestNode):
        if any(c in cs for c in node.unnest):
            _unsupported("as an unnest input")
        return dataclasses.replace(node, **kids), child_specs

    if isinstance(node, GroupIdNode):
        for s in child_specs.values():
            if not s.injective:
                _unsupported("as a grouping-set key")
        return dataclasses.replace(node, **kids), child_specs

    from .window import WindowNode

    if isinstance(node, WindowNode):
        if any(k.name in cs for k in node.order_keys):
            _unsupported("as a window order key")
        if any((c.arg or "") in cs for c in node.calls):
            _unsupported("as a window function argument")
        for k in node.partition_keys:
            if k in child_specs and not child_specs[k].injective:
                _unsupported("as a window partition key")
        return dataclasses.replace(node, **kids), child_specs

    if isinstance(
        node,
        (
            LimitNode,
            EnforceSingleRowNode,
            LocalPartitionNode,
            PartitionedOutputNode,
            ExchangeNode,
            AssignUniqueIdNode,
            UnionAllNode,
        ),
    ):
        return dataclasses.replace(node, **kids), child_specs

    if child_specs:
        _unsupported(f"under a {type(node).__name__}")
    return (dataclasses.replace(node, **kids) if kids else node), child_specs


# ---------------------------------------------------------------------------
# Host rendering at result materialization


def _render_scalar(spec: RenderSpec, values: np.ndarray) -> List[str]:
    t = spec.src_type
    if spec.kind == "bin":
        return [format(int(v) & ((1 << 64) - 1), "b") for v in values]
    if spec.kind == "chr":
        return [chr(int(v)) for v in values]
    k = t.kind
    if k == TypeKind.BOOLEAN:
        return ["true" if v else "false" for v in values]
    if t.is_integer and k != TypeKind.DECIMAL:
        return [str(int(v)) for v in values]
    if k in (TypeKind.REAL, TypeKind.DOUBLE):
        # shortest round-trip (numpy dragon4), Java-style specials; exponent
        # spelling follows numpy ("1e+20"), a documented deviation from
        # folly's formatting of the same value
        out = []
        for v in values:
            if np.isnan(v):
                out.append("NaN")
            elif np.isinf(v):
                out.append("Infinity" if v > 0 else "-Infinity")
            else:
                out.append(str(v))
        return out
    if k == TypeKind.DATE:
        base = np.datetime64("1970-01-01", "D")
        return [str(base + np.timedelta64(int(v), "D")) for v in values]
    if k == TypeKind.TIMESTAMP:
        # Presto cast(timestamp as varchar): 'YYYY-MM-DD HH:MM:SS.mmm'
        base = np.datetime64("1970-01-01T00:00:00", "us")
        out = []
        for v in values:
            s = str(base + np.timedelta64(int(v), "us"))  # ...THH:MM:SS[.ffffff]
            date, time = s.split("T")
            if "." in time:
                hms, frac = time.split(".")
                time = f"{hms}.{frac[:3].ljust(3, '0')}"
            else:
                time = f"{time}.000"
            out.append(f"{date} {time}")
        return out
    if k == TypeKind.DECIMAL:
        s = t.scale
        out = []
        for v in values:
            v = int(v)
            sign = "-" if v < 0 else ""
            a = abs(v)
            if s == 0:
                out.append(f"{sign}{a}")
            else:
                out.append(f"{sign}{a // 10**s}.{a % 10**s:0{s}d}")
        return out
    raise NotImplementedError(f"no varchar rendering for {t}")


def _render_array_join(spec: RenderSpec, col, validity) -> Tuple[
    List[Optional[str]], np.ndarray
]:
    """array_join over the host ARRAY column; returns (strings, validity)."""
    rows = col.to_pylist(validity)
    elem = spec.src_type.element
    out: List[Optional[str]] = []
    valid = np.ones(len(rows), dtype=bool)
    for r in rows:
        if r is None:
            out.append("")
            valid[len(out) - 1] = False
            continue
        parts = []
        for v in r:
            if v is None:
                if spec.null_repl is not None:
                    parts.append(str(spec.null_repl))
                continue  # Presto skips NULL elements without a replacement
            if elem.kind == TypeKind.VARCHAR:
                parts.append(v)
            else:
                parts.append(_render_scalar(RenderSpec("cast", elem), np.asarray([v]))[0])
        out.append(spec.sep.join(parts))
    return out, valid


def render_result(result: Table, specs: Dict[str, RenderSpec]) -> Table:
    """Render constructed-string columns into dictionary codes + tables."""
    names = list(result.schema.names)
    types = list(result.schema.types)
    cols = dict(result.columns)
    tables = dict(result.string_tables)
    validities = dict(result.validities)
    for name, spec in specs.items():
        if name not in cols:
            continue
        validity = validities.get(name)
        if spec.kind == "array_join":
            strings, valid = _render_array_join(spec, cols[name], validity)
            if spec.post:
                live2 = np.asarray(valid, dtype=bool)
                chained = _apply_chain(
                    spec, [s for s, ok in zip(strings, live2) if ok]
                )
                it = iter(chained)
                strings = [
                    next(it) if ok else s for s, ok in zip(strings, live2)
                ]
            if validity is None and not valid.all():
                validities[name] = valid
        else:
            values = np.asarray(cols[name])
            if validity is not None:
                # render ONLY live lanes: an invalid lane can carry garbage
                # that crashes the renderer (chr past 0x10FFFF raises even
                # though the row is NULL)
                live = np.asarray(validity, dtype=bool)
                strings = [""] * len(values)
                if live.any():
                    rendered = _apply_chain(
                        spec, _render_scalar(spec, values[live])
                    )
                    for i, s in zip(np.nonzero(live)[0], rendered):
                        strings[i] = s
            else:
                strings = _apply_chain(spec, _render_scalar(spec, values))
        uniq, inverse = np.unique(np.asarray(strings, dtype=object), return_inverse=True)
        table = StringTable()
        code_of = np.asarray([table.intern(u) for u in uniq], dtype=np.int32)
        cols[name] = code_of[inverse.reshape(-1)].astype(np.int32)
        tables[name] = table
        types[names.index(name)] = VARCHAR
    return Table(RowType(names, types), cols, tables, validities)
