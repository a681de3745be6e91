"""Bind-time rewrites that specialize expressions to a concrete table's metadata.

The engine keeps string bytes on the host (vector/string_table.py); device
VARCHAR columns are dictionary codes.  Before a pipeline is traced, expressions
are rewritten against the scan's string tables:

* VARCHAR literals inside comparisons / IN-lists are interned to int codes
  (a literal absent from the table becomes code -1, which matches no row);
* string functions (like / length / lower / upper / substr / trim / concat with
  a literal) are evaluated once per *distinct* dictionary entry on the host and
  become a single device gather (``DictLookup``) — the bind-time form of the
  reference's evaluate-on-dictionary-values peeling
  (velox/expression/PeeledEncoding.h; string-dictionary readers in dwio);
* except ``like`` with a pattern of literal text and ``%`` only (no ``_``, no
  ESCAPE): its per-entry results are a ``LikeTable``, which the executor
  works out on the device when it first evaluates the node
  (``ops/dict_like.py``), so binding does no work per entry.

This is valid because scan dictionaries are immutable for the life of a query.

``might_contain(X'...', x)`` with a literal Spark-serialized bloom filter
becomes a probe function specialised on the filter's words
(``utils/spark_bloom.py register_bloom_probe``); a NULL filter folds to a
NULL constant.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import numpy as np

from ..dtypes import BIGINT, BOOLEAN, TypeKind, VARCHAR
from ..vector.string_table import StringTable
from .ir import Call, Constant, DictLookup, Expr, FieldAccess, HostArray, LikeTable, Special


def like_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


def bind_string_literals(expr: Expr, tables: Dict[str, StringTable]) -> Expr:
    """Rewrite VARCHAR literals to codes and string functions to DictLookups."""
    return _rewrite(expr, tables, None)


def _uncast_const(e: Expr) -> Expr:
    """Strip a CAST wrapped around a literal (e.g. cast(null as varbinary))."""
    from .ir import Special, SpecialForm

    while (
        isinstance(e, Special)
        and e.form in (SpecialForm.CAST, SpecialForm.TRY_CAST)
        and len(e.args) == 1
    ):
        e = e.args[0]
    return e


def _find_table(expr: Expr, tables: Dict[str, StringTable]) -> Optional[StringTable]:
    if isinstance(expr, FieldAccess) and (
        expr.dtype.is_string or expr.dtype.is_complex
    ):
        return tables.get(expr.name)
    if isinstance(expr, DictLookup) and expr.strings is not None:
        return expr.strings
    for c in expr.children:
        t = _find_table(c, tables)
        if t is not None:
            return t
    return None


def _table_of(expr: Expr, tables) -> Optional[StringTable]:
    """The dictionary of a string-valued expression, if statically known."""
    if isinstance(expr, FieldAccess):
        return tables.get(expr.name)
    if isinstance(expr, DictLookup):
        return expr.strings
    return None


def _per_entry(table: StringTable, fn: Callable[[str], object], dtype, np_dtype):
    arr = np.asarray([fn(v) for v in table.values()], dtype=np_dtype)
    return HostArray(arr)


def _has_string_construction(e: Expr) -> bool:
    """Does this subtree construct a data-dependent string (cast-to-varchar
    over a non-string, bin, chr, array_join)?  Such expressions carry no
    dictionary; a later string-construction plan rewrite (not in this package yet) handles them."""
    from .ir import Special as _Sp
    from .ir import SpecialForm as _SF

    if (
        isinstance(e, _Sp)
        and e.form in (_SF.CAST, _SF.TRY_CAST)
        and e.dtype.is_string
        and e.args
        and not e.args[0].dtype.is_string
    ):
        return True
    if isinstance(e, Call) and e.name in ("bin", "chr", "array_join"):
        return True
    return any(
        _has_string_construction(c) for c in (getattr(e, "children", ()) or ())
    )


def _rewrite(expr: Expr, tables, context_table: Optional[StringTable]) -> Expr:
    if isinstance(expr, Constant):
        if expr.dtype.is_string and isinstance(expr.value, str):
            if context_table is None:
                raise ValueError(
                    f"string literal {expr.value!r} has no sibling string column "
                    "to bind against"
                )
            code = context_table.lookup(expr.value)
            return Constant(expr.dtype, -1 if code is None else code)
        return expr
    if (
        isinstance(expr, Call)
        and expr.name in _TZ_FNS
        and expr.args
        and isinstance(expr.args[-1], Constant)
        and isinstance(expr.args[-1].value, str)
    ):
        # literal zone dispatch (reference: DateTimeFunctions.h zone lookup):
        # the zone's TZif transition table bakes into a dedicated function
        from ..functions.presto.tzfuncs import register_zone_fn

        zone = expr.args[-1].value
        rest = tuple(_rewrite(a, tables, context_table) for a in expr.args[:-1])
        if expr.name == "from_unixtime":
            inner = Call(expr.dtype, "from_unixtime", rest)
            return Call(expr.dtype, register_zone_fn("at", zone), (inner,))
        return Call(expr.dtype, register_zone_fn(_TZ_FNS[expr.name], zone), rest)
    if (
        isinstance(expr, Call)
        and expr.name == "might_contain"
        and expr.args
        and isinstance(_uncast_const(expr.args[0]), Constant)
    ):
        # literal Spark-serialized bloom filter: specialise a device probe
        # closing over the deserialized words (utils/spark_bloom.py);
        # reference: velox/functions/sparksql/MightContain.h
        from ..utils.spark_bloom import register_bloom_probe

        data = _uncast_const(expr.args[0]).value
        if data is None:
            # a NULL filter argument gets default-null semantics (reference:
            # MightContainTest.nullBloomFilter expects NULL rows); only a
            # non-null but EMPTY filter probes as constant false
            # (MightContain.h isSet()?:false)
            return Constant(BOOLEAN, None)
        fn = register_bloom_probe(bytes(data))
        return Call(expr.dtype, fn, (_rewrite(expr.args[1], tables, context_table),))
    if isinstance(expr, Call) and expr.name == "array_join":
        # the separator / null-replacement literals must SURVIVE as strings:
        # the string-construction plan rewrite (not ported yet) renders the
        # joined value on the host at materialization and needs their text,
        # not a dictionary code
        return Call(
            expr.dtype,
            expr.name,
            (_rewrite(expr.args[0], tables, context_table),)
            + tuple(expr.args[1:]),
        )
    if (
        isinstance(expr, Call)
        and expr.name in _STRING_FN_BINDERS
        and expr.args
        and expr.args[0].dtype.is_string
    ):
        if any(
            _has_string_construction(a)
            for a in expr.args
            if not isinstance(a, Constant)
        ):
            # the string input is a data-dependent CONSTRUCTION (cast-to-
            # varchar / bin / chr / array_join): it has no dictionary to
            # bind against — the string-construction plan rewrite (not ported yet)
            # consumes the whole chain later, and needs literal arguments
            # as raw text, so they must not intern here
            return Call(
                expr.dtype,
                expr.name,
                tuple(
                    a
                    if isinstance(a, Constant)
                    else _rewrite(a, tables, context_table)
                    for a in expr.args
                ),
            )
        # names like reverse/concat/contains are shared with the array family;
        # the dictionary rewrites only apply to string-typed arguments
        non_lit = [
            a for a in expr.args
            if not isinstance(a, Constant) and a.dtype.is_string
        ]
        if len(non_lit) == 2 and expr.name in _PAIR_IMPLS:
            bound = _bind_pair(expr, tables, context_table)
            if bound is not None:
                return bound
        bound = _STRING_FN_BINDERS[expr.name](expr, tables, context_table)
        if bound is not None:
            return bound
    if isinstance(expr, Call) and expr.name == "row_field":
        # the second arg is a field NAME (metadata), never a data literal
        return Call(
            expr.dtype,
            expr.name,
            (_rewrite(expr.args[0], tables, context_table), expr.args[1]),
        )
    if isinstance(expr, Call) and expr.name == "split":
        # bind the parts dictionary now: it derives only from the input
        # dictionary + the literal delimiter, so downstream operators
        # (unnest -> group-by) can resolve the element strings statically
        from .ir import StringsCall

        child = _rewrite(expr.args[0], tables, context_table)
        delim = expr.args[1]
        out_table = None
        table = _table_of(child, tables) or _find_table(child, tables)
        if (
            table is not None
            and isinstance(delim, Constant)
            and isinstance(delim.value, str)
        ):
            out_table = StringTable()
            for v in table.values():
                for part in (v.split(delim.value) if v else []):
                    out_table.intern(part)
        return StringsCall(expr.dtype, expr.name, (child, delim), out_table)
    if isinstance(expr, (Call, Special)):
        local = _find_table(expr, tables) or context_table
        # two-phase: rewrite non-literal children first, then bind literals
        # against a rewritten sibling's DERIVED dictionary when one exists —
        # substr(col, 1, 2) = '13' must intern '13' into substr's table,
        # not the raw column's
        rewritten = {
            i: _rewrite(a, tables, local)
            for i, a in enumerate(expr.children)
            if not isinstance(a, Constant)
        }
        for r in rewritten.values():
            if isinstance(r, DictLookup) and r.strings is not None:
                local = r.strings
                break
        new_args = tuple(
            rewritten[i] if i in rewritten else _rewrite(a, tables, local)
            for i, a in enumerate(expr.children)
        )
        if isinstance(expr, Call):
            return Call(expr.dtype, expr.name, new_args)
        return Special(expr.dtype, expr.form, new_args)
    return expr


# ---- string-function binders ---------------------------------------------


def _bind_like(expr: Call, tables, ctx) -> Optional[Expr]:
    child = _rewrite(expr.args[0], tables, ctx)
    table = _table_of(child, tables)
    pattern_e = expr.args[1]
    if table is None or not isinstance(pattern_e, Constant) or not isinstance(
        pattern_e.value, str
    ):
        raise ValueError(
            "like() requires a dictionary-backed string input and a literal pattern"
        )
    escape = None
    if len(expr.args) > 2 and isinstance(expr.args[2], Constant):
        escape = expr.args[2].value
    if len(expr.args) == 2:
        from ..ops.dict_like import parse_like

        pattern = parse_like(pattern_e.value)
        if pattern is not None:
            return DictLookup(BOOLEAN, child, LikeTable(table, pattern))
    rx = re.compile(like_to_regex(pattern_e.value, escape))
    arr = _per_entry(table, lambda v: bool(rx.match(v)), BOOLEAN, np.bool_)
    return DictLookup(BOOLEAN, child, arr)


def _unary_string_fn(result_kind, np_dtype, fn, makes_strings=False):
    def binder(expr: Call, tables, ctx) -> Optional[Expr]:
        child = _rewrite(expr.args[0], tables, ctx)
        table = _table_of(child, tables)
        if table is None:
            raise ValueError(
                f"{expr.name}() requires a dictionary-backed string input"
            )
        if makes_strings:
            out_table = StringTable()
            codes = out_table.intern_all([fn(v) for v in table.values()])
            return DictLookup(
                VARCHAR, child, HostArray(codes.astype(np.int32)), out_table
            )
        arr = _per_entry(table, fn, result_kind, np_dtype)
        return DictLookup(result_kind, child, arr)

    return binder


def _bind_substr(expr: Call, tables, ctx) -> Optional[Expr]:
    child = _rewrite(expr.args[0], tables, ctx)
    table = _table_of(child, tables)
    args = expr.args[1:]
    if table is None or not all(isinstance(a, Constant) for a in args):
        raise ValueError("substr() requires literal start/length arguments")
    start = int(args[0].value)
    length = int(args[1].value) if len(args) > 1 else None

    def fn(v: str) -> str:
        # SQL 1-based indexing; negative start counts from the end.
        if start > 0:
            s = v[start - 1 :]
        elif start < 0:
            s = v[start:]
        else:
            s = v
        return s[:length] if length is not None else s

    out_table = StringTable()
    codes = out_table.intern_all([fn(v) for v in table.values()])
    return DictLookup(VARCHAR, child, HostArray(codes.astype(np.int32)), out_table)


def _literal_args_fn(result_kind, np_dtype, pyfn, makes_strings=False):
    """Bind fn(str_col, literal...) by evaluating once per dictionary entry.

    Exactly one argument may be a dictionary-backed string expression; the
    rest must be literals (passed through to ``pyfn`` after the value)."""

    def binder(expr: Call, tables, ctx) -> Optional[Expr]:
        col_idx = None
        for i, a in enumerate(expr.args):
            if not isinstance(a, Constant):
                if col_idx is not None:
                    raise ValueError(
                        f"{expr.name}(): at most one non-literal string argument"
                    )
                col_idx = i
        if col_idx is None:
            raise ValueError(f"{expr.name}(): needs a string column argument")
        child = _rewrite(expr.args[col_idx], tables, ctx)
        table = _table_of(child, tables)
        if table is None:
            raise ValueError(
                f"{expr.name}() requires a dictionary-backed string input"
            )
        lits = [
            a.value for i, a in enumerate(expr.args) if i != col_idx
        ]

        def fn(v):
            return pyfn(v, col_idx, *lits)

        if makes_strings:
            out_table = StringTable()
            codes = out_table.intern_all([fn(v) for v in table.values()])
            return DictLookup(
                VARCHAR, child, HostArray(codes.astype(np.int32)), out_table
            )
        arr = _per_entry(table, fn, result_kind, np_dtype)
        return DictLookup(result_kind, child, arr)

    return binder


def _concat_impl(v, col_idx, *lits):
    parts = list(lits)
    parts.insert(col_idx, v)
    return "".join(str(p) for p in parts)


def _regexp_extract_impl(v, _ci, pattern, group=0):
    m = re.search(pattern, v)
    if m is None:
        return ""
    return m.group(int(group))


def _bind_date_unit(prefix: str):
    """date_trunc('month', d) -> Call('date_trunc_month', (d,)): dispatch the
    literal unit at bind time (reference: DateTimeFunctions.h unit switches)."""

    def binder(expr: Call, tables, ctx) -> Optional[Expr]:
        unit_e = expr.args[0]
        if not isinstance(unit_e, Constant) or not isinstance(unit_e.value, str):
            raise ValueError(f"{expr.name}() requires a literal unit")
        unit = unit_e.value.lower().rstrip("s") or "day"
        rest = tuple(_rewrite(a, tables, ctx) for a in expr.args[1:])
        from ..expr.registry import DEFAULT_REGISTRY

        name = f"{prefix}_{unit}"
        sig, _, _ = DEFAULT_REGISTRY.resolve(name, [a.dtype for a in rest])
        return Call(expr.dtype, name, rest)

    return binder


# timezone functions: name -> tzfuncs kind ('from_unixtime' composes with 'at')
_TZ_FNS: Dict[str, Optional[str]] = {
    "at_timezone": "at",
    "to_utc": "to_utc",
    "timezone_hour": "hour",
    "timezone_minute": "minute",
    "from_unixtime": None,
}


def _levenshtein(a: str, b: str) -> int:
    """Edit distance (a copy of the JAX package's Spark ``_levenshtein``)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


_BOOLEAN = BOOLEAN

_STRING_FN_BINDERS: Dict[str, Callable] = {
    "like": _bind_like,
    "length": _unary_string_fn(BIGINT, np.int64, lambda v: len(v)),
    "lower": _unary_string_fn(None, None, lambda v: v.lower(), makes_strings=True),
    "upper": _unary_string_fn(None, None, lambda v: v.upper(), makes_strings=True),
    "trim": _unary_string_fn(None, None, lambda v: v.strip(), makes_strings=True),
    "ltrim": _unary_string_fn(None, None, lambda v: v.lstrip(), makes_strings=True),
    "rtrim": _unary_string_fn(None, None, lambda v: v.rstrip(), makes_strings=True),
    "reverse": _unary_string_fn(None, None, lambda v: v[::-1], makes_strings=True),
    "substr": _bind_substr,
    "substring": _bind_substr,
    "codepoint": _unary_string_fn(
        BIGINT, np.int64, lambda v: ord(v[0]) if v else 0
    ),
    "concat": _literal_args_fn(None, None, _concat_impl, makes_strings=True),
    "strpos": _literal_args_fn(
        BIGINT, np.int64, lambda v, _ci, sub: v.find(sub) + 1
    ),
    "levenshtein_distance": _literal_args_fn(
        BIGINT, np.int64, lambda v, _ci, other: _levenshtein(v, other)
    ),
    "strrpos": _literal_args_fn(
        BIGINT, np.int64, lambda v, _ci, sub: v.rfind(sub) + 1
    ),
    "starts_with": _literal_args_fn(
        BOOLEAN, np.bool_, lambda v, _ci, p: v.startswith(p)
    ),
    "ends_with": _literal_args_fn(
        BOOLEAN, np.bool_, lambda v, _ci, p: v.endswith(p)
    ),
    "replace": _literal_args_fn(
        None, None, lambda v, _ci, find, repl="": v.replace(find, repl),
        makes_strings=True,
    ),
    "lpad": _literal_args_fn(
        None, None,
        lambda v, _ci, n, fill=" ": v if len(v) >= n else (
            (fill * int(n))[: int(n) - len(v)] + v
        ),
        makes_strings=True,
    ),
    "rpad": _literal_args_fn(
        None, None,
        lambda v, _ci, n, fill=" ": v if len(v) >= n else (
            v + (fill * int(n))[: int(n) - len(v)]
        ),
        makes_strings=True,
    ),
    "split_part": _literal_args_fn(
        None, None,
        lambda v, _ci, delim, index: (
            v.split(delim)[int(index) - 1]
            if 0 < int(index) <= len(v.split(delim))
            else ""
        ),
        makes_strings=True,
    ),
    "regexp_like": _literal_args_fn(
        BOOLEAN, np.bool_, lambda v, _ci, p: re.search(p, v) is not None
    ),
    "regexp_extract": _literal_args_fn(
        None, None, _regexp_extract_impl, makes_strings=True
    ),
    "regexp_replace": _literal_args_fn(
        None, None,
        lambda v, _ci, p, repl="": re.sub(p, repl, v),
        makes_strings=True,
    ),
    "date_trunc": _bind_date_unit("date_trunc"),
    "date_diff": _bind_date_unit("date_diff"),
    "date_add": _bind_date_unit("date_add"),
}


# ---- two-column string functions -----------------------------------------
#
# Exactly two dictionary-backed columns: the lookup table covers the CROSS
# PRODUCT of both dictionaries (guarded by size), and the device index is
# c1 * |dict2| + c2 (ir.DictLookup pair form).  This is still the
# evaluate-per-distinct-value strategy — the distinct domain is just 2-D.

_PAIR_LIMIT = 1 << 22

_PAIR_IMPLS = {
    # name -> (fn(v1, v2) -> value, result kind|None, np dtype|None, makes_strings)
    "concat": (lambda a, b: a + b, None, None, True),
    "strrpos": (lambda a, b: a.rfind(b) + 1, BIGINT, np.int64, False),
    "hamming_distance": (None, BIGINT, np.int64, False),
    "levenshtein": (_levenshtein, BIGINT, np.int64, False),
    "levenshtein_distance": (_levenshtein, BIGINT, np.int64, False),
    "strpos": (lambda a, b: a.find(b) + 1, BIGINT, np.int64, False),
    "instr": (lambda a, b: a.find(b) + 1, BIGINT, np.int64, False),
    "starts_with": (lambda a, b: a.startswith(b), BOOLEAN, np.bool_, False),
    "ends_with": (lambda a, b: a.endswith(b), BOOLEAN, np.bool_, False),
}


def _bind_pair(expr: Call, tables, ctx) -> Optional[Expr]:
    fn, result_kind, np_dtype, makes_strings = _PAIR_IMPLS[expr.name]
    if fn is None:  # hamming
        fn = lambda a, b: (  # noqa: E731
            sum(x != y for x, y in zip(a, b)) if len(a) == len(b) else -1
        )
    a = _rewrite(expr.args[0], tables, ctx)
    b = _rewrite(expr.args[1], tables, ctx)
    t1, t2 = _table_of(a, tables), _table_of(b, tables)
    if t1 is None or t2 is None:
        return None
    if len(t1) * len(t2) > _PAIR_LIMIT:
        raise ValueError(
            f"{expr.name}(col, col): dictionary cross product "
            f"{len(t1)}x{len(t2)} exceeds the bind limit"
        )
    v2s = t2.values()
    if makes_strings:
        out_table = StringTable()
        codes = np.asarray(
            [out_table.intern(fn(v1, v2)) for v1 in t1.values() for v2 in v2s],
            np.int32,
        )
        return DictLookup(
            VARCHAR, a, HostArray(codes), out_table, child2=b, width=len(t2)
        )
    arr = np.asarray(
        [fn(v1, v2) for v1 in t1.values() for v2 in v2s], np_dtype
    )
    return DictLookup(
        result_kind, a, HostArray(arr), None, child2=b, width=len(t2)
    )


# ---- digest / codec families (reference: functions/prestosql/
# BinaryFunctions.h — md5/sha/hex/base64 over VARBINARY/VARCHAR) -------------


def _digest(alg):
    import hashlib

    def fn(v, _ci):
        return getattr(hashlib, alg)(v.encode("utf-8")).hexdigest()

    return fn


def _hamming(a, _ci, b):
    if len(a) != len(b):
        return -1  # Presto raises; -1 under try() semantics here
    return sum(x != y for x, y in zip(a, b))


_STRING_FN_BINDERS.update(
    {
        "md5": _literal_args_fn(None, None, _digest("md5"), makes_strings=True),
        "sha1": _literal_args_fn(None, None, _digest("sha1"), makes_strings=True),
        "sha256": _literal_args_fn(
            None, None, _digest("sha256"), makes_strings=True
        ),
        "sha512": _literal_args_fn(
            None, None, _digest("sha512"), makes_strings=True
        ),
        "to_hex": _literal_args_fn(
            None, None, lambda v, _ci: v.encode("utf-8").hex().upper(),
            makes_strings=True,
        ),
        "from_hex": _literal_args_fn(
            None, None,
            lambda v, _ci: bytes.fromhex(v).decode("utf-8", "replace") if v else "",
            makes_strings=True,
        ),
        "to_base64": _literal_args_fn(
            None, None,
            lambda v, _ci: __import__("base64").b64encode(
                v.encode("utf-8")
            ).decode(),
            makes_strings=True,
        ),
        "from_base64": _literal_args_fn(
            None, None,
            lambda v, _ci: __import__("base64").b64decode(v).decode(
                "utf-8", "replace"
            ) if v else "",
            makes_strings=True,
        ),
        "hamming_distance": _literal_args_fn(BIGINT, np.int64, _hamming),
    }
)


# ---- JSON / URL families (reference: functions/prestosql/JsonFunctions.h,
# URLFunctions.h — simdjson/folly there; host-per-distinct-value here) -------


def _json_scalar(v, _ci, path):
    import json as _json

    try:
        doc = _json.loads(v)
    except Exception:
        return ""
    for part in _parse_json_path(path):
        if isinstance(doc, dict):
            doc = doc.get(part)
        elif isinstance(doc, list):
            try:
                doc = doc[int(part)]
            except (ValueError, IndexError):
                return ""
        else:
            return ""
        if doc is None:
            return ""
    if isinstance(doc, (dict, list)):
        return ""  # json_extract_scalar returns NULL for non-scalars
    if isinstance(doc, bool):
        return "true" if doc else "false"
    return str(doc)


def _json_extract(v, _ci, path):
    import json as _json

    try:
        doc = _json.loads(v)
    except Exception:
        return ""
    for part in _parse_json_path(path):
        if isinstance(doc, dict):
            doc = doc.get(part)
        elif isinstance(doc, list):
            try:
                doc = doc[int(part)]
            except (ValueError, IndexError):
                return ""
        else:
            return ""
        if doc is None:
            return ""
    return _json.dumps(doc, separators=(",", ":"))


def _parse_json_path(path: str):
    """Subset of JSONPath: $.a.b[0].c — dots and bracket indices."""
    out = []
    for part in re.findall(r"\.([A-Za-z_][A-Za-z_0-9]*)|\[(\d+)\]", path):
        out.append(part[0] or part[1])
    return out


def _json_array_len(v, _ci):
    import json as _json

    try:
        doc = _json.loads(v)
    except Exception:
        return -1
    return len(doc) if isinstance(doc, list) else -1


def _url_part(which):
    def fn(v, _ci):
        from urllib.parse import urlparse

        try:
            u = urlparse(v)
        except Exception:
            return ""
        return getattr(u, which) or ""

    return fn


def _word_stem(v: str, _ci, lang: str = "en") -> str:
    if lang not in ("en",):
        raise ValueError(f"word_stem: unsupported language {lang!r}")
    from ..utils.porter import porter_stem

    return porter_stem(v)


def _normalize_str(v: str, _ci, form: str = "NFC") -> str:
    import unicodedata

    return unicodedata.normalize(form.upper(), v)


def _url_port(v: str) -> int:
    from urllib.parse import urlparse

    try:
        port = urlparse(v).port
    except Exception:
        return -1
    return -1 if port is None else int(port)


def _url_parameter(v: str, _ci, name: str) -> str:
    from urllib.parse import parse_qs, urlparse

    try:
        qs = parse_qs(urlparse(v).query, keep_blank_values=True)
    except Exception:
        return ""
    vals = qs.get(name)
    return vals[0] if vals else ""


def _json_canonical(v: str, _ci) -> str:
    import json as _json

    try:
        return _json.dumps(_json.loads(v), separators=(",", ":"))
    except Exception:
        return ""


def _json_size(v: str, _ci, path: str) -> int:
    import json as _json

    try:
        doc = _json.loads(v)
    except Exception:
        return -1
    for part in _parse_json_path(path):
        if isinstance(doc, dict):
            doc = doc.get(part)
        elif isinstance(doc, list):
            try:
                doc = doc[int(part)]
            except (ValueError, IndexError):
                return -1
        else:
            return -1
    if isinstance(doc, (dict, list)):
        return len(doc)
    return 0  # scalars have size 0 (Presto semantics)


def _bind_concat_ws(expr: Call, tables, ctx) -> Optional[Expr]:
    """concat_ws(sep, a, b, ...) -> nested pair concats with the literal
    separator folded in (reference: StringFunctions.h concat_ws)."""
    sep = expr.args[0]
    if not isinstance(sep, Constant) or not isinstance(sep.value, str):
        raise ValueError("concat_ws() requires a literal separator")
    rest = list(expr.args[1:])
    if not rest:
        raise ValueError("concat_ws() needs at least one value")
    out = rest[0]
    for nxt in rest[1:]:
        with_sep = Call(
            out.dtype, "concat", (out, Constant(VARCHAR, sep.value))
        )
        out = Call(out.dtype, "concat", (with_sep, nxt))
    return _rewrite(out, tables, ctx)


_STRING_FN_BINDERS.update(
    {
        "json_extract_scalar": _literal_args_fn(
            None, None, _json_scalar, makes_strings=True
        ),
        "json_extract": _literal_args_fn(
            None, None, _json_extract, makes_strings=True
        ),
        "json_array_length": _literal_args_fn(
            BIGINT, np.int64, _json_array_len
        ),
        "url_extract_host": _literal_args_fn(
            None, None, _url_part("hostname"), makes_strings=True
        ),
        "url_extract_path": _literal_args_fn(
            None, None, _url_part("path"), makes_strings=True
        ),
        "url_extract_query": _literal_args_fn(
            None, None, _url_part("query"), makes_strings=True
        ),
        "url_extract_protocol": _literal_args_fn(
            None, None, _url_part("scheme"), makes_strings=True
        ),
        "url_extract_fragment": _literal_args_fn(
            None, None, _url_part("fragment"), makes_strings=True
        ),
        "url_extract_port": _literal_args_fn(
            BIGINT, np.int64, lambda v, _ci: _url_port(v)
        ),
        "url_extract_parameter": _literal_args_fn(
            None, None, _url_parameter, makes_strings=True
        ),
        "url_encode": _literal_args_fn(
            None, None,
            lambda v, _ci: __import__("urllib.parse", fromlist=["quote_plus"])
            .quote_plus(v),
            makes_strings=True,
        ),
        "url_decode": _literal_args_fn(
            None, None,
            lambda v, _ci: __import__("urllib.parse", fromlist=["unquote_plus"])
            .unquote_plus(v),
            makes_strings=True,
        ),
        "json_parse": _literal_args_fn(
            None, None, _json_canonical, makes_strings=True
        ),
        "json_format": _literal_args_fn(
            None, None, _json_canonical, makes_strings=True
        ),
        "json_size": _literal_args_fn(BIGINT, np.int64, _json_size),
        "to_base64url": _literal_args_fn(
            None, None,
            lambda v, _ci: __import__("base64").urlsafe_b64encode(
                v.encode("utf-8")
            ).decode(),
            makes_strings=True,
        ),
        "from_base64url": _literal_args_fn(
            None, None,
            lambda v, _ci: __import__("base64").urlsafe_b64decode(v).decode(
                "utf-8", "replace"
            ) if v else "",
            makes_strings=True,
        ),
        "normalize": _literal_args_fn(
            None, None, _normalize_str, makes_strings=True
        ),
        "word_stem": _literal_args_fn(
            None, None, _word_stem, makes_strings=True
        ),
        # VARCHAR <-> VARBINARY casts share the dictionary representation
        # (reference: BinaryFunctions.h to_utf8 / from_utf8)
        "to_utf8": _unary_string_fn(None, None, lambda v: v, makes_strings=True),
        "from_utf8": _unary_string_fn(None, None, lambda v: v, makes_strings=True),
        "char2hexint": _unary_string_fn(
            None, None,
            lambda v: v.encode("utf-16-be").hex().upper(),
            makes_strings=True,
        ),
        "concat_ws": _bind_concat_ws,
    }
)
