"""SQL-expression-string -> typed IR parser.

Reference: velox/parse/ExpressionsParser.h:37 (parseExpr) + parse/TypeResolver.h.
The reference borrows DuckDB's postgres parser for tests/tutorials; this is a small
self-contained Pratt parser covering the expression grammar the engine and its
tests need (arithmetic, comparisons, BETWEEN/IN/IS NULL/LIKE, AND/OR/NOT, CASE,
CAST/TRY_CAST/TRY, function calls, typed literals incl. DATE and INTERVAL ... DAY).

Literal typing follows Presto: bare integers -> BIGINT, exact numerics with a
decimal point -> DECIMAL(p, s) carrying the unscaled value, scientific notation ->
DOUBLE, 'quoted' -> VARCHAR, DATE 'yyyy-mm-dd' -> DATE (days since epoch).
"""

from __future__ import annotations

import datetime
import re
from typing import List, Optional, Sequence

from ..dtypes import (
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    REAL,
    RowType,
    SMALLINT,
    TIMESTAMP,
    TINYINT,
    DataType,
    TypeKind,
    VARBINARY,
    VARCHAR,
    decimal,
)
from .ir import (
    Constant,
    Expr,
    FieldAccess,
    Special,
    SpecialForm,
    and_,
    cast,
    if_,
    in_,
    or_,
    try_,
)
from .registry import DEFAULT_REGISTRY, FunctionRegistry, make_call

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
      (?P<number>\d+\.\d+(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)
    | (?P<name>[A-Za-z_][A-Za-z_0-9.]*)
    | (?P<string>'(?:[^']|'')*')
    | (?P<op><>|!=|>=|<=|->|=|<|>|\|\||[+\-*/%(),\[\]])
    )""",
    re.VERBOSE,
)

_KEYWORDS = {
    "and", "or", "not", "between", "in", "is", "null", "like", "case", "when",
    "then", "else", "end", "cast", "try_cast", "try", "as", "true", "false",
    "date", "timestamp", "interval", "day", "distinct",
}

_TYPE_NAMES = {
    "boolean": BOOLEAN,
    "tinyint": TINYINT,
    "smallint": SMALLINT,
    "integer": INTEGER,
    "int": INTEGER,
    "bigint": BIGINT,
    "real": REAL,
    "float": REAL,
    "double": DOUBLE,
    "varchar": VARCHAR,
    "varbinary": VARBINARY,
    "date": DATE,
    "timestamp": TIMESTAMP,
}


def parse_date(text: str) -> int:
    d = datetime.date.fromisoformat(text)
    return (d - datetime.date(1970, 1, 1)).days


class _Token:
    __slots__ = ("kind", "text")

    def __init__(self, kind: str, text: str):
        self.kind = kind
        self.text = text

    def __repr__(self):  # pragma: no cover
        return f"{self.kind}:{self.text}"


def _tokenize(s: str) -> List[_Token]:
    out: List[_Token] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"cannot tokenize {s[pos:]!r}")
        pos = m.end()
        if m.lastgroup == "name":
            text = m.group("name")
            low = text.lower()
            if low in _KEYWORDS:
                out.append(_Token(low, low))
            else:
                out.append(_Token("name", text))
        elif m.lastgroup == "number":
            out.append(_Token("number", m.group("number")))
        elif m.lastgroup == "string":
            out.append(_Token("string", m.group("string")[1:-1].replace("''", "'")))
        else:
            out.append(_Token("op", m.group("op")))
    out.append(_Token("eof", ""))
    return out


_CMP = {"=": "eq", "<>": "neq", "!=": "neq", "<": "lt", "<=": "lte", ">": "gt", ">=": "gte"}


class _IntervalDays(Constant):
    """Marker literal produced by INTERVAL 'n' DAY, consumed by date +/-."""


class ExprParser:
    def __init__(self, schema: RowType, registry: FunctionRegistry = None):
        self.schema = schema
        self.registry = registry or DEFAULT_REGISTRY
        self.tokens: List[_Token] = []
        self.pos = 0
        # lambda parameters in scope (name -> DataType), innermost wins
        self.locals: dict = {}

    # ---- plumbing -----------------------------------------------------
    def _peek(self) -> _Token:
        return self.tokens[self.pos]

    def _next(self) -> _Token:
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def _accept(self, kind: str, text: Optional[str] = None) -> Optional[_Token]:
        t = self._peek()
        if t.kind == kind and (text is None or t.text == text):
            return self._next()
        return None

    def _expect(self, kind: str, text: Optional[str] = None) -> _Token:
        t = self._accept(kind, text)
        if t is None:
            raise ValueError(f"expected {text or kind}, got {self._peek()!r}")
        return t

    # ---- entry --------------------------------------------------------
    def parse(self, text: str) -> Expr:
        self.tokens = _tokenize(text)
        self.pos = 0
        e = self._parse_or()
        if self._peek().kind != "eof":
            raise ValueError(f"trailing tokens at {self._peek()!r} in {text!r}")
        return e

    # ---- precedence climb ---------------------------------------------
    def _parse_or(self) -> Expr:
        left = self._parse_and()
        while self._accept("or"):
            left = or_(left, self._parse_and())
        return left

    def _parse_and(self) -> Expr:
        left = self._parse_not()
        while self._accept("and"):
            left = and_(left, self._parse_not())
        return left

    def _parse_not(self) -> Expr:
        if self._accept("not"):
            child = self._parse_not()
            return make_call("not", [child], self.registry)
        return self._parse_comparison()

    def _parse_comparison(self) -> Expr:
        left = self._parse_additive()
        while True:
            t = self._peek()
            if t.kind == "op" and t.text in _CMP:
                self._next()
                right = self._parse_additive()
                left = make_call(_CMP[t.text], [left, right], self.registry)
            elif t.kind == "between":
                self._next()
                lo = self._parse_additive()
                self._expect("and")
                hi = self._parse_additive()
                left = make_call("between", [left, lo, hi], self.registry)
            elif t.kind == "in":
                self._next()
                self._expect("op", "(")
                options = [self._parse_or()]
                while self._accept("op", ","):
                    options.append(self._parse_or())
                self._expect("op", ")")
                left = in_(left, options)
            elif t.kind == "is":
                self._next()
                negate = bool(self._accept("not"))
                if self._accept("distinct"):
                    self._expect("name", "from")
                    right = self._parse_additive()
                    left = make_call(
                        "is_distinct_from", [left, right], self.registry
                    )
                    if negate:
                        left = make_call("not", [left], self.registry)
                else:
                    self._expect("null")
                    left = make_call(
                        "is_not_null" if negate else "is_null",
                        [left],
                        self.registry,
                    )
            elif t.kind == "not" and self.tokens[self.pos + 1].kind in ("between", "in", "like"):
                self._next()
                inner = self._parse_comparison_tail(left)
                left = make_call("not", [inner], self.registry)
            elif t.kind == "like":
                self._next()
                pattern = self._parse_additive()
                left = make_call("like", [left, pattern], self.registry)
            else:
                return left

    def _parse_comparison_tail(self, left: Expr) -> Expr:
        t = self._next()
        if t.kind == "between":
            lo = self._parse_additive()
            self._expect("and")
            hi = self._parse_additive()
            return make_call("between", [left, lo, hi], self.registry)
        if t.kind == "in":
            self._expect("op", "(")
            options = [self._parse_or()]
            while self._accept("op", ","):
                options.append(self._parse_or())
            self._expect("op", ")")
            return in_(left, options)
        if t.kind == "like":
            pattern = self._parse_additive()
            return make_call("like", [left, pattern], self.registry)
        raise ValueError(f"unexpected {t!r}")

    def _parse_additive(self) -> Expr:
        left = self._parse_multiplicative()
        while True:
            t = self._peek()
            if t.kind == "op" and t.text in ("+", "-"):
                self._next()
                right = self._parse_multiplicative()
                name = "plus" if t.text == "+" else "minus"
                if isinstance(right, _IntervalDays):
                    days = right.value if t.text == "+" else -right.value
                    left = make_call(
                        "date_add_days", [left, Constant(BIGINT, days)], self.registry
                    )
                else:
                    left = make_call(name, [left, right], self.registry)
            else:
                return left

    def _parse_multiplicative(self) -> Expr:
        left = self._parse_unary()
        while True:
            t = self._peek()
            if t.kind == "op" and t.text in ("*", "/", "%"):
                self._next()
                right = self._parse_unary()
                name = {"*": "multiply", "/": "divide", "%": "mod"}[t.text]
                left = make_call(name, [left, right], self.registry)
            else:
                return left

    def _parse_unary(self) -> Expr:
        if self._accept("op", "-"):
            child = self._parse_unary()
            if isinstance(child, Constant) and child.dtype.is_numeric:
                return Constant(child.dtype, -child.value)
            return make_call("negate", [child], self.registry)
        if self._accept("op", "+"):
            return self._parse_unary()
        return self._postfix(self._parse_primary())

    def _postfix(self, e: Expr) -> Expr:
        """Subscript chains: a[i], m['k'], a[i][j] (Presto SUBSCRIPT)."""
        while self._accept("op", "["):
            idx = self._parse_or()
            self._expect("op", "]")
            e = make_call("subscript", [e, idx], self.registry)
        return e

    # ---- primaries -----------------------------------------------------
    def _parse_primary(self) -> Expr:
        t = self._next()
        if t.kind == "op" and t.text == "(":
            e = self._parse_or()
            self._expect("op", ")")
            return e
        if t.kind == "number":
            return self._number(t.text)
        if t.kind == "string":
            return Constant(VARCHAR, t.text)
        if t.kind == "true":
            return Constant(BOOLEAN, True)
        if t.kind == "false":
            return Constant(BOOLEAN, False)
        if t.kind == "null":
            return Constant(DataType(TypeKind.UNKNOWN), None)
        if t.kind == "date":
            s = self._expect("string")
            return Constant(DATE, parse_date(s.text))
        if t.kind == "timestamp":
            s = self._expect("string")
            dt = datetime.datetime.fromisoformat(s.text)
            micros = int(dt.replace(tzinfo=datetime.timezone.utc).timestamp() * 1e6)
            return Constant(TIMESTAMP, micros)
        if t.kind == "interval":
            s = self._expect("string")
            self._expect("day")
            return _IntervalDays(BIGINT, int(s.text))
        if t.kind in ("cast", "try_cast"):
            self._expect("op", "(")
            child = self._parse_or()
            self._expect("as")
            target = self._parse_type()
            self._expect("op", ")")
            return cast(child, target, try_=(t.kind == "try_cast"))
        if t.kind == "try":
            self._expect("op", "(")
            child = self._parse_or()
            self._expect("op", ")")
            return try_(child)
        if t.kind == "case":
            return self._parse_case()
        if t.kind == "name":
            if t.text.lower() == "x" and self._peek().kind == "string":
                # X'AB12' VARBINARY literal (Presto/Spark hex binary syntax)
                s = self._next()
                return Constant(
                    VARBINARY, bytes.fromhex(s.text.replace(" ", ""))
                )
            if (
                t.text.lower() == "array"
                and self._peek().kind == "op"
                and self._peek().text == "["
            ):
                return self._parse_array_literal()
            if self._peek().kind == "op" and self._peek().text == "(":
                return self._parse_call(t.text)
            if t.text in self.locals:
                return FieldAccess(self.locals[t.text], t.text)
            if t.text in self.schema:
                return FieldAccess(self.schema.type_of(t.text), t.text)
            if "." in t.text:
                return self._dotted_field(t.text)
            raise ValueError(f"unknown column {t.text!r} (schema: {self.schema})")
        # Keywords that double as function names (e.g. day(d)).
        if t.kind in _KEYWORDS and self._peek().kind == "op" and self._peek().text == "(":
            return self._parse_call(t.kind)
        raise ValueError(f"unexpected token {t!r}")

    def _dotted_field(self, text: str) -> Expr:
        """r.f / r.f.g — ROW field dereference chains (core::FieldAccessTypedExpr
        with a ROW-typed input)."""
        from ..dtypes import TypeKind
        from .ir import Call

        parts = text.split(".")
        base_name = parts[0]
        if base_name in self.locals:
            base: Expr = FieldAccess(self.locals[base_name], base_name)
        elif base_name in self.schema:
            base = FieldAccess(self.schema.type_of(base_name), base_name)
        else:
            raise ValueError(
                f"unknown column {base_name!r} (schema: {self.schema})"
            )
        for field_name in parts[1:]:
            if base.dtype.kind != TypeKind.ROW:
                raise TypeError(f"{base}: .{field_name} needs a ROW input")
            child_t = base.dtype.child(field_name)
            base = Call(
                child_t, "row_field", (base, Constant(VARCHAR, field_name))
            )
        return base

    def _number(self, text: str) -> Constant:
        if "e" in text.lower():
            return Constant(DOUBLE, float(text))
        if "." in text:
            digits = text.replace(".", "").lstrip("0") or "0"
            scale = len(text.split(".")[1])
            unscaled = int(round(float(text) * 10**scale))
            return Constant(decimal(max(len(digits), scale + 1), scale), unscaled)
        return Constant(BIGINT, int(text))

    def _parse_call(self, name: str) -> Expr:
        self._expect("op", "(")
        low = name.lower()
        args: List[Expr] = []
        if not (self._peek().kind == "op" and self._peek().text == ")"):
            while True:
                params = self._peek_lambda_params()
                if params is not None:
                    args.append(self._parse_lambda(low, len(args), args, params))
                else:
                    args.append(self._parse_or())
                if not self._accept("op", ","):
                    break
        self._expect("op", ")")
        if low == "if":
            return if_(args[0], *self._align_branches(args[1], args[2]))
        if low == "coalesce":
            return Special(args[0].dtype, SpecialForm.COALESCE, tuple(args))
        return make_call(low, args, self.registry)

    # ---- lambdas / array literals --------------------------------------
    def _peek_lambda_params(self) -> Optional[List[str]]:
        """Lookahead for ``x ->`` or ``(x, y) ->`` at the current position."""
        i = self.pos
        toks = self.tokens
        if toks[i].kind == "name" and toks[i + 1].kind == "op" and toks[i + 1].text == "->":
            return [toks[i].text]
        if toks[i].kind == "op" and toks[i].text == "(":
            j = i + 1
            names = []
            while toks[j].kind == "name":
                names.append(toks[j].text)
                j += 1
                if toks[j].kind == "op" and toks[j].text == ",":
                    j += 1
                    continue
                break
            if (
                names
                and toks[j].kind == "op"
                and toks[j].text == ")"
                and toks[j + 1].kind == "op"
                and toks[j + 1].text == "->"
            ):
                return names
        return None

    def _parse_lambda(
        self, fname: str, arg_index: int, prior: List[Expr], params: List[str]
    ) -> Expr:
        from .ir import Lambda

        param_types = _lambda_param_types(fname, arg_index, prior, len(params))
        if len(param_types) != len(params):
            raise ValueError(
                f"{fname}: lambda takes {len(param_types)} parameter(s), got {params}"
            )
        # consume the parameter tokens
        if self._peek().text == "(":
            self._expect("op", "(")
            self._expect("name")
            while self._accept("op", ","):
                self._expect("name")
            self._expect("op", ")")
        else:
            self._expect("name")
        self._expect("op", "->")
        saved = dict(self.locals)
        self.locals.update(dict(zip(params, param_types)))
        try:
            body = self._parse_or()
        finally:
            self.locals = saved
        return Lambda(body.dtype, tuple(params), tuple(param_types), body)

    def _parse_array_literal(self) -> Expr:
        from ..dtypes import array as array_t, common_numeric_type
        from .ir import Call

        self._expect("op", "[")
        elems: List[Expr] = []
        if not (self._peek().kind == "op" and self._peek().text == "]"):
            elems.append(self._parse_or())
            while self._accept("op", ","):
                elems.append(self._parse_or())
        self._expect("op", "]")
        if not elems:
            raise ValueError("empty ARRAY[] literal needs a type context")
        target = elems[0].dtype
        for e in elems[1:]:
            if not e.dtype.equivalent(target):
                target = common_numeric_type(target, e.dtype)
        elems = [
            e if e.dtype.equivalent(target) else cast(e, target) for e in elems
        ]
        return Call(array_t(target), "array_constructor", tuple(elems))

    def _parse_case(self) -> Expr:
        args: List[Expr] = []
        while self._accept("when"):
            cond = self._parse_or()
            self._expect("then")
            args.append(cond)
            args.append(self._parse_or())
        else_e = None
        if self._accept("else"):
            else_e = self._parse_or()
        self._expect("end")
        values = args[1::2] + ([else_e] if else_e is not None else [])
        # NULL branches adopt the other branches' type (typed-null constants)
        typed = [v for v in values if v.dtype.kind != TypeKind.UNKNOWN]
        if not typed:
            raise ValueError("CASE needs at least one non-NULL branch")
        target = typed[0].dtype
        for v in typed[1:]:
            if not v.dtype.equivalent(target):
                from ..dtypes import common_numeric_type

                target = common_numeric_type(target, v.dtype)

        def coerce(e: Expr) -> Expr:
            if e.dtype.kind == TypeKind.UNKNOWN:
                return Constant(target, None)
            return e if e.dtype.equivalent(target) else cast(e, target)

        new_args = []
        for i, a in enumerate(args):
            new_args.append(coerce(a) if i % 2 == 1 else a)
        if else_e is not None:
            new_args.append(coerce(else_e))
        return Special(target, SpecialForm.SWITCH, tuple(new_args))

    def _align_branches(self, a: Expr, b: Expr):
        if a.dtype.equivalent(b.dtype):
            return a, b
        from ..dtypes import common_numeric_type

        target = common_numeric_type(a.dtype, b.dtype)
        if not a.dtype.equivalent(target):
            a = cast(a, target)
        if not b.dtype.equivalent(target):
            b = cast(b, target)
        return a, b

    def _parse_type(self) -> DataType:
        t = self._expect("name") if self._peek().kind == "name" else self._next()
        name = t.text.lower()
        if name == "decimal":
            self._expect("op", "(")
            p = int(self._expect("number").text)
            self._expect("op", ",")
            s = int(self._expect("number").text)
            self._expect("op", ")")
            return decimal(p, s)
        if name in _TYPE_NAMES:
            return _TYPE_NAMES[name]
        raise ValueError(f"unknown type {name!r}")


def _lambda_param_types(fname: str, arg_index: int, prior: Sequence[Expr], nparams: int):
    """Parameter types for a lambda at ``arg_index`` of function ``fname``
    (the reference resolves these in the SignatureBinder; here the table is
    explicit per higher-order function)."""
    from ..dtypes import TypeKind

    def elem(i=0):
        t = prior[i].dtype
        assert t.kind == TypeKind.ARRAY, f"{fname}: arg {i} must be ARRAY, got {t}"
        return t.element

    def map_kv():
        t = prior[0].dtype
        assert t.kind == TypeKind.MAP, f"{fname}: arg 0 must be MAP, got {t}"
        return (t.key_type, t.value_type)

    if fname in ("transform", "filter", "any_match", "all_match", "none_match"):
        return (elem(),)
    if fname == "reduce":
        state_t = prior[1].dtype
        if arg_index == 2:
            return (state_t, elem())
        return (state_t,)
    if fname == "zip_with":
        return (elem(0), elem(1))
    if fname == "map_zip_with":
        t0, t1 = prior[0].dtype, prior[1].dtype
        assert t0.kind == TypeKind.MAP and t1.kind == TypeKind.MAP
        return (t0.key_type, t0.value_type, t1.value_type)
    if fname in ("map_filter", "transform_keys", "transform_values"):
        return map_kv()
    raise ValueError(f"{fname} does not take a lambda argument")


def parse_expr(text: str, schema: RowType, registry: FunctionRegistry = None) -> Expr:
    """Parse one SQL expression against a schema (reference: parse/ExpressionsParser.h:37)."""
    return ExprParser(schema, registry).parse(text)
