"""SQL SELECT -> PlanNode planner.

A copy of the JAX package's ``sql/planner.py``: the same texts plan to the
same trees over this package's ``PlanBuilder``, window functions, UNION [ALL]
and non-equi joins included.  Branches that reach builder methods not ported
yet (``unnest``, ``group_id``: complex types and GROUPING SETS) raise by name.

Reference seam: velox/duckdb/conversion/QueryPlanner.h:24 (parseQuery over an
embedded DuckDB) and exec/tests/utils/QueryAssertions — here re-implemented as
a native planner so the engine has a SQL surface without a C++ dependency.

Supported grammar (the TPC-H surface plus the common analytics shapes):

    SELECT [DISTINCT] item [, item ...]
    FROM   ref [, ref ...] [ [INNER|LEFT|RIGHT|FULL|CROSS] JOIN ref ON cond ]*
    [WHERE pred] [GROUP BY key [, key ...]] [HAVING pred]
    [ORDER BY expr [ASC|DESC] [NULLS FIRST|LAST] [, ...]]
    [LIMIT n [OFFSET m]]

where ``ref`` is a catalog table (optionally aliased) or a parenthesized
subquery with an alias.  Scalar expressions are delegated to the engine's
expression parser (expr/parser.py); this module only handles statement
structure, cross-source name resolution, and aggregate extraction.

Design notes (TPU-first consequences):
- comma-style FROM extracts equi-conjuncts from WHERE into hash-join keys in
  FROM order and pushes single-source conjuncts below the joins — the minimal
  planning the fixed-shape tile programs need (there is no cost-based
  optimizer; join order is the query author's order, like the reference's
  TpchQueryBuilder hand-built plans).
- aggregates are extracted textually from the select list / HAVING / ORDER BY
  into an AggregationNode and the surrounding expression is evaluated above it
  (the reference's planner does the same split, core/PlanNode.h aggregation +
  projection).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from ..io.table import Table
from ..plan.builder import PlanBuilder

# ---------------------------------------------------------------------------
# tokenizer


class _Tok:
    __slots__ = ("kind", "text")

    def __init__(self, kind: str, text: str):
        self.kind = kind  # 'name' | 'number' | 'string' | 'op'
        self.text = text

    @property
    def low(self) -> str:
        return self.text.lower()

    def __repr__(self):  # pragma: no cover
        return f"{self.kind}:{self.text}"


_SQL_TOKEN_RE = re.compile(
    r"""
    \s*(?:
      (?P<comment>--[^\n]*)
    | (?P<number>\d+\.\d+(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)
    | (?P<name>[A-Za-z_][A-Za-z_0-9]*(?:\.(?:[A-Za-z_][A-Za-z_0-9]*|\*))?)
    | (?P<string>'(?:[^']|'')*')
    | (?P<op><>|!=|>=|<=|->|=|<|>|\|\||[+\-*/%(),\[\];])
    )""",
    re.VERBOSE,
)


def _tokenize(sql: str) -> List[_Tok]:
    out: List[_Tok] = []
    pos = 0
    while pos < len(sql):
        m = _SQL_TOKEN_RE.match(sql, pos)
        if not m or m.end() == pos:
            if sql[pos:].strip() == "":
                break
            raise ValueError(f"cannot tokenize SQL at {sql[pos:pos+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "comment":
            continue
        out.append(_Tok("op" if kind == "op" else kind, m.group(kind)))
    return out


def _detok(tokens: Sequence[_Tok]) -> str:
    """Reconstruct expression text the expression parser accepts."""
    parts: List[str] = []
    for t in tokens:
        parts.append(t.text)
    return " ".join(parts)


# clause keywords that terminate an expression slice at depth 0
_CLAUSE_KW = {
    "from", "where", "group", "having", "order", "limit", "offset",
    "join", "inner", "left", "right", "full", "cross", "on", "union",
}

# aggregate functions the extractor recognizes: the JAX package's whole
# aggregate and collect-aggregate surface, so that a text plans to the same
# tree there and here; scalar calls never share these names.  Binding one the
# port has not ported yet raises by name (exec/aggregates.py bind_aggregate).
_AGGREGATE_NAMES = (
    "count", "count_if", "sum", "min", "max", "avg", "arbitrary",
    "bool_and", "bool_or", "every", "min_by", "max_by",
    "variance", "var_samp", "var_pop", "stddev", "stddev_samp", "stddev_pop",
    "geometric_mean", "checksum", "covar_pop", "covar_samp", "corr",
    "skewness", "kurtosis", "bitwise_and_agg", "bitwise_or_agg",
    "approx_distinct", "bloom_filter_agg",
)
_COLLECT_AGG_NAMES = (
    "array_agg", "set_agg", "map_agg", "histogram", "map_union",
    "approx_percentile", "approx_most_frequent", "entropy", "multimap_agg",
    "__dd_quantile", "__kll_quantile", "__bloom_assemble",
)


def _agg_names() -> frozenset:
    return frozenset(_AGGREGATE_NAMES) | frozenset(_COLLECT_AGG_NAMES) | {
        "approx_distinct", "reduce_agg",
    }


# ---------------------------------------------------------------------------
# scope: name resolution across FROM sources


class _Scope:
    """Maps SQL spellings (``col``, ``alias.col``) to internal column names."""

    def __init__(self):
        self.map: Dict[str, str] = {}
        self.ambiguous: set = set()

    def add(self, alias: Optional[str], columns: Sequence[str]):
        for col in columns:
            low = col.lower()
            if low in self.map and self.map[low] != col:
                self.ambiguous.add(low)
            else:
                self.map.setdefault(low, col)
            if alias:
                self.map[f"{alias.lower()}.{low}"] = col

    def resolve(self, spelling: str) -> Optional[str]:
        low = spelling.lower()
        if low in self.ambiguous and "." not in low:
            raise ValueError(f"ambiguous column reference {spelling!r}")
        return self.map.get(low)

    def rewrite(self, tokens: Sequence[_Tok]) -> List[_Tok]:
        out = []
        for t in tokens:
            if t.kind == "name":
                r = self.map.get(t.low)
                if t.low in self.ambiguous and "." not in t.low:
                    raise ValueError(f"ambiguous column reference {t.text!r}")
                if r is not None:
                    t = _Tok("name", r)
            out.append(t)
        return out


def _unique_name(base: str, used: set) -> str:
    if base not in used:
        return base
    i = 2
    while f"{base}_{i}" in used:
        i += 1
    return f"{base}_{i}"


# ---------------------------------------------------------------------------
# conjunct utilities


def _split_conjuncts(tokens: Sequence[_Tok]) -> List[List[_Tok]]:
    """Split on top-level AND (parens- , CASE..END- and BETWEEN..AND-aware)."""
    out: List[List[_Tok]] = []
    depth = 0
    pending_between = 0
    start = 0
    for i, t in enumerate(tokens):
        if t.kind == "op" and t.text == "(":
            depth += 1
        elif t.kind == "op" and t.text == ")":
            depth -= 1
        elif t.kind == "name" and depth == 0:
            low = t.low
            if low == "case":
                depth += 1  # CASE..END behaves like a bracket
            elif low == "end":
                depth -= 1
            elif low == "between":
                pending_between += 1
            elif low == "and":
                if pending_between:
                    pending_between -= 1
                else:
                    out.append(list(tokens[start:i]))
                    start = i + 1
    out.append(list(tokens[start:]))
    return [c for c in out if c]


def _split_top_level(tokens: Sequence[_Tok], sep: str) -> List[List[_Tok]]:
    out: List[List[_Tok]] = []
    depth = 0
    start = 0
    for i, t in enumerate(tokens):
        if t.kind == "op" and t.text == "(":
            depth += 1
        elif t.kind == "op" and t.text == ")":
            depth -= 1
        elif depth == 0 and t.kind == "op" and t.text == sep:
            out.append(list(tokens[start:i]))
            start = i + 1
    out.append(list(tokens[start:]))
    return out


def _columns_in(tokens: Sequence[_Tok], universe: set) -> set:
    return {t.text for t in tokens if t.kind == "name" and t.text in universe}


def _is_equality(tokens: Sequence[_Tok]) -> Optional[Tuple[str, str]]:
    if (
        len(tokens) == 3
        and tokens[0].kind == "name"
        and tokens[1].kind == "op"
        and tokens[1].text == "="
        and tokens[2].kind == "name"
    ):
        return tokens[0].text, tokens[2].text
    return None


# ---------------------------------------------------------------------------
# aggregate extraction


def _match_paren(tokens: Sequence[_Tok], open_idx: int) -> int:
    depth = 0
    for i in range(open_idx, len(tokens)):
        t = tokens[i]
        if t.kind == "op" and t.text == "(":
            depth += 1
        elif t.kind == "op" and t.text == ")":
            depth -= 1
            if depth == 0:
                return i
    raise ValueError("unbalanced parentheses")


class _WinExtractor:
    """Pulls ``fn(args) OVER (...)`` calls out of select items.

    Each distinct OVER clause becomes one WindowNode (PlanBuilder.window);
    the call text (with any ROWS/RANGE frame appended) is handed to
    exec.window.parse_window_call."""

    def __init__(self, scope: _Scope):
        self.scope = scope
        # list of (partition names, order specs, [(call text, out name)])
        self.windows: List[tuple] = []

    def extract(self, tokens: List[_Tok]) -> List[_Tok]:
        out: List[_Tok] = []
        i = 0
        while i < len(tokens):
            t = tokens[i]
            if (
                t.kind == "name"
                and i + 1 < len(tokens)
                and tokens[i + 1].kind == "op"
                and tokens[i + 1].text == "("
            ):
                close = _match_paren(tokens, i + 1)
                if close + 1 < len(tokens) and tokens[close + 1].low == "over":
                    if tokens[close + 2].text != "(":
                        raise ValueError("OVER requires a parenthesized spec")
                    oclose = _match_paren(tokens, close + 2)
                    spec = tokens[close + 3 : oclose]
                    name = self._add(tokens[i : close + 1], spec)
                    out.append(_Tok("name", name))
                    i = oclose + 1
                    continue
            out.append(t)
            i += 1
        return out

    def _add(self, call_toks: List[_Tok], spec: List[_Tok]) -> str:
        part: List[str] = []
        order: List[str] = []
        frame = ""
        j = 0
        while j < len(spec):
            low = spec[j].low
            if low == "partition":
                j += 2  # PARTITION BY
                while j < len(spec) and spec[j].low not in ("order", "rows", "range"):
                    if spec[j].text != ",":
                        nm = self.scope.resolve(spec[j].text)
                        if nm is None and spec[j].text.startswith("__agg"):
                            nm = spec[j].text  # extracted aggregate column
                        if nm is None:
                            raise NotImplementedError(
                                "PARTITION BY supports plain columns only"
                            )
                        part.append(nm)
                    j += 1
            elif low == "order":
                j += 2  # ORDER BY
                cur: List[str] = []
                while j < len(spec) and spec[j].low not in ("rows", "range"):
                    tok = spec[j]
                    if tok.text == ",":
                        order.append(" ".join(cur))
                        cur = []
                    elif tok.low in ("asc", "desc", "nulls", "first", "last"):
                        cur.append(tok.low)
                    else:
                        nm = self.scope.resolve(tok.text)
                        if nm is None and tok.text.startswith("__agg"):
                            nm = tok.text  # extracted aggregate column
                        if nm is None:
                            raise NotImplementedError(
                                "window ORDER BY supports plain columns only"
                            )
                        cur.append(nm)
                    j += 1
                if cur:
                    order.append(" ".join(cur))
            elif low in ("rows", "range"):
                frame = " " + _detok(spec[j:])
                break
            else:
                raise ValueError(f"bad window spec near {spec[j].text!r}")
        call_text = _detok(self.scope.rewrite(call_toks)) + frame
        name = f"__win{sum(len(w[2]) for w in self.windows)}"
        key = (tuple(part), tuple(order))
        for w in self.windows:
            if (tuple(w[0]), tuple(w[1])) == key:
                w[2].append((call_text, name))
                return name
        self.windows.append((part, order, [(call_text, name)]))
        return name

    @property
    def found(self) -> bool:
        return bool(self.windows)


class _AggExtractor:
    """Pulls aggregate calls out of expression token streams, replacing each
    with a generated column name; identical calls share one output."""

    def __init__(self):
        self.names = _agg_names()
        self.calls: List[str] = []  # call text, e.g. 'sum( x + 1 )'
        self.outs: List[str] = []   # generated output names

    def extract(self, tokens: List[_Tok]) -> List[_Tok]:
        out: List[_Tok] = []
        i = 0
        while i < len(tokens):
            t = tokens[i]
            if (
                t.kind == "name"
                and t.low in self.names
                and i + 1 < len(tokens)
                and tokens[i + 1].kind == "op"
                and tokens[i + 1].text == "("
            ):
                close = _match_paren(tokens, i + 1)
                if close + 1 < len(tokens) and tokens[close + 1].low == "over":
                    # a windowed aggregate (sum(x) OVER ...) is not a group
                    # aggregate — leave the outer call for _WinExtractor, but
                    # still extract group aggregates from its arguments
                    # (sum(sum(x)) OVER ... over grouped rows)
                    out.extend(tokens[i : i + 2])
                    out.extend(self.extract(tokens[i + 2 : close]))
                    out.append(tokens[close])
                    i = close + 1
                    continue
                text = _detok(tokens[i : close + 1])
                if text in self.calls:
                    name = self.outs[self.calls.index(text)]
                else:
                    name = f"__agg{len(self.calls)}"
                    self.calls.append(text)
                    self.outs.append(name)
                out.append(_Tok("name", name))
                i = close + 1
            else:
                out.append(t)
                i += 1
        return out

    @property
    def found(self) -> bool:
        return bool(self.calls)


def _subst(tokens: List[_Tok], pattern: List[_Tok], name: str) -> List[_Tok]:
    """Replace token subsequences equal to ``pattern`` with a name token."""
    pat = [p.text for p in pattern]
    n = len(pat)
    out: List[_Tok] = []
    i = 0
    while i < len(tokens):
        if n and [t.text for t in tokens[i : i + n]] == pat:
            out.append(_Tok("name", name))
            i += n
        else:
            out.append(tokens[i])
            i += 1
    return out


# ---------------------------------------------------------------------------
# parser


class _Parser:
    def __init__(self, tokens: List[_Tok], catalog: Dict[str, Table]):
        self.toks = tokens
        self.pos = 0
        self.catalog = catalog

    # -- token helpers ----------------------------------------------------
    def peek(self, ahead: int = 0) -> Optional[_Tok]:
        i = self.pos + ahead
        return self.toks[i] if i < len(self.toks) else None

    def next(self) -> _Tok:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of SQL")
        self.pos += 1
        return t

    def accept(self, low: str) -> bool:
        t = self.peek()
        if t is not None and t.low == low:
            self.pos += 1
            return True
        return False

    def expect(self, low: str):
        t = self.next()
        if t.low != low:
            raise ValueError(f"expected {low!r}, got {t.text!r}")

    def _slice_until(self, stops: set) -> List[_Tok]:
        """Consume tokens until a depth-0 stop keyword / ')' / ',' per stops."""
        out: List[_Tok] = []
        depth = 0
        while True:
            t = self.peek()
            if t is None:
                break
            if t.kind == "op" and t.text == "(":
                depth += 1
            elif t.kind == "op" and t.text == ")":
                if depth == 0:
                    break
                depth -= 1
            elif depth == 0:
                if t.kind == "name" and t.low in stops:
                    break
                if "," in stops and t.kind == "op" and t.text == ",":
                    break
                if ";" in stops and t.kind == "op" and t.text == ";":
                    break
            out.append(self.next())
        return out

    # -- FROM refs ---------------------------------------------------------
    def _parse_ref(self):
        """-> (alias, PlanBuilder) for one table reference."""
        t = self.peek()
        if t is None:
            raise ValueError("expected table reference")
        if t.kind == "op" and t.text == "(":
            self.next()
            sub = self.parse_select()
            self.expect(")")
            alias = self._parse_alias(required=True)
            return alias, sub
        name = self.next()
        if name.kind != "name":
            raise ValueError(f"expected table name, got {name.text!r}")
        table = self.catalog.get(name.text) or self.catalog.get(name.low)
        if table is None:
            raise KeyError(f"table {name.text!r} not in catalog")
        alias = self._parse_alias(required=False) or name.low
        return alias, PlanBuilder().table_scan(table)

    def _parse_alias(self, required: bool) -> Optional[str]:
        self.accept("as")
        t = self.peek()
        if (
            t is not None
            and t.kind == "name"
            and t.low not in _CLAUSE_KW
            and t.low != "and"
        ):
            self.next()
            return t.text
        if required:
            raise ValueError("subquery in FROM requires an alias")
        return None

    # -- SELECT ------------------------------------------------------------
    def parse_select(
        self, outer_scope=None, correlated_out=None, in_setop=False
    ) -> PlanBuilder:
        first = self._parse_one_select(outer_scope, correlated_out, in_setop)
        if self.peek() is None or self.peek().low != "union":
            return first
        # UNION [ALL] chain: branches align by position; apply ORDER BY /
        # LIMIT to the whole set-op via a subquery:
        #   select * from (... union ...) u order by ...
        branches = [first]
        distinct = False
        while self.peek() is not None and self.peek().low == "union":
            self.next()
            if not self.accept("all"):
                distinct = True
            branches.append(
                self._parse_one_select(outer_scope, correlated_out, True)
            )
        pb = PlanBuilder().union_all(branches)
        if distinct:
            names = list(pb.schema.names)
            pb.aggregation(names, ["count(*) as __u"])
            pb.project(names)
        # trailing ORDER BY / LIMIT applies to the whole set-op (SQL rule:
        # only the last branch may carry them, and they order the union)
        order_items: List[List[_Tok]] = []
        if self.accept("order"):
            self.expect("by")
            order_items = _split_top_level(
                self._slice_until({"limit", "offset", ";"}), ","
            )
        limit = offset = None
        if self.accept("limit"):
            limit = int(self.next().text)
        if self.accept("offset"):
            offset = int(self.next().text)
        self.accept(";")
        if order_items:
            scope = _Scope()
            scope.add(None, pb.schema.names)
            specs = []
            for item in order_items:
                toks, asc, nf = _parse_order_item(item, scope)
                if len(toks) == 1 and toks[0].kind == "number":
                    key = pb.schema.names[int(toks[0].text) - 1]
                elif len(toks) == 1 and toks[0].kind == "name":
                    key = scope.resolve(toks[0].text) or toks[0].text
                else:
                    raise NotImplementedError(
                        "ORDER BY on a UNION supports output columns / "
                        "ordinals only"
                    )
                specs.append(
                    key
                    + ("" if asc else " desc")
                    + (" nulls first" if nf else "")
                )
            if limit is not None and not offset:
                pb.topn(specs, limit)
            else:
                pb.orderby(specs)
                if limit is not None or offset:
                    pb.limit(
                        limit if limit is not None else (1 << 62), offset or 0
                    )
        elif limit is not None or offset:
            pb.limit(limit if limit is not None else (1 << 62), offset or 0)
        return pb

    def _parse_one_select(
        self, outer_scope=None, correlated_out=None, in_setop=False
    ) -> PlanBuilder:
        self.expect("select")
        distinct = self.accept("distinct")

        select_items = [
            _split_as(item)
            for item in _split_top_level(self._slice_until({"from"}), ",")
        ]

        self.expect("from")

        sources: List[Tuple[str, PlanBuilder]] = []
        joins: List[Tuple[str, str, PlanBuilder, List[_Tok]]] = []
        sources.append(self._parse_ref())
        while True:
            t = self.peek()
            if t is None:
                break
            if t.kind == "op" and t.text == ",":
                self.next()
                sources.append(self._parse_ref())
                continue
            jt = None
            if t.low in ("inner", "join"):
                self.accept("inner")
                self.expect("join")
                jt = "inner"
            elif t.low in ("left", "right", "full"):
                self.next()
                self.accept("outer")
                self.expect("join")
                jt = t.low
            elif t.low == "cross":
                self.next()
                self.expect("join")
                jt = "cross"
            if jt is None:
                break
            alias, rb = self._parse_ref()
            cond: List[_Tok] = []
            if jt != "cross":
                self.expect("on")
                cond = self._slice_until(
                    {"where", "group", "having", "order", "limit", "offset",
                     "join", "inner", "left", "right", "full", "cross",
                     "union", ";"}
                )
            joins.append((jt, alias, rb, cond))

        where_toks: List[_Tok] = []
        if self.accept("where"):
            where_toks = self._slice_until(
                {"group", "having", "order", "limit", "offset", "union", ";"}
            )
        group_items: List[List[_Tok]] = []
        if self.accept("group"):
            self.expect("by")
            group_items = _split_top_level(
                self._slice_until(
                    {"having", "order", "limit", "offset", "union", ";"}
                ),
                ",",
            )
        having_toks: List[_Tok] = []
        if self.accept("having"):
            having_toks = self._slice_until(
                {"order", "limit", "offset", "union", ";"}
            )
        order_items: List[List[_Tok]] = []
        limit = offset = None
        if not in_setop:
            # inside a set-op, trailing ORDER BY / LIMIT belongs to the whole
            # UNION (parse_select consumes it); a non-final branch cannot
            # carry one (clause slicing stops at UNION, so it never does)
            if self.accept("order"):
                self.expect("by")
                order_items = _split_top_level(
                    self._slice_until({"limit", "offset", "union", ";"}), ","
                )
            if self.accept("limit"):
                limit = int(self.next().text)
            if self.accept("offset"):
                offset = int(self.next().text)
            if (order_items or limit is not None or offset) and (
                self.peek() is not None and self.peek().low == "union"
            ):
                raise NotImplementedError(
                    "ORDER BY / LIMIT before UNION is not valid SQL; apply "
                    "them after the last branch to order the whole set-op"
                )
            self.accept(";")

        return _assemble(
            sources, joins, where_toks, select_items, distinct,
            group_items, having_toks, order_items, limit, offset,
            self.catalog, outer_scope, correlated_out,
        )


def _split_as(tokens: List[_Tok]) -> Tuple[List[_Tok], Optional[str]]:
    """'expr AS name' / trailing bare-name alias -> (expr tokens, alias)."""
    if (
        len(tokens) >= 3
        and tokens[-2].kind == "name"
        and tokens[-2].low == "as"
        and tokens[-1].kind == "name"
    ):
        return list(tokens[:-2]), tokens[-1].text
    return list(tokens), None


# ---------------------------------------------------------------------------
# plan assembly


def _rename_collisions(
    sources: List[Tuple[str, PlanBuilder]]
) -> Tuple[List[Tuple[str, PlanBuilder]], _Scope]:
    """Give every source unique column names (renaming collisions to
    ``alias__col``) and build the spelling scope."""
    scope = _Scope()
    used: set = set()
    out = []
    for alias, pb in sources:
        names = list(pb.schema.names)
        renames = {}
        for n in names:
            if n in used:
                renames[n] = f"{alias}__{n}"
        if renames:
            pb = PlanBuilder(pb.node).project(
                [
                    f"{n} as {renames[n]}" if n in renames else n
                    for n in names
                ]
            )
        final = [renames.get(n, n) for n in names]
        used.update(final)
        # spellings: alias.original -> internal; bare original if unique —
        # a renamed collision makes the bare spelling ambiguous (SQL rules)
        scope.add(None, final)
        for n in renames:
            scope.ambiguous.add(n.lower())
        if alias:
            for orig, internal in zip(names, final):
                scope.map[f"{alias.lower()}.{orig.lower()}"] = internal
        out.append((alias, pb))
    return out, scope


def _join_sources(
    sources, joins, conjuncts, scope
) -> Tuple[PlanBuilder, List[List[_Tok]]]:
    """Assemble the join tree; returns (plan, leftover conjuncts).

    ``conjuncts``: WHERE conjuncts already rewritten to internal names."""
    ncomma = len(sources)
    col_owner: Dict[str, int] = {}
    for i, (_, pb) in enumerate(sources):
        for n in pb.schema.names:
            col_owner[n] = i
    # explicit-JOIN sources own ids >= ncomma so WHERE conjuncts touching
    # their columns place correctly (above the join, or pushed into an
    # INNER join's side — never below a LEFT/RIGHT/FULL join, where
    # pre-filtering the null-padded side would change semantics)
    for j, (_jt, _alias, rb, _cond) in enumerate(joins):
        for n in rb.schema.names:
            col_owner[n] = ncomma + j
    universe = set(col_owner)

    pushed: List[List[List[_Tok]]] = [[] for _ in sources]
    pushed_joins: List[List[List[_Tok]]] = [[] for _ in joins]
    equis: List[Tuple[str, str]] = []
    leftovers: List[List[_Tok]] = []
    for c in conjuncts:
        cols = _columns_in(c, universe)
        owners = {col_owner[x] for x in cols}
        eq = _is_equality(c)
        if len(owners) <= 1:
            if not owners:
                leftovers.append(c)  # constant predicate
            else:
                o = owners.pop()
                if o < ncomma:
                    pushed[o].append(c)
                elif joins[o - ncomma][0] == "inner":
                    pushed_joins[o - ncomma].append(c)
                else:
                    leftovers.append(c)
        elif (
            eq
            and len(owners) == 2
            and all(o < ncomma for o in owners)
            and eq[0] in universe
            and eq[1] in universe
        ):
            equis.append(eq)
        else:
            leftovers.append(c)

    builders = []
    for i, (alias, pb) in enumerate(sources):
        for c in pushed[i]:
            pb = PlanBuilder(pb.node).filter(_detok(c))
        builders.append(pb)
    joins = [
        (
            jt,
            alias,
            (
                PlanBuilder(rb.node).filter(
                    " and ".join(_detok(c) for c in pushed_joins[j])
                )
                if pushed_joins[j]
                else rb
            ),
            cond,
        )
        for j, (jt, alias, rb, cond) in enumerate(joins)
    ]

    plan = builders[0]
    in_plan = set(builders[0].schema.names)
    remaining = list(range(1, len(builders)))
    pending_eq = list(equis)
    while remaining:
        # next source (FROM order) joinable via pending equalities
        pick = None
        for idx in remaining:
            side_cols = set(builders[idx].schema.names)
            keys = [
                (a, b) if a in in_plan else (b, a)
                for a, b in pending_eq
                if (a in in_plan and b in side_cols)
                or (b in in_plan and a in side_cols)
            ]
            if keys:
                pick = (idx, keys)
                break
        if pick is None:  # no equality connects: cartesian with next source
            idx = remaining[0]
            rb = builders[idx]
            plan.cross_join(
                rb, output=list(plan.schema.names) + list(rb.schema.names)
            )
            remaining.remove(idx)
            in_plan.update(rb.schema.names)
            continue
        idx, keys = pick
        rb = builders[idx]
        used_pairs = set()
        lkeys, rkeys = [], []
        for a, b in keys:
            if (a, b) in used_pairs:
                continue
            used_pairs.add((a, b))
            lkeys.append(a)
            rkeys.append(b)
        pending_eq = [
            e for e in pending_eq
            if not (
                (e[0] in in_plan and e[1] in set(rb.schema.names))
                or (e[1] in in_plan and e[0] in set(rb.schema.names))
            )
        ]
        plan.hash_join(
            rb, lkeys, rkeys,
            output=list(plan.schema.names) + list(rb.schema.names),
        )
        remaining.remove(idx)
        in_plan.update(rb.schema.names)

    # unconsumed equalities (cycles) and the rest apply above the joins
    for a, b in pending_eq:
        leftovers.append(
            [_Tok("name", a), _Tok("op", "="), _Tok("name", b)]
        )

    # explicit JOIN ... ON chain
    for jt, alias, rb, cond in joins:
        if jt == "cross":
            plan.cross_join(
                rb, output=list(plan.schema.names) + list(rb.schema.names)
            )
            in_plan.update(rb.schema.names)
            continue
        cond = scope.rewrite(cond)
        side_cols = set(rb.schema.names)
        lkeys, rkeys, residual = [], [], []
        for c in _split_conjuncts(cond):
            eq = _is_equality(c)
            if eq:
                a, b = eq
                if a in in_plan and b in side_cols:
                    lkeys.append(a)
                    rkeys.append(b)
                    continue
                if b in in_plan and a in side_cols:
                    lkeys.append(b)
                    rkeys.append(a)
                    continue
            residual.append(c)
        filt = (
            " and ".join(_detok(c) for c in residual) if residual else None
        )
        if not lkeys:
            # no equality in ON: general nested-loop join with the whole
            # condition (reference: exec/NestedLoopJoinProbe.cpp:23)
            plan.nested_loop_join(
                rb,
                output=list(plan.schema.names) + list(rb.schema.names),
                join_type=jt,
                condition=filt,
            )
            in_plan.update(rb.schema.names)
            continue
        plan.hash_join(
            rb, lkeys, rkeys,
            output=list(plan.schema.names) + list(rb.schema.names),
            join_type=jt,
            filter=filt,
        )
        in_plan.update(rb.schema.names)

    return plan, leftovers


def _find_subquery(tokens: Sequence[_Tok]) -> Optional[Tuple[int, int]]:
    """(open, close) indices of the first ``( SELECT ...`` run, or None."""
    for i, t in enumerate(tokens):
        if (
            t.kind == "op"
            and t.text == "("
            and i + 1 < len(tokens)
            and tokens[i + 1].low == "select"
        ):
            return i, _match_paren(tokens, i)
    return None


def _extract_subquery_ops(conjuncts: List[List[_Tok]], prefix: str = "__sq"):
    """Split WHERE conjuncts into plain predicates and subquery operations.

    Returns (plain, ops) with ops one of
      ('exists',  positive, sub_tokens)
      ('in',      positive, lhs_name_tok, sub_tokens)
      ('scalar',  conjunct_with_placeholders, [(placeholder, sub_tokens)...])
    Reference analog: the reference plans these shapes as semi/anti joins and
    cross joins of single-row subqueries (DuckDB does the decorrelation there).
    """
    plain: List[List[_Tok]] = []
    ops: List[tuple] = []
    n_scalar = 0
    for c in conjuncts:
        low0 = c[0].low if c else ""
        if (
            low0 == "exists"
            and len(c) >= 3
            and c[1].text == "("
            and _match_paren(c, 1) == len(c) - 1
        ):
            ops.append(("exists", True, c[2:-1]))
            continue
        if (
            low0 == "not"
            and len(c) >= 4
            and c[1].low == "exists"
            and c[2].text == "("
            and _match_paren(c, 2) == len(c) - 1
        ):
            ops.append(("exists", False, c[3:-1]))
            continue
        # <name> [NOT] IN ( SELECT ... )
        for j, t in enumerate(c):
            if t.kind == "name" and t.low == "in":
                neg = j > 0 and c[j - 1].low == "not"
                start = j - (2 if neg else 1)
                if (
                    start == 0
                    and c[0].kind == "name"
                    and j + 2 < len(c)
                    and c[j + 1].text == "("
                    and c[j + 2].low == "select"
                    and _match_paren(c, j + 1) == len(c) - 1
                ):
                    ops.append(("in", not neg, c[0], c[j + 2 : -1]))
                    break
        else:
            if _find_subquery(c) is not None:
                # one conjunct may hold several scalar subqueries
                # (Q11: sum(v) > (select ...) / (select count(*) ...))
                subs: List[Tuple[str, List[_Tok]]] = []
                new_c = c
                while True:
                    sq = _find_subquery(new_c)
                    if sq is None:
                        break
                    open_i, close_i = sq
                    ph = _Tok("name", f"{prefix}{n_scalar}")
                    n_scalar += 1
                    subs.append((ph.text, new_c[open_i + 1 : close_i]))
                    new_c = new_c[:open_i] + [ph] + new_c[close_i + 1 :]
                ops.append(("scalar", new_c, subs))
            else:
                plain.append(c)
            continue
    return plain, ops


def _plan_subquery(sub_toks, catalog, scope, want_correlations: bool):
    """Plan a nested SELECT; returns (PlanBuilder, entries) where entries are
    tagged correlations pulled from the subquery's WHERE against the outer
    scope: ("eq", outer_col, inner_col) equality pairs (they become join
    keys) and ("pred", tokens, inner_refs) non-equality predicates (they
    become the enclosing join's non-equi filter)."""
    correlated: List[tuple] = []
    p = _Parser(list(sub_toks), catalog)
    pb = p.parse_select(outer_scope=scope, correlated_out=correlated)
    if p.peek() is not None:
        raise ValueError(f"trailing tokens in subquery: {p.peek().text!r}")
    entries = list(correlated)
    if entries and not want_correlations:
        raise NotImplementedError(
            "correlated subqueries are only supported under EXISTS and "
            "scalar comparisons"
        )
    return pb, entries


def _has_aggregation(node) -> bool:
    from ..plan.nodes import AggregationNode

    if isinstance(node, AggregationNode):
        return True
    return any(_has_aggregation(s) for s in node.sources)


def _apply_subquery_ops(plan: PlanBuilder, ops, catalog, scope) -> PlanBuilder:
    for op in ops:
        kind = op[0]
        if kind == "exists":
            _, positive, sub_toks = op
            sub, entries = _plan_subquery(sub_toks, catalog, scope, True)
            eqs = [(e[1], e[2]) for e in entries if e[0] == "eq"]
            preds = [e for e in entries if e[0] == "pred"]
            if not eqs:
                raise NotImplementedError(
                    "uncorrelated EXISTS is not supported; use a scalar "
                    "count(*) comparison"
                )
            filter_text = None
            renames: Dict[str, str] = {}
            if preds:
                # the join filter evaluates over probe ++ build columns:
                # rename any subquery output colliding with the outer plan
                used = set(plan.schema.names) | set(sub.schema.names)
                for n in sub.schema.names:
                    if n in plan.schema.names:
                        renames[n] = _unique_name(f"__sq_{n}", used)
                        used.add(renames[n])
                if renames:
                    sub.project(
                        [
                            f"{n} as {renames[n]}" if n in renames else n
                            for n in sub.schema.names
                        ]
                    )
                parts_all: List[str] = []
                for _, toks, _refs in preds:
                    parts = []
                    for t in toks:
                        if t.kind == "name" and t.text.startswith("__outer__"):
                            parts.append(t.text[len("__outer__"):])
                        elif t.kind == "name" and t.text in renames:
                            parts.append(renames[t.text])
                        else:
                            parts.append(t.text)
                    parts_all.append("( " + " ".join(parts) + " )")
                filter_text = " and ".join(parts_all)
            plan.hash_join(
                sub,
                [scope.resolve(o) or o for o, _ in eqs],
                [renames.get(i, i) for _, i in eqs],
                output=list(plan.schema.names),
                join_type="left_semi" if positive else "anti",
                filter=filter_text,
            )
        elif kind == "in":
            _, positive, lhs, sub_toks = op
            sub, entries = _plan_subquery(sub_toks, catalog, scope, True)
            lhs_name = scope.resolve(lhs.text) or lhs.text
            if not positive and any(e[0] == "eq" for e in entries):
                plan = _apply_correlated_not_in(
                    plan, lhs_name, sub, entries, scope
                )
                continue
            # IN -> left-semi (a NULL on either side never matches, which
            # already realizes IN's three-valued outcome of "not kept");
            # NOT IN -> NULL-AWARE anti join (reference: nullAware flag on
            # core::HashJoinNode): a NULL in the subquery empties the result,
            # NULL probe values never pass a non-empty list
            eqs = [(e[1], e[2]) for e in entries if e[0] == "eq"]
            if any(e[0] == "pred" for e in entries):
                raise NotImplementedError(
                    "correlated IN subqueries support equality "
                    "correlations only"
                )
            # correlated IN: the correlation equalities ride as extra
            # semi-join keys (x IN (select y from t where t.k = o.k) is a
            # semi join on (x, o.k) = (y, t.k)); correlated NOT IN is
            # rejected at _plan_subquery (null-aware semantics apply to the
            # IN value only, which the compound-key anti join cannot express)
            plan.hash_join(
                sub,
                [lhs_name] + [scope.resolve(o) or o for o, _ in eqs],
                [sub.schema.names[0]] + [i for _, i in eqs],
                output=list(plan.schema.names),
                join_type="left_semi" if positive else "anti",
                null_aware=not positive,
            )
        else:  # scalar — one conjunct, one or more scalar subqueries
            _, conj, subs = op
            phs: List[str] = []
            for ph, sub_toks in subs:
                phs.append(ph)
                plan = _attach_scalar_subquery(
                    plan, ph, sub_toks, catalog, scope
                )
            plan.filter(_detok(scope.rewrite(conj)))
            plan.project([n for n in plan.schema.names if n not in phs])
    return plan


def _apply_correlated_not_in(
    plan: PlanBuilder, lhs_name: str, sub: PlanBuilder, entries, scope
) -> PlanBuilder:
    """x NOT IN (SELECT y FROM t WHERE t.k = o.k): null-aware semantics
    resolve PER CORRELATION KEY (reference: nullAware HashJoinNode + the
    per-group argument of HashJoinBridge):

      per key k:  S(k) = {y}
        S(k) has a NULL      -> row drops (x NOT IN (..., NULL) never TRUE)
        S(k) empty (no group)-> row keeps
        x IS NULL, S nonempty-> row drops
        else                 -> plain compound-key ANTI join on (x, k)

    Lowered to: LEFT join per-key (rows, nulls) counts; rows with no group
    keep outright; surviving rows take a plain ANTI join (NULLs all
    resolved above); the two branches UNION ALL."""
    if any(e[0] == "pred" for e in entries):
        raise NotImplementedError(
            "correlated NOT IN supports equality correlations only"
        )
    eqs = [(e[1], e[2]) for e in entries if e[0] == "eq"]
    inner_keys = [i for _, i in eqs]
    outer_keys = [scope.resolve(o) or o for o, _ in eqs]
    val = next(n for n in sub.schema.names if n not in set(inner_keys))
    cnt, nnul = "__nin_c", "__nin_n"
    counts = PlanBuilder(sub.node).aggregation(
        inner_keys,
        [
            f"count(*) as {cnt}",
            f"count_if({val} is null) as {nnul}",
        ],
    )
    out_names = list(plan.schema.names)
    joined = plan.hash_join(
        counts,
        outer_keys,
        inner_keys,
        output=out_names + [cnt, nnul],
        join_type="left",
    )
    keep = (
        PlanBuilder(joined.node)
        .filter(f"{cnt} is null")
        .project(out_names)
    )
    rest = (
        PlanBuilder(joined.node)
        .filter(
            f"{cnt} is not null and {nnul} = 0 and {lhs_name} is not null"
        )
        .project(out_names)
        .hash_join(
            PlanBuilder(sub.node).filter(f"{val} is not null").build(),
            [lhs_name] + outer_keys,
            [val] + inner_keys,
            output=out_names,
            join_type="anti",
        )
    )
    return PlanBuilder().union_all([keep.build(), rest.build()])


_SCALAR_SUB_AGGS = (
    "min", "max", "sum", "count", "avg", "arbitrary", "count_if",
    "stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop",
    "geometric_mean", "bool_and", "bool_or", "every",
)


def _strip_leading_aggregate(sub_toks):
    """If ``sub_toks`` is 'SELECT agg(expr) FROM ...' with a single
    aggregate item, return (agg fn name, rewritten tokens whose select list
    is 'expr as __sq_v, *') — the raw-rows form the non-equality
    decorrelation aggregates per outer row.  None when the shape doesn't
    match (multiple items, DISTINCT, GROUP BY, non-aggregate item)."""
    toks = list(sub_toks)
    if not toks or toks[0].low != "select":
        return None
    depth = 0
    from_i = None
    for i, t in enumerate(toks):
        if t.kind == "op" and t.text == "(":
            depth += 1
        elif t.kind == "op" and t.text == ")":
            depth -= 1
        elif (
            depth == 0 and t.kind == "name" and t.low == "from" and i > 0
        ):
            from_i = i
            break
    if from_i is None:
        return None
    d = 0
    for t in toks[from_i:]:
        if t.kind == "op" and t.text == "(":
            d += 1
        elif t.kind == "op" and t.text == ")":
            d -= 1
        elif d == 0 and t.kind == "name" and t.low == "group":
            return None  # subquery has its own GROUP BY
    items = toks[1:from_i]
    # single item only (no depth-0 commas)
    d = 0
    for t in items:
        if t.kind == "op" and t.text == "(":
            d += 1
        elif t.kind == "op" and t.text == ")":
            d -= 1
        elif d == 0 and t.kind == "op" and t.text == ",":
            return None
    if (
        len(items) < 3
        or items[0].kind != "name"
        or items[0].low not in _SCALAR_SUB_AGGS
        or items[1].text != "("
        or items[-1].text != ")"
    ):
        return None
    fn = items[0].low
    inner = items[2:-1]
    if inner and inner[0].kind == "name" and inner[0].low == "distinct":
        return None
    if fn == "count" and (
        not inner or (len(inner) == 1 and inner[0].text == "*")
    ):
        value_toks = [_Tok("number", "1")]
    else:
        value_toks = list(inner)
    new_toks = (
        [toks[0]]
        + value_toks
        + [_Tok("name", "as"), _Tok("name", "__sq_v"), _Tok("op", ","),
           _Tok("op", "*")]
        + toks[from_i:]
    )
    return fn, new_toks


def _attach_scalar_subquery_nonequi(
    plan: PlanBuilder, ph: str, sub_toks, catalog, scope, fn, new_toks
) -> PlanBuilder:
    """Correlated scalar aggregate with NON-equality correlations
    (e.g. o.v > (select avg(i.x) from i where i.d < o.d)): general
    decorrelation over raw rows —

      1. tag every outer row with a unique id (AssignUniqueIdNode);
      2. LEFT-join the UN-aggregated subquery rows (value + correlation
         columns) on the equality keys with the non-equality predicates as
         the join filter (nested-loop when no equality keys exist);
      3. aggregate the original function per outer-row id — exact for ANY
         aggregate, because the aggregation runs once over each outer
         row's true row set;
      4. join the (id, value) pairs back onto the outer plan.

    Reference analog: Velox has no SQL planner; engines above it lower this
    shape to the same join+group-by plan (dedup/magic-set decorrelation)."""
    sub, entries = _plan_subquery(new_toks, catalog, scope, True)
    eqs = [(e[1], e[2]) for e in entries if e[0] == "eq"]
    preds = [e for e in entries if e[0] == "pred"]
    out_names = list(plan.schema.names)
    rid = _unique_name("__sq_rid", set(out_names))
    plan.assign_unique_id(rid)

    # collision renames + filter text over probe ++ build columns (same
    # mechanics as the EXISTS branch above)
    used = set(plan.schema.names) | set(sub.schema.names)
    renames: Dict[str, str] = {}
    for n in sub.schema.names:
        if n in plan.schema.names:
            renames[n] = _unique_name(f"__sq_{n}", used)
            used.add(renames[n])
    if renames:
        sub.project(
            [
                f"{n} as {renames[n]}" if n in renames else n
                for n in sub.schema.names
            ]
        )
    vcol = renames.get("__sq_v", "__sq_v")
    parts_all: List[str] = []
    for _, ptoks, _refs in preds:
        parts = []
        for t in ptoks:
            if t.kind == "name" and t.text.startswith("__outer__"):
                parts.append(t.text[len("__outer__"):])
            elif t.kind == "name" and t.text in renames:
                parts.append(renames[t.text])
            else:
                parts.append(t.text)
        parts_all.append("( " + " ".join(parts) + " )")
    filter_text = " and ".join(parts_all)

    join_out = [rid, vcol]
    if eqs:
        joined = PlanBuilder(plan.node).hash_join(
            sub,
            [scope.resolve(o) or o for o, _ in eqs],
            [renames.get(i, i) for _, i in eqs],
            output=join_out,
            join_type="left",
            filter=filter_text,
        )
    else:
        joined = PlanBuilder(plan.node).nested_loop_join(
            sub, output=join_out, join_type="left", condition=filter_text
        )
    aggp = joined.aggregation([rid], [f"{fn}({vcol}) as {ph}"])
    plan.hash_join(
        aggp, [rid], [rid], output=out_names + [ph], join_type="left"
    )
    return plan


def _attach_scalar_subquery(
    plan: PlanBuilder, ph: str, sub_toks, catalog, scope
) -> PlanBuilder:
    """Join one scalar subquery's value onto ``plan`` as column ``ph``
    (used by WHERE/HAVING comparisons and the SELECT list alike)."""
    sub, entries = _plan_subquery(sub_toks, catalog, scope, True)
    eqs = [(e[1], e[2]) for e in entries if e[0] == "eq"]
    if any(e[0] == "pred" for e in entries):
        stripped = _strip_leading_aggregate(sub_toks)
        if stripped is None:
            raise NotImplementedError(
                "correlated scalar subqueries with non-equality "
                "correlations must be a single plain aggregate "
                "(no DISTINCT / GROUP BY / multiple items)"
            )
        fn, new_toks = stripped
        return _attach_scalar_subquery_nonequi(
            plan, ph, sub_toks, catalog, scope, fn, new_toks
        )
    if not eqs:
        if len(sub.schema.names) != 1:
            raise ValueError("scalar subquery must produce one column")
        sub.enforce_single_row()
        sub.project([f"{sub.schema.names[0]} as {ph}"])
        plan.cross_join(sub, output=list(plan.schema.names) + [ph])
    else:
        # correlated scalar (Q17/Q20 shape): the subquery aggregated
        # grouped by its correlation columns (decorrelation in _assemble),
        # so each key yields exactly one row; LEFT join on the keys makes
        # a missing group a NULL scalar
        inner_keys = [i for _, i in eqs]
        value_cols = [
            n for n in sub.schema.names if n not in set(inner_keys)
        ]
        if len(value_cols) != 1:
            raise ValueError("scalar subquery must produce one column")
        if not _has_aggregation(sub.node):
            raise NotImplementedError(
                "correlated scalar subqueries must be aggregates "
                "(one value per correlation key)"
            )
        sub.project([f"{value_cols[0]} as {ph}"] + inner_keys)
        plan.hash_join(
            sub,
            [scope.resolve(o) or o for o, _ in eqs],
            inner_keys,
            output=list(plan.schema.names) + [ph],
            join_type="left",
        )
    return plan


def _assemble(
    sources, joins, where_toks, select_items, distinct,
    group_items, having_toks, order_items, limit, offset,
    catalog, outer_scope=None, correlated_out=None,
) -> PlanBuilder:
    sources, scope = _rename_collisions(sources)
    # fold explicit-join sources into the scope (for SELECT/ON resolution)
    joins2 = []
    used = set()
    for _, pb in sources:
        used.update(pb.schema.names)
    for jt, alias, rb, cond in joins:
        names = list(rb.schema.names)
        renames = {n: f"{alias}__{n}" for n in names if n in used}
        if renames:
            rb = PlanBuilder(rb.node).project(
                [f"{n} as {renames[n]}" if n in renames else n for n in names]
            )
        final = [renames.get(n, n) for n in names]
        used.update(final)
        scope.add(None, final)
        for n in renames:
            scope.ambiguous.add(n.lower())
        if alias:
            for orig, internal in zip(names, final):
                scope.map[f"{alias.lower()}.{orig.lower()}"] = internal
        joins2.append((jt, alias, rb, cond))

    raw_conjs = _split_conjuncts(where_toks) if where_toks else []
    plain, sub_ops = _extract_subquery_ops(raw_conjs)
    plain = [scope.rewrite(c) for c in plain]
    correlations: List[Tuple[str, str]] = []  # inner cols needed in output
    if outer_scope is not None:
        local_cols = set()
        for _, pb in sources:
            local_cols.update(pb.schema.names)
        for jt_, _, rb_, _ in joins2:
            local_cols.update(rb_.schema.names)
        kept = []
        for c in plain:
            outer_pos = [
                i for i, t in enumerate(c)
                if t.kind == "name"
                and t.text not in local_cols
                and outer_scope.resolve(t.text) is not None
            ]
            if not outer_pos:
                kept.append(c)
                continue
            if correlated_out is None:
                raise ValueError(f"cannot resolve column(s) in {_detok(c)!r}")
            if _is_equality(c) is not None and len(outer_pos) == 1:
                outer_tok = c[outer_pos[0]]
                inner_tok = c[2] if outer_pos[0] == 0 else c[0]
                if inner_tok.text in local_cols:
                    correlated_out.append(
                        (
                            "eq",
                            outer_scope.resolve(outer_tok.text),
                            inner_tok.text,
                        )
                    )
                    correlations.append(inner_tok.text)
                    continue
            # non-equality correlated predicate (the Q21 shape): it becomes
            # the enclosing semi/anti join's non-equi FILTER.  Rewrite outer
            # refs to their resolved names; inner refs resolve locally and
            # must survive the subquery projection.
            pred_toks: List[_Tok] = []
            inner_refs: List[str] = []
            outer_set = set(outer_pos)
            for i, t in enumerate(c):
                if i in outer_set:
                    # the __outer__ marker disambiguates colliding inner /
                    # outer spellings (the Q21 shape: l2.col <> l1.col)
                    pred_toks.append(
                        _Tok("name", "__outer__" + outer_scope.resolve(t.text))
                    )
                elif t.kind == "name" and t.text not in _CLAUSE_KW:
                    nm = scope.resolve(t.text) or t.text
                    if nm in local_cols and nm not in inner_refs:
                        inner_refs.append(nm)
                    pred_toks.append(_Tok("name", nm))
                else:
                    pred_toks.append(t)
            correlated_out.append(("pred", pred_toks, inner_refs))
            for nm in inner_refs:
                correlations.append(nm)
        plain = kept
    plan, leftovers = _join_sources(sources, joins2, plain, scope)
    for c in leftovers:
        plan.filter(_detok(c))
    if sub_ops:
        plan = _apply_subquery_ops(plan, sub_ops, catalog, scope)

    # ---- star expansion + name rewriting --------------------------------
    items: List[Tuple[List[_Tok], Optional[str]]] = []
    for toks, alias in select_items:
        if len(toks) == 1 and toks[0].kind == "op" and toks[0].text == "*":
            for n in plan.schema.names:
                items.append(([_Tok("name", n)], None))
            continue
        if (
            len(toks) == 1
            and toks[0].kind == "name"
            and toks[0].text.endswith(".*")
        ):
            prefix = toks[0].low[:-2] + "."
            cols = [
                v for k, v in scope.map.items() if k.startswith(prefix)
            ]
            seen = set()
            for n in cols:
                if n not in seen:
                    seen.add(n)
                    items.append(([_Tok("name", n)], None))
            continue
        items.append((scope.rewrite(toks), alias))

    # scalar subqueries in the SELECT list: join each value in as a hidden
    # column (same machinery as WHERE/HAVING scalar comparisons) and leave a
    # placeholder reference in the item
    n_ssq = 0
    new_items: List[Tuple[List[_Tok], Optional[str]]] = []
    for toks, alias in items:
        while True:
            sq = _find_subquery(toks)
            if sq is None:
                break
            open_i, close_i = sq
            ph = f"__ssq{n_ssq}"
            n_ssq += 1
            plan = _attach_scalar_subquery(
                plan, ph, toks[open_i + 1 : close_i], catalog, scope
            )
            toks = toks[:open_i] + [_Tok("name", ph)] + toks[close_i + 1 :]
        new_items.append((toks, alias))
    items = new_items

    group_items = [scope.rewrite(g) for g in group_items]
    having_toks = scope.rewrite(having_toks) if having_toks else []
    order_parsed = [_parse_order_item(o, scope) for o in order_items]

    # GROUP BY position / expression handling
    gk_exprs: List[Tuple[str, List[_Tok]]] = []  # (key name, expr tokens)
    keys: List[str] = []
    set_lists: Optional[List[List[str]]] = None  # GROUPING SETS/ROLLUP/CUBE
    for gi, g in enumerate(group_items):
        if g and g[0].kind == "name" and (
            g[0].low in ("rollup", "cube")
            or (g[0].low == "grouping" and len(g) > 1 and g[1].low == "sets")
        ):
            parsed_sets = _parse_grouping_construct(g, plan.schema)
            if set_lists is None:
                set_lists = parsed_sets
            else:
                # multiple grouping constructs in one GROUP BY: standard SQL
                # semantics is the CROSS PRODUCT of their set lists
                # (reference: Presto's GROUP BY ROLLUP(a), CUBE(b))
                set_lists = [
                    a + [k for k in b if k not in a]
                    for a in set_lists
                    for b in parsed_sets
                ]
            continue
        if len(g) == 1 and g[0].kind == "number":
            g = items[int(g[0].text) - 1][0]
        if len(g) == 1 and g[0].kind == "name" and g[0].text in plan.schema:
            keys.append(g[0].text)
            continue
        if (
            len(g) == 1
            and g[0].kind == "name"
            and g[0].text not in plan.schema
        ):
            # GROUP BY a select-list alias (standard SQL scoping: the alias
            # is visible in GROUP BY): substitute the aliased expression
            for toks, alias in items:
                if alias is not None and alias.lower() == g[0].low:
                    g = toks
                    break
            if len(g) == 1 and g[0].kind == "name" and g[0].text in plan.schema:
                keys.append(g[0].text)
                continue
        name = f"__gk{gi}"
        gk_exprs.append((name, g))
        keys.append(name)

    # aggregates extract FIRST (windowed aggregate calls are skipped), then
    # windows: SQL evaluates window functions over the grouped/aggregated
    # rows, so their args/specs may reference grouping keys and extracted
    # __aggN columns
    # HAVING may carry scalar subqueries (TPC-H Q11: sum(v) > (select ...));
    # extract them BEFORE aggregate extraction so inner aggregates stay in
    # their subquery, and apply them after the aggregation
    having_ops: List[tuple] = []
    if having_toks:
        hp, having_ops = _extract_subquery_ops(
            _split_conjuncts(having_toks), prefix="__hq"
        )
        having_toks = []
        for ci, c in enumerate(hp):
            if ci:
                having_toks.append(_Tok("name", "and"))
            having_toks += [_Tok("op", "(")] + c + [_Tok("op", ")")]

    ex = _AggExtractor()
    items = [(ex.extract(toks), alias) for toks, alias in items]
    having_x = ex.extract(having_toks) if having_toks else []
    having_ops = [
        ("scalar", ex.extract(op[1]), op[2]) if op[0] == "scalar" else op
        for op in having_ops
    ]
    order_parsed = [
        (ex.extract(toks), asc, nf) for toks, asc, nf in order_parsed
    ]

    wex = _WinExtractor(scope)
    items = [(wex.extract(toks), alias) for toks, alias in items]
    order_x = [
        (wex.extract(toks), asc, nf) for toks, asc, nf in order_parsed
    ]

    aggregated = bool(group_items) or ex.found
    if aggregated and correlations:
        # decorrelation: an aggregated correlated subquery groups by its
        # correlation columns (select avg(x) where k = outer.k -> avg per k,
        # joined back on k by the enclosing EXISTS/IN/scalar op)
        for c in correlations:
            if c not in keys:
                keys.append(c)
    if aggregated:
        if gk_exprs:
            base_cols = list(plan.schema.names)
            plan.project(
                base_cols + [f"{_detok(e)} as {n}" for n, e in gk_exprs]
            )
            # replace group-expr occurrences in select/having/order
            for n, e in gk_exprs:
                items = [(_subst(t, e, n), a) for t, a in items]
                having_x = _subst(having_x, e, n)
                order_x = [
                    (_subst(t, e, n), asc, nf) for t, asc, nf in order_x
                ]
        if set_lists is not None:
            # GROUPING SETS: replicate input per set with a group-id column
            # (reference: core::GroupIdNode + exec/GroupId.cpp), then group by
            # every key + the group id; keys outside a set aggregate as NULL
            grouping_sets = [list(keys) + s for s in set_lists]
            union_keys = list(keys)
            for s in set_lists:
                for k in s:
                    if k not in union_keys:
                        union_keys.append(k)
            ref_cols: List[str] = []
            for call in ex.calls:
                for tk in _tokenize(call):
                    if (
                        tk.kind == "name"
                        and tk.text in plan.schema
                        and tk.text not in union_keys
                        and tk.text not in ref_cols
                    ):
                        ref_cols.append(tk.text)
            gid = "__grouping_id"
            plan.group_id(grouping_sets, ref_cols, name=gid)
            keys = union_keys + [gid]
        plan.aggregation(
            keys,
            [f"{call} as {out}" for call, out in zip(ex.calls, ex.outs)],
        )
        if set_lists is not None:
            # restore NULL-ness of out-of-set keys from the group id (the
            # GroupId executor zeroed their values so grouping is by the
            # in-set keys only)
            restore: List[str] = []
            for col in plan.schema.names:
                ids = [
                    i
                    for i, s in enumerate(grouping_sets)
                    if col != gid and col in union_keys and col in s
                ]
                if col in union_keys and len(ids) < len(grouping_sets):
                    pred = " or ".join(f"{gid} = {i}" for i in ids)
                    restore.append(
                        f"case when {pred} then {col} else null end as {col}"
                    )
                else:
                    restore.append(col)
            plan.project(restore)
        if having_x:
            plan.filter(_detok(having_x))
        if having_ops:
            if any(op[0] != "scalar" for op in having_ops):
                raise NotImplementedError(
                    "only scalar subqueries are supported in HAVING"
                )
            plan = _apply_subquery_ops(plan, having_ops, catalog, scope)
    elif having_ops:
        raise ValueError("HAVING requires GROUP BY or aggregates")

    if wex.found:
        # windows run over the (possibly aggregated) rows, before the final
        # projection that consumes their __winN outputs
        for part, order, calls in wex.windows:
            plan.window(part, order, [f"{c} as {n}" for c, n in calls])

    # ---- final projection -------------------------------------------------
    out_names: List[str] = []
    proj: List[str] = []
    used_names: set = set()
    for i, (toks, alias) in enumerate(items):
        if alias:
            name = alias
        elif len(toks) == 1 and toks[0].kind == "name":
            name = toks[0].text.split(".")[-1]
            if name.startswith("__agg"):
                name = f"_col{i}"
        else:
            name = f"_col{i}"
        name = _unique_name(name, used_names)
        used_names.add(name)
        out_names.append(name)
        proj.append(f"{_detok(toks)} as {name}")
    # correlated-subquery join keys must survive the projection (the enclosing
    # EXISTS joins on them; the outputs themselves are discarded)
    for col in correlations:
        if col not in used_names:
            used_names.add(col)
            out_names.append(col)
            proj.append(col)

    # ORDER BY keys: map to output columns; non-trivial exprs become hidden
    sort_specs: List[str] = []
    hidden: List[str] = []
    for oi, (toks, asc, nf) in enumerate(order_x):
        if len(toks) == 1 and toks[0].kind == "number":
            key = out_names[int(toks[0].text) - 1]
        elif (
            len(toks) == 1
            and toks[0].kind == "name"
            and toks[0].text in out_names
        ):
            key = toks[0].text  # select-list alias
        else:
            text = _detok(toks)
            key = None
            for nm, (itoks, _) in zip(out_names, items):
                if _detok(itoks) == text:
                    key = nm
                    break
            if key is None and len(toks) == 1 and toks[0].kind == "name":
                # a bare column not in the select list: carry it hidden
                key = f"__ok{oi}"
                hidden.append(f"{toks[0].text} as {key}")
            elif key is None:
                key = f"__ok{oi}"
                hidden.append(f"{text} as {key}")
        sort_specs.append(
            key
            + ("" if asc else " desc")
            + (" nulls first" if nf else "")
        )
    plan.project(proj + hidden)

    if distinct:
        if hidden:
            raise NotImplementedError(
                "SELECT DISTINCT with ORDER BY expressions outside the "
                "select list is not supported"
            )
        plan.aggregation(out_names, ["count(*) as __d"])
        plan.project(out_names)

    if sort_specs:
        if limit is not None and not offset:
            plan.topn(sort_specs, limit)
        else:
            plan.orderby(sort_specs)
            if limit is not None or offset:
                plan.limit(
                    limit if limit is not None else (1 << 62), offset or 0
                )
        if hidden:
            plan.project(out_names)
    elif limit is not None or offset:
        plan.limit(limit if limit is not None else (1 << 62), offset or 0)

    return plan


def _parse_grouping_construct(g: List[_Tok], schema) -> List[List[str]]:
    """GROUPING SETS ((a,b),(a),()) / ROLLUP(a,b) / CUBE(a,b) -> list of
    key-name lists (reference: core::GroupIdNode lowering, exec/GroupId.cpp).
    Members must be plain columns of the current plan schema."""

    def col_of(toks: List[_Tok]) -> str:
        if len(toks) == 1 and toks[0].kind == "name" and toks[0].text in schema:
            return toks[0].text
        raise NotImplementedError(
            f"grouping-set member {_detok(toks)!r} must be a plain column"
        )

    head = g[0].low
    if head in ("rollup", "cube"):
        if len(g) < 3 or g[1].text != "(" or g[-1].text != ")":
            raise ValueError(f"malformed {head.upper()} clause: {_detok(g)!r}")
        cols = [col_of(e) for e in _split_top_level(g[2:-1], ",")]
        if head == "rollup":
            return [cols[:i] for i in range(len(cols), -1, -1)]
        out: List[List[str]] = []
        for mask in range((1 << len(cols)) - 1, -1, -1):
            out.append([c for i, c in enumerate(cols) if mask & (1 << i)])
        return out
    # GROUPING SETS ( set [, set ...] ); a set is (a, b), (a), () or bare a
    if len(g) < 4 or g[1].low != "sets" or g[2].text != "(" or g[-1].text != ")":
        raise ValueError(f"malformed GROUPING SETS clause: {_detok(g)!r}")
    sets: List[List[str]] = []
    for el in _split_top_level(g[3:-1], ","):
        if el and el[0].kind == "op" and el[0].text == "(":
            inner = el[1:-1]
            sets.append(
                [col_of(e) for e in _split_top_level(inner, ",")]
                if inner
                else []
            )
        else:
            sets.append([col_of(el)])
    return sets


def _parse_order_item(tokens: List[_Tok], scope: _Scope):
    asc = True
    nulls_first = False
    toks = list(tokens)
    if toks and toks[-2:] and [t.low for t in toks[-2:]] == ["nulls", "first"]:
        nulls_first = True
        toks = toks[:-2]
    elif toks and [t.low for t in toks[-2:]] == ["nulls", "last"]:
        toks = toks[:-2]
    if toks and toks[-1].kind == "name" and toks[-1].low in ("asc", "desc"):
        asc = toks[-1].low == "asc"
        toks = toks[:-1]
    return scope.rewrite(toks), asc, nulls_first


# ---------------------------------------------------------------------------
# public API


def plan_sql(sql: str, catalog: Dict[str, Table]):
    """Parse a SQL SELECT statement into a PlanNode over catalog tables."""
    parser = _Parser(_tokenize(sql), catalog)
    pb = parser.parse_select()
    if parser.peek() is not None:
        raise ValueError(f"trailing tokens after query: {parser.peek().text!r}")
    return pb.build()


def run_sql(
    sql: str,
    catalog: Dict[str, Table],
    tile_rows: Optional[int] = None,
    device=None,
) -> Table:
    """Plan and execute a SQL SELECT on ``device`` (None: the CUDA device,
    which raises without one); returns the result Table."""
    from ..exec.runner import LocalExecutor

    plan = plan_sql(sql, catalog)
    if tile_rows is not None:
        return LocalExecutor(plan, tile_rows=tile_rows, device=device).run()
    return LocalExecutor(plan, device=device).run()
