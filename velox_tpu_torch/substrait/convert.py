"""Substrait plan conversion (protobuf-JSON message shapes).

Counterpart of the JAX package's ``substrait/convert.py``: the same plan
gives the same JSON (the ``producer`` names the engine, which both packages
are), with one difference.  PlanBuilder binds a VARCHAR literal compared
with a column to the code of the column's dictionary; the JAX package writes
that code as the literal's string, and this package writes the string the
code stands for, and binds the literals of a plan it reads against the
dictionaries of its catalog's tables, as PlanBuilder does — so a plan with
string literals runs the same after a round trip.  Reference:
velox/substrait/{SubstraitToVeloxPlan,VeloxToSubstraitPlan,
SubstraitToVeloxExpr,TypeUtils}.cpp.  Function names map to Substrait's
canonical extension names (add/subtract/equal/...), declared once in the
plan's ``extensions`` block and referenced by anchor, as the reference emits
them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..dtypes import (
    BIGINT,
    BOOLEAN,
    DataType,
    RowType,
    TypeKind,
    decimal as decimal_t,
)
from ..expr.ir import (
    Call,
    Constant,
    Expr,
    FieldAccess,
    Special,
    SpecialForm,
)
from ..io.table import Table
from ..plan.nodes import (
    AggregationNode,
    AggregationStep,
    FilterNode,
    HashJoinNode,
    JoinType,
    LimitNode,
    OrderByNode,
    PlanNode,
    ProjectNode,
    SortKey,
    TableScanNode,
    TopNNode,
    ValuesNode,
)

SUBSTRAIT_URI = "https://github.com/substrait-io/substrait/blob/main/extensions/"

# our scalar name -> substrait canonical name
_TO_SUBSTRAIT_FN = {
    "plus": "add",
    "minus": "subtract",
    "multiply": "multiply",
    "divide": "divide",
    "mod": "modulus",
    "negate": "negate",
    "eq": "equal",
    "neq": "not_equal",
    "lt": "lt",
    "lte": "lte",
    "gt": "gt",
    "gte": "gte",
    "not": "not",
    "and": "and",
    "or": "or",
    "between": "between",
    "is_null": "is_null",
    "is_not_null": "is_not_null",
    "like": "like",
    "length": "char_length",
    "lower": "lower",
    "upper": "upper",
    "concat": "concat",
    "substr": "substring",
    "abs": "abs",
    "round": "round",
    "floor": "floor",
    "ceil": "ceil",
    "year": "extract",
    "sum": "sum",
    "min": "min",
    "max": "max",
    "avg": "avg",
    "count": "count",
}
_FROM_SUBSTRAIT_FN = {v: k for k, v in _TO_SUBSTRAIT_FN.items()}
_FROM_SUBSTRAIT_FN.update({"char_length": "length", "substring": "substr"})

_JOIN_TO_SUBSTRAIT = {
    JoinType.INNER: "JOIN_TYPE_INNER",
    JoinType.LEFT: "JOIN_TYPE_LEFT",
    JoinType.RIGHT: "JOIN_TYPE_RIGHT",
    JoinType.FULL: "JOIN_TYPE_OUTER",
    JoinType.LEFT_SEMI: "JOIN_TYPE_LEFT_SEMI",
    JoinType.RIGHT_SEMI: "JOIN_TYPE_RIGHT_SEMI",
    JoinType.ANTI: "JOIN_TYPE_LEFT_ANTI",
}
_JOIN_FROM_SUBSTRAIT = {v: k for k, v in _JOIN_TO_SUBSTRAIT.items()}


def _type_to_substrait(t: DataType, nullable: bool = True) -> Dict[str, Any]:
    n = {
        "nullability": "NULLABILITY_NULLABLE"
        if nullable
        else "NULLABILITY_REQUIRED"
    }
    k = t.kind
    if k == TypeKind.BOOLEAN:
        return {"bool": n}
    if k == TypeKind.TINYINT:
        return {"i8": n}
    if k == TypeKind.SMALLINT:
        return {"i16": n}
    if k == TypeKind.INTEGER:
        return {"i32": n}
    if k == TypeKind.BIGINT:
        return {"i64": n}
    if k == TypeKind.REAL:
        return {"fp32": n}
    if k == TypeKind.DOUBLE:
        return {"fp64": n}
    if k in (TypeKind.VARCHAR,):
        return {"string": n}
    if k == TypeKind.VARBINARY:
        return {"binary": n}
    if k == TypeKind.DATE:
        return {"date": n}
    if k == TypeKind.TIMESTAMP:
        return {"timestamp": n}
    if k == TypeKind.DECIMAL:
        return {"decimal": {**n, "precision": t.precision, "scale": t.scale}}
    if k == TypeKind.ARRAY:
        return {"list": {**n, "type": _type_to_substrait(t.element)}}
    if k == TypeKind.MAP:
        return {
            "map": {
                **n,
                "key": _type_to_substrait(t.key_type),
                "value": _type_to_substrait(t.value_type),
            }
        }
    raise TypeError(f"cannot convert {t} to substrait")


def _type_from_substrait(obj: Dict[str, Any]) -> DataType:
    (kind, body), = obj.items()
    simple = {
        "bool": TypeKind.BOOLEAN,
        "i8": TypeKind.TINYINT,
        "i16": TypeKind.SMALLINT,
        "i32": TypeKind.INTEGER,
        "i64": TypeKind.BIGINT,
        "fp32": TypeKind.REAL,
        "fp64": TypeKind.DOUBLE,
        "string": TypeKind.VARCHAR,
        "varchar": TypeKind.VARCHAR,
        "fixedchar": TypeKind.VARCHAR,
        "binary": TypeKind.VARBINARY,
        "date": TypeKind.DATE,
        "timestamp": TypeKind.TIMESTAMP,
        "timestampTz": TypeKind.TIMESTAMP,
    }
    if kind in simple:
        return DataType(simple[kind])
    if kind == "decimal":
        return decimal_t(body.get("precision", 18), body.get("scale", 0))
    if kind == "list":
        from ..dtypes import array as array_t

        return array_t(_type_from_substrait(body["type"]))
    if kind == "map":
        from ..dtypes import map_ as map_t

        return map_t(
            _type_from_substrait(body["key"]), _type_from_substrait(body["value"])
        )
    raise TypeError(f"cannot convert substrait type {kind!r}")


class _FnRegistry:
    """Extension-function anchors for one plan (reference: the reference
    collects function references the same way in VeloxToSubstraitPlan)."""

    def __init__(self):
        self.anchors: Dict[str, int] = {}

    def anchor(self, name: str) -> int:
        if name not in self.anchors:
            self.anchors[name] = len(self.anchors)
        return self.anchors[name]

    def extensions_block(self):
        return [
            {
                "extensionFunction": {
                    "extensionUriReference": 1,
                    "functionAnchor": a,
                    "name": n,
                }
            }
            for n, a in self.anchors.items()
        ]


# ---------------------------------------------------------------------------
# expressions


def _expr_to_substrait(e: Expr, schema: RowType, fns: _FnRegistry) -> Dict:
    if isinstance(e, FieldAccess):
        return {
            "selection": {
                "directReference": {
                    "structField": {"field": schema.index_of(e.name)}
                },
                "rootReference": {},
            }
        }
    if isinstance(e, Constant):
        return {"literal": _literal_to_substrait(e)}
    if isinstance(e, Special):
        if e.form in (SpecialForm.AND, SpecialForm.OR):
            name = "and" if e.form == SpecialForm.AND else "or"
            return _scalar_fn(
                name, BOOLEAN, [_expr_to_substrait(a, schema, fns) for a in e.args], fns
            )
        if e.form in (SpecialForm.CAST, SpecialForm.TRY_CAST):
            behavior = (
                "FAILURE_BEHAVIOR_THROW_EXCEPTION"
                if e.form == SpecialForm.CAST
                else "FAILURE_BEHAVIOR_RETURN_NULL"
            )
            return {
                "cast": {
                    "type": _type_to_substrait(e.dtype),
                    "input": _expr_to_substrait(e.args[0], schema, fns),
                    "failureBehavior": behavior,
                }
            }
        if e.form in (SpecialForm.IF, SpecialForm.SWITCH):
            args = list(e.args)
            has_else = len(args) % 2 == 1
            else_e = args.pop() if has_else else None
            ifs = [
                {
                    "if": _expr_to_substrait(c, schema, fns),
                    "then": _expr_to_substrait(v, schema, fns),
                }
                for c, v in zip(args[0::2], args[1::2])
            ]
            out = {"ifThen": {"ifs": ifs}}
            if else_e is not None:
                out["ifThen"]["else"] = _expr_to_substrait(else_e, schema, fns)
            return out
        if e.form == SpecialForm.IN:
            return {
                "singularOrList": {
                    "value": _expr_to_substrait(e.args[0], schema, fns),
                    "options": [
                        _expr_to_substrait(a, schema, fns) for a in e.args[1:]
                    ],
                }
            }
        if e.form == SpecialForm.COALESCE:
            return _scalar_fn(
                "coalesce",
                e.dtype,
                [_expr_to_substrait(a, schema, fns) for a in e.args],
                fns,
            )
        raise TypeError(f"cannot convert special form {e.form} to substrait")
    if isinstance(e, Call):
        name = _TO_SUBSTRAIT_FN.get(e.name, e.name)
        return _scalar_fn(
            name,
            e.dtype,
            [_expr_to_substrait(a, schema, fns) for a in e.args],
            fns,
        )
    raise TypeError(f"cannot convert {type(e).__name__} to substrait")


def _scalar_fn(name: str, dtype: DataType, args: List[Dict], fns: _FnRegistry):
    return {
        "scalarFunction": {
            "functionReference": fns.anchor(name),
            "outputType": _type_to_substrait(dtype),
            "arguments": [{"value": a} for a in args],
        }
    }


def _literal_to_substrait(e: Constant) -> Dict[str, Any]:
    if e.value is None:
        return {"null": _type_to_substrait(e.dtype)}
    k = e.dtype.kind
    v = e.value
    if k == TypeKind.BOOLEAN:
        return {"boolean": bool(v)}
    if k == TypeKind.TINYINT:
        return {"i8": int(v)}
    if k == TypeKind.SMALLINT:
        return {"i16": int(v)}
    if k == TypeKind.INTEGER:
        return {"i32": int(v)}
    if k == TypeKind.BIGINT:
        return {"i64": str(int(v))}  # proto JSON renders int64 as string
    if k == TypeKind.REAL:
        return {"fp32": float(v)}
    if k == TypeKind.DOUBLE:
        return {"fp64": float(v)}
    if k == TypeKind.VARCHAR:
        return {"string": str(v)}
    if k == TypeKind.DATE:
        return {"date": int(v)}
    if k == TypeKind.TIMESTAMP:
        return {"timestamp": str(int(v))}
    if k == TypeKind.DECIMAL:
        import base64

        raw = int(v).to_bytes(16, "little", signed=True)
        return {
            "decimal": {
                "value": base64.b64encode(raw).decode(),
                "precision": e.dtype.precision,
                "scale": e.dtype.scale,
            }
        }
    raise TypeError(f"cannot convert literal of {e.dtype}")


def _literal_from_substrait(obj: Dict[str, Any]) -> Constant:
    (kind, v), = ((k, x) for k, x in obj.items() if k != "nullable")
    if kind == "null":
        return Constant(_type_from_substrait(v), None)
    table = {
        "boolean": (TypeKind.BOOLEAN, bool),
        "i8": (TypeKind.TINYINT, int),
        "i16": (TypeKind.SMALLINT, int),
        "i32": (TypeKind.INTEGER, int),
        "i64": (TypeKind.BIGINT, int),
        "fp32": (TypeKind.REAL, float),
        "fp64": (TypeKind.DOUBLE, float),
        "string": (TypeKind.VARCHAR, str),
        "date": (TypeKind.DATE, int),
        "timestamp": (TypeKind.TIMESTAMP, int),
    }
    if kind in table:
        tk, conv = table[kind]
        return Constant(DataType(tk), conv(v))
    if kind == "decimal":
        import base64

        raw = base64.b64decode(v["value"])
        val = int.from_bytes(raw, "little", signed=True)
        return Constant(
            decimal_t(v.get("precision", 18), v.get("scale", 0)), val
        )
    raise TypeError(f"cannot convert substrait literal {kind!r}")


def _expr_from_substrait(
    obj: Dict[str, Any], schema: RowType, anchor_names: Dict[int, str]
) -> Expr:
    from ..expr.registry import make_call
    from ..expr.ir import cast as cast_, in_ as in__

    if "selection" in obj:
        i = (
            obj["selection"]["directReference"]["structField"].get("field", 0)
        )
        return FieldAccess(schema.types[i], schema.names[i])
    if "literal" in obj:
        return _literal_from_substrait(obj["literal"])
    if "cast" in obj:
        body = obj["cast"]
        child = _expr_from_substrait(body["input"], schema, anchor_names)
        try_ = body.get("failureBehavior") == "FAILURE_BEHAVIOR_RETURN_NULL"
        return cast_(child, _type_from_substrait(body["type"]), try_=try_)
    if "ifThen" in obj:
        body = obj["ifThen"]
        args: List[Expr] = []
        for branch in body["ifs"]:
            args.append(_expr_from_substrait(branch["if"], schema, anchor_names))
            args.append(_expr_from_substrait(branch["then"], schema, anchor_names))
        if "else" in body:
            args.append(_expr_from_substrait(body["else"], schema, anchor_names))
        dtype = args[1].dtype
        return Special(dtype, SpecialForm.SWITCH, tuple(args))
    if "singularOrList" in obj:
        body = obj["singularOrList"]
        value = _expr_from_substrait(body["value"], schema, anchor_names)
        options = [
            _expr_from_substrait(o, schema, anchor_names)
            for o in body.get("options", [])
        ]
        return in__(value, options)
    if "scalarFunction" in obj:
        body = obj["scalarFunction"]
        raw = anchor_names[body.get("functionReference", 0)]
        name = raw.split(":", 1)[0]  # strip substrait signature suffix
        name = _FROM_SUBSTRAIT_FN.get(name, name)
        args = [
            _expr_from_substrait(a["value"], schema, anchor_names)
            for a in body.get("arguments", [])
        ]
        if name in ("and", "or"):
            form = SpecialForm.AND if name == "and" else SpecialForm.OR
            return Special(BOOLEAN, form, tuple(args))
        if name == "coalesce":
            return Special(args[0].dtype, SpecialForm.COALESCE, tuple(args))
        return make_call(name, args)
    raise TypeError(f"cannot convert substrait expression {list(obj)}")


# ---------------------------------------------------------------------------
# relations: ours -> substrait


def to_substrait(root: PlanNode) -> Dict[str, Any]:
    """Serialize a plan tree to a Substrait plan (protobuf-JSON shape)."""
    fns = _FnRegistry()
    rel = _rel_to_substrait(root, fns)
    return {
        "version": {"minorNumber": 29, "producer": "velox_tpu"},
        "extensionUris": [
            {"extensionUriAnchor": 1, "uri": SUBSTRAIT_URI}
        ],
        "extensions": fns.extensions_block(),
        "relations": [
            {
                "root": {
                    "input": rel,
                    "names": list(root.output_schema.names),
                }
            }
        ],
    }


def _written_strings(e: Expr, source: PlanNode) -> Expr:
    """``e`` with each VARCHAR literal that binding turned into a dictionary
    code written as the string it stands for, through the dictionary of the
    VARCHAR column of ``source`` that its call compares it with."""
    from ..exec.runner import resolve_column_strings

    args = getattr(e, "args", None)
    if not args:
        return e
    new = [_written_strings(a, source) for a in args]
    table = next(
        (t for a in new if isinstance(a, FieldAccess) and a.dtype.is_string
         for t in [resolve_column_strings(source, a.name)] if t is not None),
        None,
    )
    if table is not None:
        values = table.values()
        for i, a in enumerate(new):
            if (isinstance(a, Constant) and a.dtype.is_string
                    and not isinstance(a.value, (str, type(None)))):
                code = int(a.value)
                if 0 <= code < len(values):
                    text = values[code]
                else:
                    # a literal absent from the dictionary (binding kept no
                    # text): a string the dictionary lacks matches no row too
                    text = "\ufffd"
                    while table.lookup(text) is not None:
                        text += "\ufffd"
                new[i] = Constant(a.dtype, text)
    if all(x is y for x, y in zip(new, args)):
        return e
    return dataclasses.replace(e, args=tuple(new))


def _bound_strings(e: Expr, source: PlanNode) -> Expr:
    """``e`` with its VARCHAR literals bound to the dictionaries of
    ``source``'s columns (what PlanBuilder does to a parsed expression)."""
    from ..exec.runner import resolve_column_strings
    from ..expr.binding import bind_string_literals

    schema = source.output_schema
    tables = {}
    for name, dtype in zip(schema.names, schema.types):
        table = resolve_column_strings(source, name) if dtype.is_string else None
        if table is not None:
            tables[name] = table
    return bind_string_literals(e, tables)


def _rel_to_substrait(node: PlanNode, fns: _FnRegistry) -> Dict[str, Any]:
    if isinstance(node, (TableScanNode, ValuesNode)):
        schema = node.output_schema
        rel: Dict[str, Any] = {
            "read": {
                "baseSchema": {
                    "names": list(schema.names),
                    "struct": {
                        "types": [_type_to_substrait(t) for t in schema.types],
                        "nullability": "NULLABILITY_REQUIRED",
                    },
                },
                "namedTable": {"names": [getattr(node, "table_name", node.id)]},
            }
        }
        if isinstance(node, TableScanNode) and node.subfield_filter is not None:
            rel["read"]["filter"] = _expr_to_substrait(
                _written_strings(node.subfield_filter, node), schema, fns
            )
        return rel
    if isinstance(node, FilterNode):
        return {
            "filter": {
                "input": _rel_to_substrait(node.source, fns),
                "condition": _expr_to_substrait(
                    _written_strings(node.predicate, node.source),
                    node.source.output_schema,
                    fns,
                ),
            }
        }
    if isinstance(node, ProjectNode):
        in_schema = node.source.output_schema
        n_in = len(in_schema)
        return {
            "project": {
                "common": {
                    "emit": {
                        "outputMapping": [
                            n_in + i for i in range(len(node.exprs))
                        ]
                    }
                },
                "input": _rel_to_substrait(node.source, fns),
                "expressions": [
                    _expr_to_substrait(_written_strings(e, node.source), in_schema, fns)
                    for e in node.exprs
                ],
            }
        }
    if isinstance(node, AggregationNode):
        in_schema = node.source.output_schema
        groupings = [
            {
                "groupingExpressions": [
                    _expr_to_substrait(
                        FieldAccess(in_schema.type_of(k), k), in_schema, fns
                    )
                    for k in node.grouping_keys
                ]
            }
        ]
        measures = []
        for call in node.aggregates:
            name = _TO_SUBSTRAIT_FN.get(call.name, call.name)
            measures.append(
                {
                    "measure": {
                        "functionReference": fns.anchor(name),
                        "phase": "AGGREGATION_PHASE_INITIAL_TO_RESULT",
                        "outputType": _type_to_substrait(call.dtype),
                        "arguments": [
                            {"value": _expr_to_substrait(a, in_schema, fns)}
                            for a in call.args
                        ],
                    }
                }
            )
        return {
            "aggregate": {
                "input": _rel_to_substrait(node.source, fns),
                "groupings": groupings,
                "measures": measures,
            }
        }
    if isinstance(node, HashJoinNode):
        ls = node.left.output_schema
        rs = node.right.output_schema
        # equi-condition over the combined (left ++ right) field space
        conds = []
        for lk, rk in zip(node.left_keys, node.right_keys):
            li = ls.index_of(lk)
            ri = len(ls) + rs.index_of(rk)
            conds.append(
                _scalar_fn(
                    "equal",
                    BOOLEAN,
                    [
                        {
                            "selection": {
                                "directReference": {"structField": {"field": li}},
                                "rootReference": {},
                            }
                        },
                        {
                            "selection": {
                                "directReference": {"structField": {"field": ri}},
                                "rootReference": {},
                            }
                        },
                    ],
                    fns,
                )
            )
        cond = (
            conds[0]
            if len(conds) == 1
            else _scalar_fn("and", BOOLEAN, conds, fns)
        )
        combined = list(ls.names) + list(rs.names)
        return {
            "join": {
                "left": _rel_to_substrait(node.left, fns),
                "right": _rel_to_substrait(node.right, fns),
                "expression": cond,
                "type": _JOIN_TO_SUBSTRAIT[node.join_type],
                "common": {
                    "emit": {
                        "outputMapping": [
                            combined.index(c) for c in node.output_columns
                        ]
                    }
                },
            }
        }
    if isinstance(node, (OrderByNode, TopNNode)):
        schema = node.source.output_schema
        sort_rel = {
            "sort": {
                "input": _rel_to_substrait(node.source, fns),
                "sorts": [
                    {
                        "expr": _expr_to_substrait(
                            FieldAccess(schema.type_of(k.name), k.name),
                            schema,
                            fns,
                        ),
                        "direction": _sort_dir(k),
                    }
                    for k in node.keys
                ],
            }
        }
        if isinstance(node, TopNNode):
            return {"fetch": {"input": sort_rel, "offset": "0", "count": str(node.count)}}
        return sort_rel
    if isinstance(node, LimitNode):
        return {
            "fetch": {
                "input": _rel_to_substrait(node.source, fns),
                "offset": str(node.offset),
                "count": str(node.count),
            }
        }
    raise TypeError(f"cannot convert {type(node).__name__} to substrait")


def _sort_dir(k: SortKey) -> str:
    if k.ascending:
        return (
            "SORT_DIRECTION_ASC_NULLS_FIRST"
            if k.nulls_first
            else "SORT_DIRECTION_ASC_NULLS_LAST"
        )
    return (
        "SORT_DIRECTION_DESC_NULLS_FIRST"
        if k.nulls_first
        else "SORT_DIRECTION_DESC_NULLS_LAST"
    )


# ---------------------------------------------------------------------------
# relations: substrait -> ours


def from_substrait(
    plan: Dict[str, Any], catalog: Dict[str, Table]
) -> PlanNode:
    """Build an executable plan from a Substrait plan (protobuf-JSON shape).

    ``catalog`` resolves ReadRel namedTable names to connector Tables."""
    anchor_names: Dict[int, str] = {}
    for ext in plan.get("extensions", []):
        fn = ext.get("extensionFunction")
        if fn:
            anchor_names[fn.get("functionAnchor", 0)] = fn["name"]
    roots = plan.get("relations", [])
    assert len(roots) == 1, "expected exactly one relation tree"
    root = roots[0].get("root", roots[0])
    node = _rel_from_substrait(root["input"], catalog, anchor_names)
    names = root.get("names")
    if names and tuple(names) != tuple(node.output_schema.names):
        # rename via a trivial projection
        exprs = tuple(
            FieldAccess(t, n)
            for n, t in zip(node.output_schema.names, node.output_schema.types)
        )
        node = ProjectNode(node, tuple(names), exprs)
    return node


def _rel_from_substrait(rel, catalog, anchors) -> PlanNode:
    (kind, body), = ((k, v) for k, v in rel.items() if k != "common")
    if kind == "read":
        names = body["namedTable"]["names"]
        table = catalog[names[-1]]
        schema_names = body.get("baseSchema", {}).get("names")
        node = TableScanNode(
            table,
            tuple(schema_names or table.schema.names),
        )
        if "filter" in body:
            node.subfield_filter = _bound_strings(
                _expr_from_substrait(body["filter"], node.output_schema, anchors), node
            )
        return node
    if kind == "filter":
        src = _rel_from_substrait(body["input"], catalog, anchors)
        return FilterNode(
            src,
            _bound_strings(
                _expr_from_substrait(body["condition"], src.output_schema, anchors), src
            ),
        )
    if kind == "project":
        src = _rel_from_substrait(body["input"], catalog, anchors)
        in_schema = src.output_schema
        exprs = [
            _bound_strings(_expr_from_substrait(e, in_schema, anchors), src)
            for e in body.get("expressions", [])
        ]
        mapping = body.get("common", rel.get("common", {})) or {}
        mapping = (mapping.get("emit") or {}).get("outputMapping")
        all_exprs: List[Expr] = [
            FieldAccess(t, n) for n, t in zip(in_schema.names, in_schema.types)
        ] + exprs
        if mapping is None:
            chosen = all_exprs
        else:
            chosen = [all_exprs[i] for i in mapping]
        names = [f"c{i}" for i in range(len(chosen))]
        for i, e in enumerate(chosen):
            if isinstance(e, FieldAccess):
                names[i] = e.name
        return ProjectNode(src, tuple(names), tuple(chosen))
    if kind == "aggregate":
        src = _rel_from_substrait(body["input"], catalog, anchors)
        in_schema = src.output_schema
        keys = []
        for g in body.get("groupings", []):
            for ge in g.get("groupingExpressions", []):
                e = _expr_from_substrait(ge, in_schema, anchors)
                assert isinstance(e, FieldAccess), "grouping keys must be fields"
                keys.append(e.name)
        calls = []
        names = list(keys)
        from ..exec.aggregates import bind_aggregate

        agg_names = []
        for i, m in enumerate(body.get("measures", [])):
            mm = m["measure"]
            raw = anchors[mm.get("functionReference", 0)].split(":", 1)[0]
            fname = _FROM_SUBSTRAIT_FN.get(raw, raw)
            args = [
                _expr_from_substrait(a["value"], in_schema, anchors)
                for a in mm.get("arguments", [])
            ]
            bound = bind_aggregate(fname, tuple(a.dtype for a in args) or None)
            calls.append(Call(bound.result_type, fname, tuple(args)))
            agg_names.append(f"a{i}")
        return AggregationNode(
            src,
            AggregationStep.SINGLE,
            tuple(keys),
            tuple(agg_names),
            tuple(calls),
        )
    if kind == "join":
        left = _rel_from_substrait(body["left"], catalog, anchors)
        right = _rel_from_substrait(body["right"], catalog, anchors)
        ls, rs = left.output_schema, right.output_schema
        combined = list(ls.names) + list(rs.names)
        left_keys, right_keys = [], []
        _collect_equi_keys(
            body["expression"], len(ls), combined, left_keys, right_keys, anchors
        )
        mapping = (body.get("common", {}).get("emit") or {}).get("outputMapping")
        if mapping is None:
            out_cols = combined
        else:
            out_cols = [combined[i] for i in mapping]
        return HashJoinNode(
            left,
            right,
            _JOIN_FROM_SUBSTRAIT.get(body.get("type", "JOIN_TYPE_INNER"), JoinType.INNER),
            tuple(left_keys),
            tuple(right_keys),
            tuple(out_cols),
        )
    if kind == "sort":
        src = _rel_from_substrait(body["input"], catalog, anchors)
        keys = []
        for s in body.get("sorts", []):
            e = _expr_from_substrait(s["expr"], src.output_schema, anchors)
            assert isinstance(e, FieldAccess)
            d = s.get("direction", "SORT_DIRECTION_ASC_NULLS_LAST")
            keys.append(
                SortKey(e.name, ascending="ASC" in d, nulls_first="NULLS_FIRST" in d)
            )
        return OrderByNode(src, tuple(keys))
    if kind == "fetch":
        src = _rel_from_substrait(body["input"], catalog, anchors)
        offset = int(body.get("offset", 0))
        count = int(body.get("count", 1 << 62))
        if isinstance(src, OrderByNode) and offset == 0:
            return TopNNode(src.source, src.keys, count)
        return LimitNode(src, offset, count)
    raise TypeError(f"cannot convert substrait rel {kind!r}")


def _collect_equi_keys(expr, n_left, combined, lkeys, rkeys, anchors):
    """Extract conjunct equal(field_i, field_j) pairs from a join condition."""
    if "scalarFunction" in expr:
        body = expr["scalarFunction"]
        name = anchors[body.get("functionReference", 0)].split(":", 1)[0]
        args = [a["value"] for a in body.get("arguments", [])]
        if name == "and":
            for a in args:
                _collect_equi_keys(a, n_left, combined, lkeys, rkeys, anchors)
            return
        if name == "equal":
            idx = []
            for a in args:
                sel = a.get("selection")
                assert sel, "join condition must compare fields"
                idx.append(sel["directReference"]["structField"].get("field", 0))
            i, j = sorted(idx)
            assert i < n_left <= j, "join condition must span both sides"
            lkeys.append(combined[i])
            rkeys.append(combined[j])
            return
    raise TypeError("unsupported join condition (need conjunct field equalities)")
