"""Typed expression IR.

Reference: velox/core/Expressions.h / ITypedExpr.h (typed expression trees) and
velox/expression/Expr.h:149 (compiled executable expressions).

Here the two layers collapse into one: the IR below *is* the executable form.
``expr.compiler`` walks it once per batch and issues eager torch ops; common
subexpressions are evaluated once through a cache keyed on ``Expr.key()``.

Special forms (AND/OR/IF/SWITCH/COALESCE/TRY/CAST) are first-class node types, like
the reference's special-form Exprs (velox/expression/ConjunctExpr.h, CastExpr.h,
SwitchExpr.h, TryExpr.h, CoalesceExpr.h).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from ..dtypes import BOOLEAN, DataType, RowType, TypeKind


@dataclasses.dataclass(frozen=True)
class Expr:
    """Base typed expression node."""

    dtype: DataType

    def key(self) -> str:
        """Stable structural key for CSE / memoization."""
        raise NotImplementedError

    @property
    def children(self) -> Tuple["Expr", ...]:
        return ()

    def to_json(self) -> Any:
        raise NotImplementedError

    def __str__(self) -> str:
        return self.key()


@dataclasses.dataclass(frozen=True)
class FieldAccess(Expr):
    """Reference to an input column by name (core::FieldAccessTypedExpr)."""

    name: str = ""

    def key(self) -> str:
        return f"${self.name}"

    def to_json(self):
        return {"node": "field", "name": self.name, "type": self.dtype.to_json()}


@dataclasses.dataclass(frozen=True)
class Constant(Expr):
    """Literal (core::ConstantTypedExpr). value=None encodes NULL."""

    value: Any = None

    def key(self) -> str:
        return f"lit[{self.dtype}]({self.value!r})"

    def to_json(self):
        return {
            "node": "constant",
            "value": self.value,
            "type": self.dtype.to_json(),
        }


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    """Scalar function call (core::CallTypedExpr)."""

    name: str = ""
    args: Tuple[Expr, ...] = ()

    def key(self) -> str:
        return f"{self.name}({','.join(a.key() for a in self.args)})"

    @property
    def children(self):
        return self.args

    def to_json(self):
        return {
            "node": "call",
            "name": self.name,
            "args": [a.to_json() for a in self.args],
            "type": self.dtype.to_json(),
        }


class SpecialForm:
    AND = "and"
    OR = "or"
    IF = "if"
    SWITCH = "switch"
    COALESCE = "coalesce"
    TRY = "try"
    CAST = "cast"
    TRY_CAST = "try_cast"
    IN = "in"


@dataclasses.dataclass(frozen=True)
class Special(Expr):
    """A special-form expression with non-default null/error semantics."""

    form: str = ""
    args: Tuple[Expr, ...] = ()

    def key(self) -> str:
        return f"@{self.form}[{self.dtype}]({','.join(a.key() for a in self.args)})"

    @property
    def children(self):
        return self.args

    def to_json(self):
        return {
            "node": "special",
            "form": self.form,
            "args": [a.to_json() for a in self.args],
            "type": self.dtype.to_json(),
        }


class HostArray:
    """A host numpy array riding in an expression as static metadata
    (hashable by identity, like StringTable).  ``on(device)`` uploads it once
    per device: a dictionary of millions of strings makes the table large, and
    every tile of every run gathers through it."""

    __slots__ = ("array", "_on")

    def __init__(self, array):
        self.array = array
        self._on = {}

    def on(self, device):
        import torch

        key = str(device)
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.array, device=device)
        return self._on[key]

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


class LikeTable:
    """The per-entry results of a LIKE over a dictionary, worked out when the
    executor first evaluates the node, not when the plan is bound: ``on(device)``
    matches the pattern against every entry with ``ops/dict_like.py`` (the
    K4 kernel on a CUDA device, over the entries' bytes that
    ``StringTable.byte_arrays`` keeps resident there) and keeps the result,
    once per device, like ``HostArray.on``."""

    __slots__ = ("strings", "pattern", "_on")

    def __init__(self, strings, pattern):
        self.strings = strings
        self.pattern = pattern  # ops/dict_like.py LikePattern
        self._on = {}

    def on(self, device):
        import torch

        from ..ops.dict_like import dict_like

        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        if key not in self._on:
            data, offsets = self.strings.byte_arrays(device)
            self._on[key] = dict_like(data, offsets, self.pattern, device)
        return self._on[key]


@dataclasses.dataclass(frozen=True)
class DictLookup(Expr):
    """Gather a host-precomputed per-dictionary-code result: out = values[codes].

    This is the bind-time form of the reference's evaluate-on-dictionary-values
    peeling (velox/expression/PeeledEncoding.h): a string function is evaluated
    once per *distinct* string on the host, and the device does a single gather.
    ``strings`` carries the result dictionary when the output is itself VARCHAR.

    Two-input form (``child2`` set): the table covers the cross product of
    both dictionaries and the device index is ``c1 * width + c2`` — how
    binary string functions (concat of two columns, levenshtein) bind.
    """

    child: Optional[Expr] = None
    values: Optional[HostArray] = None  # or a LikeTable, worked out when evaluated
    strings: Optional[object] = None  # StringTable of the result, if VARCHAR
    child2: Optional[Expr] = None
    width: int = 0  # second dictionary's size (pair form only)

    def key(self) -> str:
        tail = f",{self.child2.key()}" if self.child2 is not None else ""
        return f"@dictlookup[{id(self.values)}]({self.child.key()}{tail})"

    @property
    def children(self):
        if self.child2 is not None:
            return (self.child, self.child2)
        return (self.child,)

    def to_json(self):
        raise TypeError("DictLookup is a bind-time node; serialize the pre-bind expr")


@dataclasses.dataclass(frozen=True)
class StringsCall(Call):
    """A Call whose (complex) result carries a statically-known element
    dictionary (e.g. split(): the parts table derives from the input
    dictionary at bind time, so downstream operators can resolve it)."""

    strings: Optional[object] = None  # StringTable, hashable by identity

    def to_json(self):
        raise TypeError("StringsCall is a bind-time node; serialize pre-bind")


@dataclasses.dataclass(frozen=True)
class Lambda(Expr):
    """Lambda expression for array/map higher-order functions.

    Reference: velox/expression/LambdaExpr.h. ``dtype`` is the body's type.
    """

    params: Tuple[str, ...] = ()
    param_types: Tuple[DataType, ...] = ()
    body: Optional[Expr] = None

    def key(self) -> str:
        return f"lambda({','.join(self.params)})->{self.body.key()}"

    @property
    def children(self):
        return (self.body,)

    def to_json(self):
        return {
            "node": "lambda",
            "params": list(self.params),
            "param_types": [t.to_json() for t in self.param_types],
            "body": self.body.to_json(),
            "type": self.dtype.to_json(),
        }


# ---- convenience constructors -------------------------------------------


def field(schema: RowType, name: str) -> FieldAccess:
    return FieldAccess(schema.type_of(name), name)


def lit(value: Any, dtype: DataType) -> Constant:
    return Constant(dtype, value)


def call(name: str, dtype: DataType, *args: Expr) -> Call:
    return Call(dtype, name, tuple(args))


def and_(*args: Expr) -> Special:
    return Special(BOOLEAN, SpecialForm.AND, tuple(args))


def or_(*args: Expr) -> Special:
    return Special(BOOLEAN, SpecialForm.OR, tuple(args))


def if_(cond: Expr, then: Expr, else_: Expr) -> Special:
    assert then.dtype.equivalent(else_.dtype), (then.dtype, else_.dtype)
    return Special(then.dtype, SpecialForm.IF, (cond, then, else_))


def cast(child: Expr, dtype: DataType, try_: bool = False) -> Special:
    form = SpecialForm.TRY_CAST if try_ else SpecialForm.CAST
    return Special(dtype, form, (child,))


def try_(child: Expr) -> Special:
    return Special(child.dtype, SpecialForm.TRY, (child,))


def coalesce(*args: Expr) -> Special:
    return Special(args[0].dtype, SpecialForm.COALESCE, tuple(args))


def in_(value: Expr, options: Sequence[Expr]) -> Special:
    return Special(BOOLEAN, SpecialForm.IN, (value, *options))


def expr_from_json(obj: Any) -> Expr:
    node = obj["node"]
    dtype = DataType.from_json(obj["type"])
    if node == "field":
        return FieldAccess(dtype, obj["name"])
    if node == "constant":
        return Constant(dtype, obj["value"])
    if node == "call":
        return Call(dtype, obj["name"], tuple(expr_from_json(a) for a in obj["args"]))
    if node == "special":
        return Special(dtype, obj["form"], tuple(expr_from_json(a) for a in obj["args"]))
    if node == "lambda":
        return Lambda(
            dtype,
            tuple(obj["params"]),
            tuple(DataType.from_json(t) for t in obj["param_types"]),
            expr_from_json(obj["body"]),
        )
    raise ValueError(f"unknown expr node {node}")
