"""Scalar function registry + signature binding.

Reference: velox/expression/FunctionSignature.h:126, SignatureBinder.h:68,
SimpleFunctionRegistry.h, VectorFunction.h:35.

The reference distinguishes "simple" (scalar C++ templates auto-vectorized) from
"vector" (hand-written batch) functions.  Here everything is a batch function over
torch tensors, so there is one kind; the interesting metadata is *null discipline*:

* ``default_null`` (the common case): impl sees decoded value arrays only; result
  validity is the AND of argument validities (reference: default-null behavior in
  SimpleFunctionAdapter.h:66).
* ``null_aware``: impl sees (values, validity) pairs and produces its own validity
  (is_null, coalesce-style functions).

Impls may additionally return an error mask (bool[capacity], True = row errored),
the device-side analog of the reference's EvalCtx error vector
(velox/expression/EvalCtx.h:37) — errors surface at the host boundary unless a TRY
masks them to NULL.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..dtypes import (
    DOUBLE,
    DataType,
    TypeKind,
    common_numeric_type,
)
from .ir import Call, Expr, Special, SpecialForm

# A matcher is either a TypeKind (exact kind match) or one of the markers below.
NUMERIC = "numeric"
INTEGER = "integer"
ORDERABLE = "orderable"
ANY = "any"
STRINGY = "string"


def _matches(matcher, dtype: DataType) -> bool:
    if isinstance(matcher, TypeKind):
        return dtype.kind == matcher
    if matcher == NUMERIC:
        return dtype.is_numeric
    if matcher == INTEGER:
        return dtype.is_integer
    if matcher == ORDERABLE:
        return dtype.is_orderable
    if matcher == STRINGY:
        return dtype.is_string
    if matcher == ANY:
        return True
    raise ValueError(f"bad matcher {matcher}")


@dataclasses.dataclass
class Signature:
    """One overload of a scalar function."""

    arg_matchers: Tuple[object, ...]
    # result_type(arg_dtypes) -> DataType
    result_type: Callable[[Sequence[DataType]], DataType]
    # impl(ctx, result_dtype, arg_dtypes, *decoded_args) -> values | (values, errors)
    # default_null: decoded_args are value arrays.
    # null_aware:   decoded_args are (values, validity|None) tuples;
    #               returns (values, validity | None) or (values, validity, errors).
    impl: Callable
    null_aware: bool = False
    # If True, all numeric args are first coerced to their common numeric type.
    coerce_common_numeric: bool = False
    variadic: bool = False

    def matches(self, arg_types: Sequence[DataType]) -> bool:
        if self.variadic:
            if len(arg_types) < len(self.arg_matchers):
                return False
            matchers = list(self.arg_matchers) + [self.arg_matchers[-1]] * (
                len(arg_types) - len(self.arg_matchers)
            )
        else:
            if len(arg_types) != len(self.arg_matchers):
                return False
            matchers = list(self.arg_matchers)
        return all(_matches(m, t) for m, t in zip(matchers, arg_types))


class FunctionRegistry:
    def __init__(self):
        self._functions: Dict[str, List[Signature]] = {}

    def register(
        self,
        name: str,
        arg_matchers: Sequence[object],
        result_type,
        impl: Callable,
        null_aware: bool = False,
        coerce_common_numeric: bool = False,
        variadic: bool = False,
    ) -> None:
        if not callable(result_type):
            fixed = result_type
            result_type = lambda arg_types, _t=fixed: _t  # noqa: E731
        self._functions.setdefault(name, []).append(
            Signature(
                tuple(arg_matchers),
                result_type,
                impl,
                null_aware,
                coerce_common_numeric,
                variadic,
            )
        )

    def names(self) -> List[str]:
        return sorted(self._functions)

    def signatures(self, name: str) -> List[Signature]:
        return list(self._functions.get(name, ()))

    def resolve(
        self, name: str, arg_types: Sequence[DataType]
    ) -> Tuple[Signature, List[Optional[DataType]], DataType]:
        """Bind a call: returns (signature, per-arg coercion targets, result type).

        Coercion target None means the arg is used as-is; otherwise the compiler
        inserts an implicit CAST (the reference does this during expression
        compilation via implicit cast insertion).
        """
        sigs = self._functions.get(name)
        if not sigs:
            raise KeyError(f"no function named {name!r}")
        # Pass 1: exact match on the given types.
        for sig in sigs:
            if sig.matches(arg_types):
                coerced = self._coercions(sig, arg_types)
                final = [c or t for c, t in zip(coerced, arg_types)]
                return sig, coerced, sig.result_type(final)
        # Pass 2: widen all numeric args to a common numeric type and retry.
        numeric = [t for t in arg_types if t.is_numeric]
        if len(numeric) >= 2:
            try:
                common = numeric[0]
                for t in numeric[1:]:
                    common = common_numeric_type(common, t)
            except TypeError:
                common = None
            if common is not None:
                widened = [common if t.is_numeric else t for t in arg_types]
                for sig in sigs:
                    if sig.matches(widened):
                        targets = [
                            (w if w != t else None)
                            for w, t in zip(widened, arg_types)
                        ]
                        coerced2 = self._coercions(sig, widened)
                        targets = [c2 or t0 for c2, t0 in zip(coerced2, targets)]
                        return sig, targets, sig.result_type(widened)
        raise TypeError(
            f"no signature of {name!r} matches ({', '.join(map(str, arg_types))})"
        )

    @staticmethod
    def _coercions(
        sig: Signature, arg_types: Sequence[DataType]
    ) -> List[Optional[DataType]]:
        if not sig.coerce_common_numeric:
            return [None] * len(arg_types)
        numeric = [t for t in arg_types if t.is_numeric]
        if len(numeric) < 2:
            return [None] * len(arg_types)
        common = numeric[0]
        for t in numeric[1:]:
            common = common_numeric_type(common, t)
        return [
            (common if (t.is_numeric and t != common) else None) for t in arg_types
        ]


# The process-wide default registry (reference: exec::simpleFunctions() singleton).
DEFAULT_REGISTRY = FunctionRegistry()


def make_call(name: str, args: Sequence[Expr], registry: FunctionRegistry = None) -> Expr:
    """Type-check and build a Call node, inserting implicit casts."""
    registry = registry or DEFAULT_REGISTRY
    arg_types = [a.dtype for a in args]
    _, targets, result = registry.resolve(name, arg_types)
    new_args = []
    for a, target in zip(args, targets):
        if target is not None and target != a.dtype:
            a = Special(target, SpecialForm.CAST, (a,))
        new_args.append(a)
    return Call(result, name, tuple(new_args))
