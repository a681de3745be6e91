"""Expression evaluation: IR -> eager torch ops over a Batch.

Counterpart of the JAX package's ``expr/compiler.py``.  Reference:
velox/expression/Expr.cpp (Expr::eval at :780, ExprSet at Expr.h:632).

The tree is walked once per batch and every node issues torch ops on the
batch's device.  What the reference does with runtime fast paths shows up here
as properties of the walk:

* flat-no-nulls  -> validity stays ``None`` and no mask ops are issued at all;
* CSE            -> a per-batch cache keyed on Expr.key() (Expr.cpp:854 analog);
* constants      -> a literal is a one-element tensor expanded (stride 0) to
                    the capacity; a call or cast whose inputs are all such
                    constants is computed on the one element and expanded
                    again, so literal arithmetic costs no full-width pass;
* TRY / errors   -> an explicit bool error lane per expression
                    (EvalCtx error-vector analog, velox/expression/EvalCtx.h:37).

Null discipline is Presto's: default-null for plain calls, Kleene logic for
AND/OR, lazy-branch semantics for IF/SWITCH via masking.

ARRAY / MAP / ROW values evaluate to ``expr/seg.py`` SegValue / StructValue
(spans over element pools); the array / map / lambda functions are dispatched
by name to ``functions/presto/complex.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..dtypes import DataType, TypeKind
from ..vector.column import Batch, Column, _take_clamped
from .ir import Call, Constant, DictLookup, Expr, FieldAccess, Special, SpecialForm
from .registry import DEFAULT_REGISTRY, FunctionRegistry


@dataclasses.dataclass
class EvalResult:
    """values[capacity], optional validity (True=non-null), optional error lane.

    ``strings``: dictionary of a VARCHAR result whose table was created during
    evaluation.  ``const``: ``values`` is a one-element tensor expanded to the
    capacity, with no validity and no errors."""

    values: torch.Tensor
    validity: Optional[torch.Tensor] = None
    errors: Optional[torch.Tensor] = None
    strings: Optional[object] = None
    const: bool = False

    def validity_or_true(self, capacity: int) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(
                (capacity,), dtype=torch.bool, device=self.values.device
            )
        return self.validity


def _and_masks(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _or_masks(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return b
    if b is None:
        return a
    return a | b


class EvalContext:
    """Per-batch evaluation context: input columns, capacity, CSE cache."""

    def __init__(self, batch: Batch, registry: FunctionRegistry = None):
        self.batch = batch
        self.capacity = batch.capacity
        self.device = batch.device
        self.registry = registry or DEFAULT_REGISTRY
        self._cse: Dict[str, EvalResult] = {}

    def evaluate(self, expr: Expr) -> EvalResult:
        key = expr.key()
        hit = self._cse.get(key)
        if hit is not None:
            return hit
        result = self._evaluate(expr)
        self._cse[key] = result
        return result

    def _zeros(self, dtype) -> torch.Tensor:
        return torch.zeros((self.capacity,), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def _evaluate(self, expr: Expr) -> EvalResult:
        if isinstance(expr, FieldAccess):
            col = self.batch.column(expr.name)
            if expr.dtype.kind == TypeKind.ROW:
                from .seg import StructValue

                return EvalResult(StructValue.from_column(col), col.validity)
            if expr.dtype.is_complex:
                from .seg import SegValue

                return EvalResult(SegValue.from_column(col), col.validity)
            values, validity = col.decode(self.capacity)
            return EvalResult(values, validity)
        if isinstance(expr, Constant):
            return self._constant(expr)
        if isinstance(expr, Call):
            return self._call(expr)
        if isinstance(expr, Special):
            return self._special(expr)
        if isinstance(expr, DictLookup):
            child = self.evaluate(expr.child)
            lookup = expr.values.on(self.device)
            idx = child.values.to(torch.int32)
            validity, errors = child.validity, child.errors
            if expr.child2 is not None:
                c2 = self.evaluate(expr.child2)
                idx = idx * expr.width + c2.values.to(torch.int32)
                validity = _and_masks(validity, c2.validity)
                errors = _or_masks(errors, c2.errors)
            out = _take_clamped(lookup, idx)
            return EvalResult(out, validity, errors)
        raise TypeError(f"cannot evaluate {type(expr).__name__}")

    def _constant(self, expr: Constant) -> EvalResult:
        dtype = expr.dtype
        if expr.value is None:
            return EvalResult(
                self._zeros(dtype.device_dtype), self._zeros(torch.bool)
            )
        # DECIMAL constants carry their *unscaled* int64 value.
        scalar = torch.tensor(
            [expr.value], dtype=dtype.device_dtype, device=self.device
        )
        return EvalResult(scalar.expand((self.capacity,)), None, const=True)

    def _expand_const(self, values: torch.Tensor) -> torch.Tensor:
        return values.expand((self.capacity,))

    def _call(self, expr: Call) -> EvalResult:
        from ..functions.presto.complex import COMPLEX_FNS, is_complex_call

        if is_complex_call(expr.name, expr.args):
            result = COMPLEX_FNS[expr.name](self, expr)
            return self._surface_pool_overflow(expr, result)
        arg_results = [self.evaluate(a) for a in expr.args]
        arg_types = [a.dtype for a in expr.args]
        sig, _, _ = self.registry.resolve(expr.name, arg_types)
        if arg_results and not sig.null_aware and all(r.const for r in arg_results):
            # literal arithmetic: one element, expanded again
            out = sig.impl(
                self, expr.dtype, arg_types, *[r.values[:1] for r in arg_results]
            )
            if not isinstance(out, tuple):
                return EvalResult(self._expand_const(out), None, const=True)
        errors: Optional[torch.Tensor] = None
        for r in arg_results:
            errors = _or_masks(errors, r.errors)
        if sig.null_aware:
            packed = [(r.values, r.validity) for r in arg_results]
            out = sig.impl(self, expr.dtype, arg_types, *packed)
            values, validity = out[0], out[1]
            fn_errors = out[2] if len(out) > 2 else None
        else:
            out = sig.impl(self, expr.dtype, arg_types, *[r.values for r in arg_results])
            if isinstance(out, tuple):
                values, fn_errors = out
            else:
                values, fn_errors = out, None
            validity = None
            for r in arg_results:
                validity = _and_masks(validity, r.validity)
        # A row that is NULL cannot raise (reference: default-null rows are
        # skipped before the function body runs).
        if fn_errors is not None and validity is not None:
            fn_errors = fn_errors & validity
        errors = _or_masks(errors, fn_errors)
        return EvalResult(values, validity, errors)

    def _surface_pool_overflow(self, expr: Call, result: EvalResult) -> EvalResult:
        """If a complex function normalized an argument whose duplicated spans
        exceeded its static element pool, the result is truncated — surface it
        as a row error (ops/segpool.normalize sets the flag).  The CSE cache
        holds the argument results, including their memoized normalization."""
        from .seg import SegValue

        errors = result.errors
        for a in expr.args:
            r = self._cse.get(a.key())
            if (
                r is not None
                and isinstance(r.values, SegValue)
                and r.values._norm_cache is not None
                and r.values._norm_cache.overflow is not None
            ):
                o = r.values._norm_cache.overflow.expand((self.capacity,))
                errors = _or_masks(errors, o)
        result.errors = errors
        return result

    # ---- special forms ------------------------------------------------
    def _special(self, expr: Special) -> EvalResult:
        form = expr.form
        if form == SpecialForm.AND:
            return self._conjunct(expr.args, is_and=True)
        if form == SpecialForm.OR:
            return self._conjunct(expr.args, is_and=False)
        if form == SpecialForm.IF:
            return self._if(expr)
        if form == SpecialForm.SWITCH:
            return self._switch(expr)
        if form == SpecialForm.COALESCE:
            return self._coalesce(expr)
        if form == SpecialForm.TRY:
            r = self.evaluate(expr.args[0])
            if r.errors is None:
                return r
            validity = r.validity_or_true(self.capacity) & ~r.errors
            return EvalResult(r.values, validity, None)
        if form in (SpecialForm.CAST, SpecialForm.TRY_CAST):
            return self._cast(expr)
        if form == SpecialForm.IN:
            return self._in(expr)
        raise ValueError(f"unknown special form {form}")

    def _conjunct(self, args: Sequence[Expr], is_and: bool) -> EvalResult:
        """Kleene AND/OR (reference: velox/expression/ConjunctExpr.h).

        AND: FALSE dominates; NULL if no FALSE but some NULL.
        OR:  TRUE dominates; NULL if no TRUE but some NULL.
        Errors on rows already decided by another conjunct are suppressed, which
        matches the reference's relaxed evaluation-order semantics.
        """
        results = [self.evaluate(a) for a in args]
        if all(r.validity is None and r.errors is None for r in results):
            # no NULLs and no errors anywhere: plain two-valued logic
            out = results[0].values.to(torch.bool)
            for r in results[1:]:
                v = r.values.to(torch.bool)
                out = (out & v) if is_and else (out | v)
            return EvalResult(out, None, None)
        cap = self.capacity
        known = None  # rows where some conjunct decided the result
        validity = None
        errors = None
        for r in results:
            v = r.values.to(torch.bool)
            val = r.validity_or_true(cap)
            if r.errors is not None:
                val = val & ~r.errors
            dominated = (v if not is_and else ~v) & val  # decides the row
            known = dominated if known is None else (known | dominated)
            validity = val if validity is None else (validity & val)
            errors = _or_masks(errors, r.errors)
        decided_value = ~known if is_and else known
        final_validity = known | validity  # decided rows are non-null
        if errors is not None:
            errors = errors & ~known  # a decided row swallows errors
        # Undecided, all-valid rows: AND->TRUE, OR->FALSE.
        out = torch.where(
            known, decided_value, torch.full_like(decided_value, is_and)
        )
        return EvalResult(out, final_validity, errors)

    def _if(self, expr: Special) -> EvalResult:
        cond, then_e, else_e = expr.args
        c = self.evaluate(cond)
        t = self.evaluate(then_e)
        f = self.evaluate(else_e)
        cap = self.capacity
        take_then = c.values.to(torch.bool) & c.validity_or_true(cap)
        values = torch.where(take_then, t.values, f.values)
        validity = torch.where(
            take_then, t.validity_or_true(cap), f.validity_or_true(cap)
        )
        errors = _or_masks(
            None if c.errors is None else c.errors,
            _or_masks(
                None if t.errors is None else (t.errors & take_then),
                None if f.errors is None else (f.errors & ~take_then),
            ),
        )
        return EvalResult(values, validity, errors)

    def _switch(self, expr: Special) -> EvalResult:
        """args = [cond1, val1, cond2, val2, ..., else?]."""
        args = list(expr.args)
        has_else = len(args) % 2 == 1
        else_e = args.pop() if has_else else None
        pairs = list(zip(args[0::2], args[1::2]))
        cap = self.capacity
        if else_e is not None:
            acc = self.evaluate(else_e)
        else:
            acc = EvalResult(
                self._zeros(expr.dtype.device_dtype), self._zeros(torch.bool)
            )
        values, validity, errors = acc.values, acc.validity_or_true(cap), acc.errors
        taken = self._zeros(torch.bool)
        for cond_e, val_e in pairs:
            c = self.evaluate(cond_e)
            v = self.evaluate(val_e)
            take = c.values.to(torch.bool) & c.validity_or_true(cap) & ~taken
            values = torch.where(take, v.values, values)
            validity = torch.where(take, v.validity_or_true(cap), validity)
            if v.errors is not None:
                errors = _or_masks(errors, v.errors & take)
            if c.errors is not None:
                errors = _or_masks(errors, c.errors & ~taken)
            taken = taken | take
        return EvalResult(values, validity, errors)

    def _coalesce(self, expr: Special) -> EvalResult:
        cap = self.capacity
        results = [self.evaluate(a) for a in expr.args]
        values = results[-1].values
        validity = results[-1].validity_or_true(cap)
        errors = results[-1].errors
        for r in reversed(results[:-1]):
            valid = r.validity_or_true(cap)
            values = torch.where(valid, r.values, values)
            validity = valid | validity
            errors = _or_masks(errors, r.errors)
        return EvalResult(values, validity, errors)

    def _in(self, expr: Special) -> EvalResult:
        value = self.evaluate(expr.args[0])
        hit = self._zeros(torch.bool)
        for opt in expr.args[1:]:
            r = self.evaluate(opt)
            hit = hit | (value.values == r.values)
        return EvalResult(hit, value.validity, value.errors)

    def _cast(self, expr: Special) -> EvalResult:
        child = self.evaluate(expr.args[0])
        from_t = expr.args[0].dtype
        to_t = expr.dtype
        if child.const:
            values, errors = cast_values(child.values[:1], from_t, to_t)
            if errors is None:
                return EvalResult(self._expand_const(values), None, const=True)
        values, errors = cast_values(child.values, from_t, to_t)
        validity = child.validity
        errors = _or_masks(child.errors, errors)
        if errors is not None and validity is not None:
            errors = errors & validity
        if expr.form == SpecialForm.TRY_CAST and errors is not None:
            validity = child.validity_or_true(self.capacity) & ~errors
            errors = None
        return EvalResult(values, validity, errors)


# ---- CAST matrix ---------------------------------------------------------


def _scale_factor(n: int) -> int:
    return 10 ** n


def cast_values(
    values: torch.Tensor, from_t: DataType, to_t: DataType
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Device cast matrix (reference: velox/expression/CastExpr.cpp,
    velox/type/Conversions.h).  Returns (values, error_mask|None)."""
    if from_t.kind == to_t.kind and from_t == to_t:
        return values, None
    fk, tk = from_t.kind, to_t.kind
    out_dtype = to_t.device_dtype

    if fk == TypeKind.DECIMAL and tk == TypeKind.DECIMAL:
        ds = to_t.scale - from_t.scale
        if ds == 0:
            return values.to(out_dtype), None
        if ds > 0:
            return values * _scale_factor(ds), None
        return _decimal_rescale_down(values, -ds), None

    if fk == TypeKind.DECIMAL:
        if to_t.is_floating:
            # the divisor is a tensor on the values' device: torch on CUDA
            # multiplies by the reciprocal of a Python-number divisor, which
            # misses the correctly rounded quotient in the last bit (as XLA
            # on the CPU does); a sketch hashing the DOUBLE's bits would see it
            scale = torch.tensor(
                float(_scale_factor(from_t.scale)), dtype=out_dtype, device=values.device
            )
            return values.to(out_dtype) / scale, None
        if to_t.is_integer:
            return _decimal_rescale_down(values, from_t.scale).to(out_dtype), None
        if tk == TypeKind.BOOLEAN:
            return (values != 0), None

    if tk == TypeKind.DECIMAL:
        factor = _scale_factor(to_t.scale)
        if from_t.is_integer or fk == TypeKind.BOOLEAN:
            return values.to(torch.int64) * factor, None
        if from_t.is_floating:
            scaled = torch.round(values.to(torch.float64) * factor)
            return scaled.to(torch.int64), None

    if from_t.is_floating and to_t.is_integer:
        # Presto rounds to nearest on float->integer cast (half to even, as
        # the reference package's rint does).
        rounded = torch.round(values)
        info = torch.iinfo(out_dtype)
        errors = (
            torch.isnan(values)
            | (rounded < float(info.min))
            | (rounded > float(info.max))
        )
        return torch.nan_to_num(rounded).to(out_dtype), errors

    if (from_t.is_numeric or fk == TypeKind.BOOLEAN) and (
        to_t.is_numeric or tk == TypeKind.BOOLEAN
    ):
        return values.to(out_dtype), None

    if fk == TypeKind.DATE and tk == TypeKind.TIMESTAMP:
        return values.to(torch.int64) * 86_400_000_000, None
    if fk == TypeKind.TIMESTAMP and tk == TypeKind.DATE:
        return (
            torch.div(values, 86_400_000_000, rounding_mode="floor").to(torch.int32),
            None,
        )

    raise TypeError(f"unsupported cast {from_t} -> {to_t}")


def _decimal_rescale_down(values: torch.Tensor, digits: int) -> torch.Tensor:
    """Divide by 10**digits rounding half away from zero (Presto decimal rule)."""
    factor = _scale_factor(digits)
    half = factor // 2
    sign = torch.sign(values)
    return sign * ((torch.abs(values) + half) // factor)


# ---- ExprSet -------------------------------------------------------------


class ExprSet:
    """A set of expressions evaluated together over one input schema.

    Reference: velox/expression/Expr.h:632 (ExprSet) — shared-subexpression state
    here is the per-batch CSE cache in EvalContext.
    """

    def __init__(self, exprs: Sequence[Expr], registry: FunctionRegistry = None):
        self.exprs = list(exprs)
        self.registry = registry or DEFAULT_REGISTRY

    def eval(self, batch: Batch) -> List[EvalResult]:
        ctx = EvalContext(batch, self.registry)
        return [ctx.evaluate(e) for e in self.exprs]

    def eval_to_columns(self, batch: Batch) -> Tuple[List[Column], Optional[torch.Tensor]]:
        """Evaluate and wrap as Columns; returns (columns, combined error mask)."""
        results = self.eval(batch)
        errors = None
        cols = []
        for e, r in zip(self.exprs, results):
            errors = _or_masks(errors, r.errors)
            if e.dtype.is_complex:
                cols.append(r.values.to_column(r.validity))
                continue
            strings = r.strings or _strings_of(e, batch)
            cols.append(Column.flat(r.values, e.dtype, r.validity, strings))
        return cols, errors


def _strings_of(expr: Expr, batch: Batch):
    """Propagate the StringTable for expressions that return input strings as-is."""
    if not expr.dtype.is_string:
        return None
    if isinstance(expr, DictLookup):
        return expr.strings
    if isinstance(expr, FieldAccess):
        return batch.column(expr.name).strings
    for child in expr.children:
        t = _child_string_table(child, batch)
        if t is not None:
            return t
    return None


def _child_string_table(expr: Expr, batch: Batch):
    if expr.dtype.is_string:
        return _strings_of(expr, batch)
    if expr.dtype.is_complex and isinstance(expr, FieldAccess):
        # element_at / subscript on ARRAY(VARCHAR) / MAP(.., VARCHAR): the
        # string dictionary lives on the complex column's child pool
        col = batch.column(expr.name)
        for ch in reversed(col.children):  # MAP: prefer the value child
            if ch.strings is not None:
                return ch.strings
    return None
