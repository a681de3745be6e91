"""Evaluation-time value form of ARRAY / MAP / ROW expressions.

Counterpart of the JAX package's ``expr/seg.py``.  Scalar expressions
evaluate to flat tensors (EvalResult.values); complex expressions evaluate to
a :class:`SegValue` — per-row (start, size) spans over fixed-capacity element
pools — or, for ROW, a :class:`StructValue`.  Both exist only while an
expression tree is evaluated: they are built from a complex ``Column`` at
FieldAccess and converted back at the ExprSet output boundary.

``normalized()`` repacks pools into dense row order (ops.segpool.normalize)
and memoizes the result — lambda evaluation and per-row reductions need the
pool↔row correspondence, while pure span lookups (cardinality, element_at)
work on any layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..dtypes import DataType, TypeKind
from ..vector.complex import note_pool
from ..vector.string_table import StringTable


@dataclasses.dataclass
class Elems:
    """One element pool: values (+validity) of the child of an ARRAY/MAP."""

    values: Any  # torch.Tensor | SegValue (nested complex elements)
    validity: Optional[torch.Tensor]
    dtype: DataType
    strings: Optional[StringTable] = None

    @property
    def pool_cap(self) -> int:
        if isinstance(self.values, SegValue):
            return self.values.capacity
        return self.values.shape[0]

    def validity_or_true(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(
                (self.pool_cap,), dtype=torch.bool, device=_device_of(self.values)
            )
        return self.validity

    def take(self, indices: torch.Tensor) -> "Elems":
        if isinstance(self.values, SegValue):
            values = self.values.take_rows(indices)
        else:
            values = _take(self.values, indices)
        validity = (
            None if self.validity is None else _take(self.validity, indices)
        )
        return Elems(values, validity, self.dtype, self.strings)


@dataclasses.dataclass
class SegValue:
    """Per-row spans over element pools: the device value of ARRAY/MAP rows."""

    starts: torch.Tensor  # int64[capacity]
    sizes: torch.Tensor  # int64[capacity]
    children: Tuple[Elems, ...]  # ARRAY: (elements,); MAP: (keys, values)
    dtype: DataType  # the ARRAY/MAP type
    _norm_cache: Optional["NormSeg"] = dataclasses.field(default=None, repr=False)

    @property
    def capacity(self) -> int:
        return self.starts.shape[0]

    @property
    def pool_cap(self) -> int:
        return self.children[0].pool_cap

    def take_rows(self, indices: torch.Tensor) -> "SegValue":
        return SegValue(
            _take(self.starts, indices),
            _take(self.sizes, indices),
            self.children,
            self.dtype,
        )

    # ---- normalization ---------------------------------------------------
    def normalized(self) -> "NormSeg":
        if self._norm_cache is not None:
            return self._norm_cache
        from ..ops.segpool import normalize

        flat_pools, specs = [], []
        for ch in self.children:
            arrs, spec = _flatten_elems(ch)
            flat_pools.extend(arrs)
            specs.append(spec)
        starts, sizes, new_pools, rowid, emask, overflow = normalize(
            self.starts, self.sizes, tuple(flat_pools), self.pool_cap
        )
        note_pool(self.pool_cap, starts[-1] + sizes[-1])
        new_children = []
        i = 0
        for ch, spec in zip(self.children, specs):
            ch2, i = _rebuild_elems(ch, spec, new_pools, i)
            new_children.append(ch2)
        norm = NormSeg(
            SegValue(starts, sizes, tuple(new_children), self.dtype),
            rowid,
            emask,
            overflow,
        )
        self._norm_cache = norm
        return norm

    # ---- Column conversion ----------------------------------------------
    @staticmethod
    def from_column(col) -> "SegValue":
        assert col.dtype.is_complex
        children = []
        for ch in col.children:
            if ch.dtype.is_complex:
                children.append(
                    Elems(SegValue.from_column(ch), ch.validity, ch.dtype, None)
                )
            else:
                children.append(Elems(ch.data, ch.validity, ch.dtype, ch.strings))
        return SegValue(
            col.data[:, 0], col.data[:, 1], tuple(children), col.dtype
        )

    def to_column(self, validity: Optional[torch.Tensor] = None):
        from ..vector.column import Column, Encoding

        spans = torch.stack(
            [self.starts.to(torch.int64), self.sizes.to(torch.int64)], dim=1
        )
        children = []
        for ch in self.children:
            if isinstance(ch.values, SegValue):
                children.append(ch.values.to_column(ch.validity))
            else:
                children.append(
                    Column.flat(ch.values, ch.dtype, ch.validity, ch.strings)
                )
        return Column(
            spans, validity, None, self.dtype, Encoding.FLAT, None, tuple(children)
        )


@dataclasses.dataclass
class StructValue:
    """Evaluation-time value of ROW expressions: one Elems per field."""

    fields: Tuple[Elems, ...]
    dtype: DataType  # the ROW type

    @staticmethod
    def from_column(col) -> "StructValue":
        fields = []
        for ch, ft in zip(col.children, col.dtype.children):
            if ft.kind == TypeKind.ROW:
                fields.append(
                    Elems(StructValue.from_column(ch), ch.validity, ft, None)
                )
            elif ft.is_complex:
                fields.append(
                    Elems(SegValue.from_column(ch), ch.validity, ft, None)
                )
            else:
                fields.append(Elems(ch.data, ch.validity, ft, ch.strings))
        return StructValue(tuple(fields), col.dtype)

    def to_column(self, validity: Optional[torch.Tensor] = None):
        from ..vector.column import Column, Encoding

        children = []
        capacity = None
        for f in self.fields:
            if isinstance(f.values, (SegValue, StructValue)):
                children.append(f.values.to_column(f.validity))
                capacity = capacity or (
                    f.values.capacity
                    if isinstance(f.values, SegValue)
                    else None
                )
            else:
                children.append(
                    Column.flat(f.values, f.dtype, f.validity, f.strings)
                )
                capacity = capacity or f.values.shape[0]
        placeholder = torch.zeros(
            (capacity or 1,), dtype=torch.int8, device=_device_of(self.fields[0].values)
        )
        return Column(
            placeholder, validity, None, self.dtype, Encoding.FLAT, None,
            tuple(children),
        )

    def field(self, name: str) -> Elems:
        return self.fields[self.dtype.names.index(name)]


@dataclasses.dataclass
class NormSeg:
    """A SegValue with a dense, row-ordered pool + derived index arrays."""

    seg: SegValue
    rowid: torch.Tensor  # int64[pool_cap]: owning row of each pool slot
    emask: torch.Tensor  # bool[pool_cap]: live pool slots
    # scalar bool: total elements exceeded the static pool (duplicated spans);
    # consumers surface this as a query error rather than truncate silently
    overflow: Optional[torch.Tensor] = None

    @property
    def starts(self):
        return self.seg.starts

    @property
    def sizes(self):
        return self.seg.sizes

    @property
    def children(self):
        return self.seg.children


def _take(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    idx = indices.to(torch.int64).clamp(0, max(values.shape[0] - 1, 0))
    return values.index_select(0, idx)


def _device_of(values) -> torch.device:
    if isinstance(values, SegValue):
        return values.starts.device
    if isinstance(values, StructValue):
        return _device_of(values.fields[0].values)
    return values.device


def _flatten_elems(ch: Elems):
    """Elems -> (flat tensors to gather, reassembly spec)."""
    if isinstance(ch.values, SegValue):
        # nested complex: the nested spans are pool-level arrays; nested pools
        # themselves stay put (they are indexed through the nested spans)
        arrs = [ch.values.starts, ch.values.sizes]
        spec = ("nested", ch.validity is not None)
        if ch.validity is not None:
            arrs.append(ch.validity)
        return arrs, spec
    arrs = [ch.values]
    spec = ("leaf", ch.validity is not None)
    if ch.validity is not None:
        arrs.append(ch.validity)
    return arrs, spec


def _rebuild_elems(ch: Elems, spec, pools, i):
    kind, has_validity = spec
    if kind == "nested":
        starts, sizes = pools[i], pools[i + 1]
        i += 2
        validity = None
        if has_validity:
            validity = pools[i]
            i += 1
        inner = ch.values
        return (
            Elems(
                SegValue(starts, sizes, inner.children, inner.dtype),
                validity,
                ch.dtype,
                ch.strings,
            ),
            i,
        )
    values = pools[i]
    i += 1
    validity = None
    if has_validity:
        validity = pools[i]
        i += 1
    return Elems(values, validity, ch.dtype, ch.strings), i
