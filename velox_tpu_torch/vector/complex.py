"""Host + device representation of ARRAY / MAP / ROW columns.

Counterpart of the JAX package's ``vector/complex.py``.  Reference:
velox/vector/ComplexVector.h (ArrayVector/MapVector: offsets+sizes spans over
flat element children; RowVector).

* host side: :class:`HostSegments` — dense int32 sizes + child pools as numpy
  arrays (or nested HostSegments), starts implicit (exclusive cumsum);
  :class:`HostStruct` — one row-aligned child per field;
* device side: a ``Column`` whose ``data`` is int64[capacity, 2] (start, size)
  spans and whose ``children`` hold fixed-capacity element pools.  Pool
  capacity is padded to a power of two, as in the JAX package, so that every
  function can be held against its twin there.

Variable-width strings inside pools follow the engine-wide rule: int32
dictionary codes + a host StringTable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtypes import DataType, TypeKind
from .string_table import StringTable


class _PoolRecord:
    """The largest element pool built since the last ``reset_pool_record``:
    its capacity and its live elements (an int, or a 0-d device tensor read
    only when asked for).  Reports read it (``largest_pool``); nothing in the
    engine depends on it."""

    capacity = 0
    elements = 0


def note_pool(capacity: int, elements) -> None:
    if capacity >= _PoolRecord.capacity:
        _PoolRecord.capacity, _PoolRecord.elements = capacity, elements


def reset_pool_record() -> None:
    _PoolRecord.capacity, _PoolRecord.elements = 0, 0


def largest_pool() -> Tuple[int, int]:
    """(capacity, live elements) of the largest pool noted."""
    return _PoolRecord.capacity, int(_PoolRecord.elements)


def _bucket(n: int) -> int:
    cap = 8
    while cap < n:
        cap *= 2
    return cap


def _to_device_rep(values: List[Any], dtype: DataType, table: Optional[StringTable]):
    """Python scalars -> (device-rep numpy array, validity|None, table|None)."""
    validity = np.asarray([v is not None for v in values], dtype=bool)
    has_null = not validity.all()
    if dtype.is_string:
        table = table or StringTable()
        codes = table.intern_all(["" if v is None else str(v) for v in values])
        return codes, (validity if has_null else None), table
    if dtype.kind == TypeKind.DECIMAL:
        scaled = [
            0 if v is None else int(round(float(v) * 10**dtype.scale)) for v in values
        ]
        return np.asarray(scaled, np.int64), (validity if has_null else None), None
    np_dtype = dtype.numpy_dtype
    arr = np.asarray([np_dtype.type(0) if v is None else v for v in values], np_dtype)
    return arr, (validity if has_null else None), None


def _from_device_rep(arr: np.ndarray, dtype: DataType, table: Optional[StringTable]):
    if dtype.is_string and table is not None:
        return table.decode(arr)
    if dtype.kind == TypeKind.DECIMAL:
        return arr.astype(np.float64) / 10.0**dtype.scale
    return arr


@dataclasses.dataclass
class HostSegments:
    """A host-resident ARRAY or MAP column (dense spans + child pools)."""

    dtype: DataType  # the ARRAY/MAP type itself
    sizes: np.ndarray  # int32 [n]
    children: Tuple[Any, ...]  # per child: np.ndarray | HostSegments
    child_validities: Tuple[Optional[np.ndarray], ...]
    string_tables: Tuple[Optional[StringTable], ...] = ()

    def __post_init__(self):
        if not self.string_tables:
            self.string_tables = (None,) * len(self.children)

    def __len__(self) -> int:
        return len(self.sizes)

    @property
    def starts(self) -> np.ndarray:
        c = np.cumsum(self.sizes.astype(np.int64))
        return np.concatenate([[0], c[:-1]]).astype(np.int32)

    @property
    def pool_len(self) -> int:
        return int(self.sizes.sum())

    # ---- construction ----------------------------------------------------
    @staticmethod
    def from_pylist(values: Sequence[Any], dtype: DataType):
        """Build from python lists (ARRAY) / dicts (MAP); None rows -> NULL.

        Returns (HostSegments, row_validity | None)."""
        row_validity = np.asarray([v is not None for v in values], dtype=bool)
        if dtype.kind == TypeKind.ARRAY:
            rows = [([] if v is None else list(v)) for v in values]
            sizes = np.asarray([len(r) for r in rows], np.int32)
            flat = [e for r in rows for e in r]
            elem_t = dtype.element
            if elem_t.is_complex:
                child, child_validity = HostSegments.from_pylist(flat, elem_t)
                tables: Tuple = (None,)
            else:
                child, child_validity, tab = _to_device_rep(flat, elem_t, None)
                tables = (tab,)
            seg = HostSegments(
                dtype, sizes, (child,), (child_validity,), tables
            )
        elif dtype.kind == TypeKind.MAP:
            rows = [({} if v is None else dict(v)) for v in values]
            sizes = np.asarray([len(r) for r in rows], np.int32)
            keys = [k for r in rows for k in r.keys()]
            vals = [v for r in rows for v in r.values()]
            kt, vt = dtype.key_type, dtype.value_type
            karr, kval, ktab = _to_device_rep(keys, kt, None)
            if vt.is_complex:
                varr, vval = HostSegments.from_pylist(vals, vt)
                vtab = None
            else:
                varr, vval, vtab = _to_device_rep(vals, vt, None)
            seg = HostSegments(
                dtype, sizes, (karr, varr), (kval, vval), (ktab, vtab)
            )
        else:
            raise TypeError(f"HostSegments cannot hold {dtype}")
        return seg, (None if row_validity.all() else row_validity)

    # ---- slicing (tile extraction) ---------------------------------------
    def slice_rows(self, start: int, stop: int) -> "HostSegments":
        n = len(self.sizes)
        start, stop = min(start, n), min(stop, n)
        starts = self.starts
        lo = int(starts[start]) if start < n else self.pool_len
        hi = int(starts[stop - 1] + self.sizes[stop - 1]) if stop > start else lo
        children = tuple(
            c.slice_pool(lo, hi) if isinstance(c, HostSegments) else c[lo:hi]
            for c in self.children
        )
        validities = tuple(
            None if v is None else v[lo:hi] for v in self.child_validities
        )
        return HostSegments(
            self.dtype, self.sizes[start:stop], children, validities, self.string_tables
        )

    def slice_pool(self, lo: int, hi: int) -> "HostSegments":
        """Nested use: this HostSegments IS a pool; take rows [lo, hi)."""
        return self.slice_rows(lo, hi)

    def take_rows(self, indices: np.ndarray) -> "HostSegments":
        """Row gather (re-densifies pools); indices may repeat rows."""
        idx = np.asarray(indices, np.int64)
        order = _span_order(
            self.starts.astype(np.int64)[idx], self.sizes.astype(np.int64)[idx]
        )
        children = tuple(
            c.take_rows(order) if isinstance(c, HostSegments) else c[order]
            for c in self.children
        )
        validities = tuple(
            None if v is None else v[order] for v in self.child_validities
        )
        return HostSegments(
            self.dtype,
            self.sizes[np.asarray(indices, np.int64)],
            children,
            validities,
            self.string_tables,
        )

    @staticmethod
    def concat(parts: Sequence["HostSegments"]) -> "HostSegments":
        """Row-wise concatenation (tile reassembly in the collect path)."""
        parts = list(parts)
        first = parts[0]
        sizes = np.concatenate([p.sizes for p in parts])
        children = []
        validities = []
        for i in range(len(first.children)):
            if isinstance(first.children[i], HostSegments):
                children.append(HostSegments.concat([p.children[i] for p in parts]))
            else:
                children.append(np.concatenate([p.children[i] for p in parts]))
            vs = [p.child_validities[i] for p in parts]
            if all(v is None for v in vs):
                validities.append(None)
            else:
                validities.append(
                    np.concatenate(
                        [
                            v
                            if v is not None
                            else np.ones(_child_len(p, i), dtype=bool)
                            for v, p in zip(vs, parts)
                        ]
                    )
                )
        tables = first.string_tables
        for p in parts[1:]:
            for a, b in zip(tables, p.string_tables):
                if a is not b:
                    raise TypeError(
                        "HostSegments.concat: string dictionaries must match"
                    )
        return HostSegments(
            first.dtype, sizes, tuple(children), tuple(validities), tables
        )

    # ---- egress ----------------------------------------------------------
    def to_pylist(self, row_validity: Optional[np.ndarray] = None) -> List[Any]:
        starts = self.starts
        if self.dtype.kind == TypeKind.ARRAY:
            child = self.children[0]
            if isinstance(child, HostSegments):
                elems = child.to_pylist(self.child_validities[0])
            else:
                vals = _from_device_rep(
                    child, self.dtype.element, self.string_tables[0]
                )
                cv = self.child_validities[0]
                elems = [
                    None if (cv is not None and not cv[i]) else _py(vals[i])
                    for i in range(len(vals))
                ]
            out = [
                elems[starts[i] : starts[i] + self.sizes[i]]
                for i in range(len(self.sizes))
            ]
        else:  # MAP
            karr, varr = self.children
            kvals = _from_device_rep(karr, self.dtype.key_type, self.string_tables[0])
            if isinstance(varr, HostSegments):
                vvals = varr.to_pylist(self.child_validities[1])
            else:
                raw = _from_device_rep(
                    varr, self.dtype.value_type, self.string_tables[1]
                )
                vv = self.child_validities[1]
                vvals = [
                    None if (vv is not None and not vv[i]) else _py(raw[i])
                    for i in range(len(raw))
                ]
            out = [
                {
                    _py(kvals[j]): vvals[j]
                    for j in range(starts[i], starts[i] + self.sizes[i])
                }
                for i in range(len(self.sizes))
            ]
        if row_validity is not None:
            out = [v if ok else None for v, ok in zip(out, row_validity)]
        return out

    # ---- device upload ---------------------------------------------------
    def device_column(
        self,
        capacity: int,
        validity: Optional[np.ndarray] = None,
        pool_capacity: Optional[int] = None,
    ):
        """Build the Column of this tile on the host: spans [capacity, 2] +
        padded child pools (``Column.to`` moves it to a device)."""
        from .column import Column

        n = len(self.sizes)
        assert n <= capacity
        pool_cap = pool_capacity or _bucket(max(self.pool_len, 1))
        note_pool(pool_cap, self.pool_len)
        spans = np.zeros((capacity, 2), np.int64)
        spans[:n, 0] = self.starts
        spans[:n, 1] = self.sizes
        children = []
        for c, cv, tab, ct in zip(
            self.children, self.child_validities, self.string_tables, _child_types(self.dtype)
        ):
            if isinstance(c, HostSegments):
                pad_rows = pool_cap - len(c.sizes)
                padded = c if pad_rows <= 0 else _pad_segments(c, pool_cap)
                children.append(
                    padded.device_column(
                        pool_cap,
                        None if cv is None else _pad_bool(cv, pool_cap),
                    )
                )
            else:
                arr = c
                if len(arr) < pool_cap:
                    arr = np.concatenate(
                        [arr, np.zeros(pool_cap - len(arr), arr.dtype)]
                    )
                v = None if cv is None else _pad_bool(cv, pool_cap)
                children.append(
                    Column.flat(_tensor(arr), ct, None if v is None else _tensor(v), tab)
                )
        v = None
        if validity is not None:
            v = _tensor(_pad_bool(validity, capacity))
        return Column(
            _tensor(spans), v, None, self.dtype, _FLAT(), None, tuple(children)
        )


def _FLAT():
    from .column import Encoding

    return Encoding.FLAT


def _child_types(dtype: DataType) -> Tuple[DataType, ...]:
    if dtype.kind == TypeKind.ARRAY:
        return (dtype.element,)
    if dtype.kind == TypeKind.MAP:
        return (dtype.key_type, dtype.value_type)
    raise TypeError(str(dtype))


def _pad_bool(v: np.ndarray, cap: int) -> np.ndarray:
    if len(v) >= cap:
        return v[:cap]
    return np.concatenate([v, np.zeros(cap - len(v), bool)])


def _pad_segments(seg: HostSegments, rows: int) -> HostSegments:
    pad = rows - len(seg.sizes)
    return HostSegments(
        seg.dtype,
        np.concatenate([seg.sizes, np.zeros(pad, np.int32)]),
        seg.children,
        seg.child_validities,
        seg.string_tables,
    )


@dataclasses.dataclass
class HostStruct:
    """A host-resident ROW column: one child array per field, row-aligned
    (reference: velox/vector/ComplexVector.h RowVector)."""

    dtype: DataType  # the ROW type
    children: Tuple[Any, ...]  # per field: np.ndarray | HostSegments | HostStruct
    child_validities: Tuple[Optional[np.ndarray], ...]
    string_tables: Tuple[Optional[StringTable], ...] = ()

    def __post_init__(self):
        if not self.string_tables:
            self.string_tables = (None,) * len(self.children)

    def __len__(self) -> int:
        c = self.children[0]
        return len(c)

    @staticmethod
    def from_pylist(values: Sequence[Any], dtype: DataType):
        """rows are dicts (by field name) or tuples; None -> NULL row."""
        row_validity = np.asarray([v is not None for v in values], dtype=bool)
        children, validities, tables = [], [], []
        for i, (fname, ft) in enumerate(zip(dtype.names, dtype.children)):
            field_vals = []
            for v in values:
                if v is None:
                    field_vals.append(None)
                elif isinstance(v, dict):
                    field_vals.append(v.get(fname))
                else:
                    field_vals.append(v[i])
            if ft.is_complex:
                if ft.kind == TypeKind.ROW:
                    sub, sub_valid = HostStruct.from_pylist(field_vals, ft)
                else:
                    sub, sub_valid = HostSegments.from_pylist(field_vals, ft)
                children.append(sub)
                validities.append(sub_valid)
                tables.append(None)
            else:
                arr, valid, tab = _to_device_rep(field_vals, ft, None)
                children.append(arr)
                validities.append(valid)
                tables.append(tab)
        st = HostStruct(dtype, tuple(children), tuple(validities), tuple(tables))
        return st, (None if row_validity.all() else row_validity)

    def slice_rows(self, start: int, stop: int) -> "HostStruct":
        children = tuple(
            c.slice_rows(start, stop)
            if isinstance(c, (HostSegments, HostStruct))
            else c[start:stop]
            for c in self.children
        )
        validities = tuple(
            None if v is None else v[start:stop] for v in self.child_validities
        )
        return HostStruct(self.dtype, children, validities, self.string_tables)

    def take_rows(self, indices: np.ndarray) -> "HostStruct":
        idx = np.asarray(indices, np.int64)
        children = tuple(
            c.take_rows(idx)
            if isinstance(c, (HostSegments, HostStruct))
            else c[idx]
            for c in self.children
        )
        validities = tuple(
            None if v is None else v[idx] for v in self.child_validities
        )
        return HostStruct(self.dtype, children, validities, self.string_tables)

    @staticmethod
    def concat(parts: Sequence["HostStruct"]) -> "HostStruct":
        first = parts[0]
        children, validities = [], []
        for i, c0 in enumerate(first.children):
            if isinstance(c0, HostSegments):
                children.append(HostSegments.concat([p.children[i] for p in parts]))
            elif isinstance(c0, HostStruct):
                children.append(HostStruct.concat([p.children[i] for p in parts]))
            else:
                children.append(np.concatenate([p.children[i] for p in parts]))
            vs = [p.child_validities[i] for p in parts]
            if all(v is None for v in vs):
                validities.append(None)
            else:
                validities.append(
                    np.concatenate(
                        [
                            v if v is not None else np.ones(len(p), bool)
                            for v, p in zip(vs, parts)
                        ]
                    )
                )
        return HostStruct(
            first.dtype, tuple(children), tuple(validities), first.string_tables
        )

    def to_pylist(self, row_validity: Optional[np.ndarray] = None) -> List[Any]:
        n = len(self)
        field_lists = []
        for c, cv, tab, ft in zip(
            self.children, self.child_validities, self.string_tables, self.dtype.children
        ):
            if isinstance(c, (HostSegments, HostStruct)):
                field_lists.append(c.to_pylist(cv))
            else:
                raw = _from_device_rep(c, ft, tab)
                field_lists.append(
                    [
                        None if (cv is not None and not cv[i]) else _py(raw[i])
                        for i in range(n)
                    ]
                )
        out = [
            {name: field_lists[j][i] for j, name in enumerate(self.dtype.names)}
            for i in range(n)
        ]
        if row_validity is not None:
            out = [v if ok else None for v, ok in zip(out, row_validity)]
        return out

    def device_column(
        self, capacity: int, validity: Optional[np.ndarray] = None
    ):
        from .column import Column

        n = len(self)
        children = []
        for c, cv, tab, ft in zip(
            self.children, self.child_validities, self.string_tables, self.dtype.children
        ):
            if isinstance(c, (HostSegments, HostStruct)):
                padded = c if len(c) >= capacity else _pad_rows(c, capacity)
                children.append(
                    padded.device_column(
                        capacity, None if cv is None else _pad_bool(cv, capacity)
                    )
                )
            else:
                arr = c
                if len(arr) < capacity:
                    arr = np.concatenate(
                        [arr, np.zeros(capacity - len(arr), arr.dtype)]
                    )
                v = None if cv is None else _pad_bool(cv, capacity)
                children.append(
                    Column.flat(_tensor(arr), ft, None if v is None else _tensor(v), tab)
                )
        v = None
        if validity is not None:
            v = _tensor(_pad_bool(validity, capacity))
        placeholder = torch.zeros((capacity,), dtype=torch.int8)
        return Column(
            placeholder, v, None, self.dtype, _FLAT(), None, tuple(children)
        )


def _pad_rows(c, rows: int):
    if isinstance(c, HostSegments):
        return _pad_segments(c, rows)
    pad = rows - len(c)
    children = tuple(
        np.concatenate([ch, np.zeros(pad, ch.dtype)])
        if isinstance(ch, np.ndarray)
        else _pad_rows(ch, rows)
        for ch in c.children
    )
    validities = tuple(
        None if v is None else np.concatenate([v, np.zeros(pad, bool)])
        for v in c.child_validities
    )
    return HostStruct(c.dtype, children, validities, c.string_tables)


def _child_len(seg: "HostSegments", i: int) -> int:
    c = seg.children[i]
    return len(c.sizes) if isinstance(c, HostSegments) else len(c)


def _span_order(starts: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """The pool positions of the spans (starts[i], sizes[i]), span after span:
    the concatenation of ``arange(starts[i], starts[i] + sizes[i])``, built
    with one repeat instead of a loop over rows."""
    sizes = np.asarray(sizes, np.int64)
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    dense = np.cumsum(sizes) - sizes
    return np.repeat(np.asarray(starts, np.int64) - dense, sizes) + np.arange(total)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _py(v):
    """numpy scalar -> python scalar for host lists."""
    if isinstance(v, np.generic):
        return v.item()
    return v


def column_to_host(col, length: int):
    """Fetch a device complex Column back into HostSegments / HostStruct
    (first ``length`` rows; ARRAY/MAP pools re-densify host-side)."""
    if col.dtype.kind == TypeKind.ROW:
        validity = None if col.validity is None else _np(col.validity)[:length]
        children, validities, tables = [], [], []
        for child, ft in zip(col.children, col.dtype.children):
            if ft.is_complex:
                sub, sub_valid = column_to_host(child, length)
                children.append(sub)
                validities.append(sub_valid)
                tables.append(None)
            else:
                children.append(_np(child.data)[:length])
                validities.append(
                    None
                    if child.validity is None
                    else _np(child.validity)[:length]
                )
                tables.append(child.strings)
        return (
            HostStruct(
                col.dtype, tuple(children), tuple(validities), tuple(tables)
            ),
            validity,
        )
    spans = _np(col.data)[:length]
    starts, sizes = spans[:, 0].astype(np.int64), spans[:, 1].astype(np.int64)
    validity = None if col.validity is None else _np(col.validity)[:length]
    # defensive clamp: spans beyond the pool only occur on errored batches
    # (pool overflow), which the executor rejects before assembly
    pool_len = col.children[0].capacity if col.children else 0
    starts = np.clip(starts, 0, max(pool_len - 1, 0))
    sizes = np.clip(sizes, 0, np.maximum(pool_len - starts, 0))
    order = _span_order(starts, sizes)
    children, validities, tables = [], [], []
    for child, ct in zip(col.children, _child_types(col.dtype)):
        if ct.is_complex:
            sub, sub_validity = column_to_host(child, child.capacity)
            children.append(sub.take_rows(order))
            validities.append(None if sub_validity is None else sub_validity[order])
            tables.append(None)
        else:
            arr = _np(child.data)
            children.append(arr[order] if len(order) else arr[:0])
            cv = None if child.validity is None else _np(child.validity)[order]
            validities.append(cv)
            tables.append(child.strings)
    return (
        HostSegments(
            col.dtype,
            sizes.astype(np.int32),
            tuple(children),
            tuple(validities),
            tuple(tables),
        ),
        validity,
    )
