"""Columnar batch layer on torch tensors.

Counterpart of the JAX package's ``vector/column.py``.  Reference:
velox/vector/BaseVector.h:69 (BaseVector + Flat/Constant/Dictionary encodings,
VectorEncoding.h:32), velox/vector/DecodedVector.h:76,
velox/vector/SelectivityVector.h:39.

* A ``Column`` is a struct of fixed-capacity tensors; a ``Batch`` holds the
  columns of one tile.  The row count rides along as a 0-d int32 tensor
  (``Batch.length``) so no operator has to read it back to the host; rows
  beyond it are padding.
* The reference's SelectivityVector is ``Batch.selection``: a boolean mask over
  the capacity.  Filters narrow the mask; nothing is compacted on this path.
* Encodings FLAT / CONSTANT / DICTIONARY are kept because they are algebraic
  (eval-on-base + gather).  SEQUENCE (run lengths over per-run values) and
  BIAS (narrow deltas from one 64-bit bias) are the reference's
  SequenceVector and BiasVector.  A SEQUENCE column decodes with a binary
  search of the run ends, O(rows x log runs), where the JAX package compares
  every row with every run end.
* ``decode`` is the DecodedVector analog: collapse any encoding to
  (values, validity).  Narrow integer uploads widen here.
* Strings on device are always int32 dictionary codes (see string_table.py).
* ARRAY / MAP / ROW columns carry spans and element pools (``children``;
  vector/complex.py).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..dtypes import DataType, RowType, TypeKind
from .string_table import StringTable


class Encoding(str, Enum):
    FLAT = "FLAT"
    CONSTANT = "CONSTANT"
    DICTIONARY = "DICTIONARY"
    # run-length runs over a base of run values (velox SequenceVector,
    # vector/VectorEncoding.h:32): ``data`` holds int32 run LENGTHS, ``base``
    # the per-run values
    SEQUENCE = "SEQUENCE"
    # narrow deltas from a shared bias value (velox BiasVector): ``base`` is
    # a CONSTANT column carrying the bias, ``data`` the narrow (int8/int16/
    # int32) deltas; decode() widens and adds
    BIAS = "BIAS"


def _take_clamped(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """values[indices] along dim 0 with out-of-range indices clamped to the
    ends (the JAX package's ``jnp.take(..., mode="clip")``)."""
    idx = indices.to(torch.int64).clamp(0, max(values.shape[0] - 1, 0))
    return values.index_select(0, idx)


def _run_index(lengths: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Run of each row position: the count of run ends at or before it, by a
    binary search of the run ends (the JAX package sums a [rows, runs]
    compare, which is the same count)."""
    ends = torch.cumsum(lengths.to(torch.int64), 0)
    return torch.searchsorted(ends, rows.to(torch.int64), right=True, out_int32=True)


@dataclasses.dataclass
class Column:
    """One column of a Batch.

    data:
      FLAT        -> values, shape [capacity]
      CONSTANT    -> scalar value, shape ()
      DICTIONARY  -> int32 indices into ``base``, shape [capacity]
    validity: optional bool tensor (True = valid / not NULL), shaped like data.
    base: the dictionary's base column (FLAT), present iff DICTIONARY.
    """

    data: torch.Tensor
    validity: Optional[torch.Tensor]
    base: Optional["Column"]
    dtype: DataType
    encoding: Encoding
    strings: Optional[StringTable] = None
    # ARRAY/MAP: ``data`` is int64[capacity, 2] (start, size) spans and
    # ``children`` holds the element pool column(s) (ARRAY: one, MAP: key +
    # value) with their own pool capacity (velox ArrayVector/MapVector
    # analog); ROW: ``data`` is a placeholder and ``children`` the row-aligned
    # fields (vector/complex.py).
    children: Tuple["Column", ...] = ()

    # ---- constructors ----------------------------------------------------
    @staticmethod
    def flat(
        data: torch.Tensor,
        dtype: DataType,
        validity: Optional[torch.Tensor] = None,
        strings: Optional[StringTable] = None,
    ) -> "Column":
        return Column(data, validity, None, dtype, Encoding.FLAT, strings)

    @staticmethod
    def constant(
        value,
        dtype: DataType,
        is_null: bool = False,
        strings: Optional[StringTable] = None,
        device=None,
    ) -> "Column":
        data = torch.tensor(value, dtype=dtype.device_dtype, device=device)
        validity = torch.tensor(False, device=device) if is_null else None
        return Column(data, validity, None, dtype, Encoding.CONSTANT, strings)

    @staticmethod
    def dictionary(
        indices: torch.Tensor,
        base: "Column",
        validity: Optional[torch.Tensor] = None,
    ) -> "Column":
        assert base.encoding == Encoding.FLAT, "dictionary base must be flat"
        return Column(
            indices, validity, base, base.dtype, Encoding.DICTIONARY, base.strings
        )

    @staticmethod
    def sequence(run_values: "Column", run_lengths, capacity: int) -> "Column":
        """Run-length column: row r takes the value of the run containing r.

        ``run_values`` is a FLAT column of per-run values (its validity is
        the per-run null flag); ``run_lengths`` the matching run lengths,
        which must sum to ``capacity``.  Reference: velox SequenceVector
        (vector/SequenceVector.h)."""
        assert run_values.encoding == Encoding.FLAT, "sequence base must be flat"
        lengths = torch.as_tensor(
            run_lengths, dtype=torch.int32, device=run_values.device
        )
        assert lengths.shape[0] == run_values.capacity
        assert int(lengths.sum()) == capacity, "run lengths must sum to capacity"
        return Column(
            lengths, None, run_values, run_values.dtype, Encoding.SEQUENCE,
            run_values.strings,
        )

    @staticmethod
    def bias(
        bias_value,
        deltas,
        dtype: DataType,
        validity=None,
    ) -> "Column":
        """Bias column: value[r] = bias + deltas[r], deltas stored narrow.

        Reference: velox BiasVector (vector/BiasVector.h): a 64-bit column
        whose values cluster near a center stores 1/2/4-byte deltas."""
        d = torch.as_tensor(deltas)
        assert not d.is_floating_point() and d.dtype != torch.bool
        base = Column.constant(bias_value, dtype, device=d.device)
        if validity is not None:
            validity = torch.as_tensor(validity, dtype=torch.bool, device=d.device)
        return Column(d, validity, base, dtype, Encoding.BIAS, None)

    # ---- shape -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        if self.encoding == Encoding.CONSTANT:
            raise ValueError("constant column has no capacity; use batch capacity")
        if self.encoding == Encoding.SEQUENCE:
            # data holds run lengths, not rows: the row capacity comes from
            # the batch (like CONSTANT)
            raise ValueError("sequence column has no row capacity; use batch capacity")
        return self.data.shape[0]

    @property
    def is_constant(self) -> bool:
        return self.encoding == Encoding.CONSTANT

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device, non_blocking: bool = False) -> "Column":
        """This column with every tensor moved to ``device``."""
        return dataclasses.replace(
            self,
            data=self.data.to(device, non_blocking=non_blocking),
            validity=None
            if self.validity is None
            else self.validity.to(device, non_blocking=non_blocking),
            base=None
            if self.base is None
            else self.base.to(device, non_blocking=non_blocking),
            children=tuple(c.to(device, non_blocking) for c in self.children),
        )

    # ---- DecodedVector analog -------------------------------------------
    def decode(self, capacity: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Collapse any encoding stack to (flat values[capacity], validity|None).

        Reference: velox/vector/DecodedVector.h:76.
        """
        if self.encoding == Encoding.FLAT:
            return self._widen(self.data), self.validity
        if self.encoding == Encoding.CONSTANT:
            values = self._widen(self.data).expand((capacity,) + self.data.shape[1:])
            if self.validity is None:
                return values, None
            return values, self.validity.expand((capacity,))
        if self.encoding == Encoding.DICTIONARY:
            base_values, base_validity = self.base.data, self.base.validity
            values = self._widen(_take_clamped(base_values, self.data))
            validity = self.validity
            if base_validity is not None:
                inner = _take_clamped(base_validity, self.data)
                validity = inner if validity is None else (validity & inner)
            return values, validity
        if self.encoding == Encoding.SEQUENCE:
            rows = torch.arange(capacity, dtype=torch.int64, device=self.device)
            run_idx = _run_index(self.data, rows)
            values = self._widen(_take_clamped(self.base.data, run_idx))
            validity = None
            if self.base.validity is not None:
                validity = _take_clamped(self.base.validity, run_idx)
            return values, validity
        # BIAS
        wide = self.dtype.device_dtype
        return self.base.data.to(wide) + self.data.to(wide), self.validity

    def _widen(self, values: torch.Tensor) -> torch.Tensor:
        """Narrow-on-the-wire columns (int8/16/32 uploads of wider integer
        data, Table.tile) widen at first decode."""
        if self.dtype.is_complex:
            return values
        want = self.dtype.device_dtype
        if values.dtype != want and not self.dtype.is_string:
            return values.to(want)
        return values

    def values(self, capacity: int) -> torch.Tensor:
        return self.decode(capacity)[0]

    def validity_or_true(self, capacity: int) -> torch.Tensor:
        _, v = self.decode(capacity)
        if v is None:
            return torch.ones((capacity,), dtype=torch.bool, device=self.device)
        return v

    # ---- transforms ------------------------------------------------------
    def gather(self, indices: torch.Tensor) -> "Column":
        """Row-reordering gather; result is FLAT with the indices' length."""
        if self.dtype.is_complex:
            # ARRAY/MAP: spans move with the rows; element pools stay put
            # (consumers re-densify via ops.segpool.normalize when they need
            # row order).  ROW: children are row-aligned and gather with us.
            data = _take_clamped(self.data, indices)
            validity = (
                None
                if self.validity is None
                else _take_clamped(self.validity, indices)
            )
            children = self.children
            if self.dtype.kind == TypeKind.ROW:
                children = tuple(c.gather(indices) for c in children)
            return dataclasses.replace(
                self, data=data, validity=validity, children=children
            )
        if self.encoding == Encoding.CONSTANT:
            cap = indices.shape[0]
            values, validity = self.decode(cap)
            return Column.flat(values, self.dtype, validity, self.strings)
        if self.encoding == Encoding.SEQUENCE:
            # compose: map gathered row positions to run indices, come back
            # as a DICTIONARY over the run values (no materialization)
            return Column.dictionary(_run_index(self.data, indices), self.base, None)
        validity = (
            None
            if self.validity is None
            else _take_clamped(self.validity, indices)
        )
        if self.encoding == Encoding.DICTIONARY:
            # Compose index arrays instead of materializing the gather.
            new_idx = _take_clamped(self.data, indices)
            return Column.dictionary(new_idx, self.base, validity)
        data = _take_clamped(self.data, indices)
        if self.encoding == Encoding.BIAS:
            # deltas gathered, the bias kept
            return dataclasses.replace(self, data=data, validity=validity)
        return Column.flat(data, self.dtype, validity, self.strings)

    def flatten(self, capacity: int) -> "Column":
        if self.dtype.is_complex:
            return self  # complex columns are always span+pool form
        values, validity = self.decode(capacity)
        return Column.flat(values, self.dtype, validity, self.strings)

    # ---- host interop ----------------------------------------------------
    @staticmethod
    def from_numpy(
        arr: np.ndarray,
        dtype: DataType,
        validity: Optional[np.ndarray] = None,
        strings: Optional[StringTable] = None,
        device=None,
    ) -> "Column":
        """Build a FLAT column from host data.  ``device`` None keeps the
        tensors on the host (they share memory with ``arr`` where possible)."""
        if dtype.is_string and arr.dtype.kind in ("U", "S", "O"):
            table = strings if strings is not None else StringTable()
            # VARBINARY values are bytes and must round-trip as bytes
            codes = table.intern_all(
                ["" if v is None else (v if isinstance(v, bytes) else str(v))
                 for v in arr]
            )
            arr, strings = codes, table
        np_arr = np.asarray(arr)
        np_arr = np_arr.astype(Column.host_dtype(np_arr.dtype, dtype), copy=False)
        data = _host_tensor(np_arr)
        v = None
        if validity is not None:
            v = _host_tensor(np.asarray(validity, dtype=np.bool_))
        col = Column.flat(data, dtype, v, strings)
        return col if device is None else col.to(device)

    @staticmethod
    def host_dtype(have: np.dtype, dtype: DataType) -> np.dtype:
        """The dtype ``from_numpy`` keeps an array of dtype ``have`` in:
        anything but a narrow integer upload converts on the host; narrow
        integers ship as they are and decode() widens them."""
        want = dtype.numpy_dtype
        if (
            not dtype.is_string
            and have.kind in ("i", "u", "b")
            and want.kind == "i"
            and have.itemsize <= want.itemsize
        ):
            return have
        return want

    def to_numpy(self, length: int, decode_strings: bool = True):
        """Materialize the first ``length`` rows on the host.

        Returns (values, validity_or_None); strings decode to object arrays,
        ARRAY/MAP/ROW columns to object arrays of python lists/dicts.
        """
        if self.dtype.is_complex:
            from .complex import column_to_host

            seg, validity = column_to_host(self, length)
            values = np.empty(length, dtype=object)
            values[:] = seg.to_pylist()
            return values, validity
        cap = (
            length
            if self.is_constant or self.encoding == Encoding.SEQUENCE
            else self.capacity
        )
        values, validity = self.decode(cap)
        values = values.cpu().numpy()[:length]
        validity_np = None if validity is None else validity.cpu().numpy()[:length]
        if self.dtype.is_string and self.strings is not None and decode_strings:
            values = self.strings.decode(values)
        if self.dtype.kind == TypeKind.DECIMAL:
            values = values.astype(np.float64) / (10.0 ** self.dtype.scale)
        return values, validity_np


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


@dataclasses.dataclass
class Batch:
    """A fixed-capacity batch of rows: the reference's RowVector + SelectivityVector.

    ``length`` (0-d int32 tensor) is the number of materialized rows;
    ``selection`` optionally masks a subset of them as live.  Rows in
    [length, capacity) are padding and always dead.
    """

    columns: Tuple[Column, ...]
    length: torch.Tensor
    selection: Optional[torch.Tensor]
    schema: RowType
    capacity: int
    # global row index of this tile's first row
    row_offset: Optional[torch.Tensor] = None

    # ---- constructors ----------------------------------------------------
    @staticmethod
    def make(
        schema: RowType,
        columns: Sequence[Column],
        length: Union[int, torch.Tensor],
        selection: Optional[torch.Tensor] = None,
        capacity: Optional[int] = None,
        row_offset: Union[int, torch.Tensor, None] = None,
        device=None,
    ) -> "Batch":
        if capacity is None:
            capacity = next(
                c.capacity
                for c in columns
                if c.encoding not in (Encoding.CONSTANT, Encoding.SEQUENCE)
            )
        if device is None:
            device = next(
                (c.device for c in columns), torch.device("cpu")
            )
        return Batch(
            tuple(columns),
            torch.as_tensor(length, dtype=torch.int32, device=device),
            selection,
            schema,
            capacity,
            None
            if row_offset is None
            else torch.as_tensor(row_offset, dtype=torch.int64, device=device),
        )

    @staticmethod
    def from_numpy(
        schema: RowType,
        arrays: Sequence[np.ndarray],
        validities: Optional[Sequence[Optional[np.ndarray]]] = None,
        string_tables: Optional[Sequence[Optional[StringTable]]] = None,
        capacity: Optional[int] = None,
        device=None,
    ) -> "Batch":
        n = len(arrays[0]) if arrays else 0
        cap = capacity if capacity is not None else max(n, 1)
        cols = []
        for i, (name, dtype) in enumerate(zip(schema.names, schema.types)):
            arr = np.asarray(arrays[i])
            validity = validities[i] if validities else None
            table = string_tables[i] if string_tables else None
            if len(arr) < cap:
                pad = cap - len(arr)
                if arr.dtype.kind in ("U", "S", "O"):
                    arr = np.concatenate([arr, np.asarray([""] * pad, dtype=object)])
                else:
                    arr = np.concatenate([arr, np.zeros(pad, dtype=arr.dtype)])
                if validity is not None:
                    validity = np.concatenate([validity, np.zeros(pad, dtype=bool)])
            cols.append(Column.from_numpy(arr, dtype, validity, table, device))
        return Batch.make(schema, cols, n, capacity=cap, device=device)

    # ---- access ----------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.length.device

    def to(self, device, non_blocking: bool = False) -> "Batch":
        """This batch with every tensor moved to ``device``."""
        mv = lambda t: None if t is None else t.to(device, non_blocking=non_blocking)  # noqa: E731
        return dataclasses.replace(
            self,
            columns=tuple(c.to(device, non_blocking) for c in self.columns),
            length=mv(self.length),
            selection=mv(self.selection),
            row_offset=mv(self.row_offset),
        )

    def column(self, name: str) -> Column:
        return self.columns[self.schema.index_of(name)]

    def active_mask(self) -> torch.Tensor:
        """bool[capacity]: rows that are materialized AND selected."""
        mask = (
            torch.arange(self.capacity, dtype=torch.int32, device=self.device)
            < self.length
        )
        if self.selection is not None:
            mask = mask & self.selection
        return mask

    def num_active(self) -> torch.Tensor:
        if self.selection is None:
            return self.length
        return self.active_mask().sum().to(torch.int32)

    # ---- transforms ------------------------------------------------------
    def with_selection(self, selection: torch.Tensor) -> "Batch":
        if self.selection is not None:
            selection = selection & self.selection
        return dataclasses.replace(self, selection=selection)

    def project(self, names: Sequence[str], schema: Optional[RowType] = None) -> "Batch":
        cols = tuple(self.column(n) for n in names)
        schema = schema or RowType(names, [self.schema.type_of(n) for n in names])
        return dataclasses.replace(self, columns=cols, schema=schema)

    def with_columns(self, schema: RowType, columns: Sequence[Column]) -> "Batch":
        return dataclasses.replace(self, columns=tuple(columns), schema=schema)

    # ---- host interop ----------------------------------------------------
    def to_pydict(self, decode_strings: bool = True) -> dict:
        """Materialize live rows host-side as {name: numpy array} (None for NULL)."""
        n = int(self.length)
        if self.selection is not None:
            keep = self.active_mask().cpu().numpy()
        else:
            keep = None
        out = {}
        for name, col in zip(self.schema.names, self.columns):
            values, validity = col.to_numpy(n, decode_strings=decode_strings)
            if keep is not None:
                values = values[keep[:n]]
                validity = None if validity is None else validity[keep[:n]]
            if validity is not None and not validity.all():
                values = values.astype(object)
                values[~validity] = None
            out[name] = values
        return out

    def to_pandas(self, decode_strings: bool = True):
        import pandas as pd

        return pd.DataFrame(self.to_pydict(decode_strings=decode_strings))
