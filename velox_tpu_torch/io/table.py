"""Host-side table abstraction: the ingest boundary of the engine.

Counterpart of the JAX package's ``io/table.py``.  Reference: the reader half
of velox/dwio/common/Reader.h:162 + the connector DataSource contract
(velox/connectors/Connector.h:163).  The host side owns variable-width data;
the device only ever sees fixed-width column tiles.  A ``Table`` is the
materialized host form: numpy columns + string tables, sliced into device
``Batch`` tiles by the scan.

Parquet / Arrow / ORC round-trips are not ported yet; those methods raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import RowType, TypeKind
from ..vector.column import Batch, Column
from ..vector.string_table import StringTable


@dataclasses.dataclass
class Table:
    """An immutable host-resident table in device-ready layout.

    Columns are numpy arrays in the *device representation* already: decimals are
    unscaled int64, dates int32 days, strings int32 codes into ``string_tables``.
    """

    schema: RowType
    columns: Dict[str, np.ndarray]
    string_tables: Dict[str, StringTable] = dataclasses.field(default_factory=dict)
    validities: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # lazily-computed per-column (min, max) over the raw device representation
    # (reference: dwio/common/Statistics.h column stats)
    _bounds: Dict[str, Optional[tuple]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def column_bounds(self, name: str) -> Optional[tuple]:
        """Inclusive (lo, hi) int bounds of an integer-representation column,
        computed once and cached; None for float/complex columns."""
        if name in self._bounds:
            return self._bounds[name]
        out = None
        dtype = self.schema.type_of(name)
        if not dtype.is_complex:
            arr = self.columns.get(name)
            if (
                arr is not None
                and len(arr)
                and np.issubdtype(np.asarray(arr).dtype, np.integer)
            ):
                a = np.asarray(arr)
                out = (int(a.min()), int(a.max()))
        self._bounds[name] = out
        return out

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    def select(self, names: Sequence[str]) -> "Table":
        schema = RowType(list(names), [self.schema.type_of(n) for n in names])
        out = Table(
            schema,
            {n: self.columns[n] for n in names},
            {n: t for n, t in self.string_tables.items() if n in names},
            {n: v for n, v in self.validities.items() if n in names},
        )
        # column statistics stay valid for the projected view
        out._bounds.update({n: b for n, b in self._bounds.items() if n in names})
        return out

    # ---- batch slicing ---------------------------------------------------
    def num_tiles(self, tile_rows: int) -> int:
        return max(1, -(-self.num_rows // tile_rows))

    def _narrow_dtype(self, name: str, dtype, arr: np.ndarray) -> np.dtype:
        """The narrowest of int8/16/32 that the column's table-wide bounds
        allow, or the array's own dtype."""
        have = np.asarray(arr).dtype
        if not (
            np.issubdtype(have, np.integer)
            and dtype.numpy_dtype.kind == "i"
            and not dtype.is_long_decimal
            and not dtype.is_string
        ):
            return have
        b = self.column_bounds(name)
        if b is None:
            return have
        for cand in (np.int8, np.int16, np.int32):
            info = np.iinfo(cand)
            if b[0] >= info.min and b[1] <= info.max:
                if np.dtype(cand).itemsize < have.itemsize:
                    return np.dtype(cand)
                break
        return have

    def tile(self, index: int, tile_rows: int, device=None) -> Batch:
        """Materialize tile ``index`` as a fixed-capacity Batch (zero-padded)
        on ``device`` (None = the CUDA device).

        Integer columns ship at the NARROWEST width their cached table-wide
        bounds allow (int8/16/32) and widen on the device at first decode
        (Column._widen), so the bytes over the host link and the bytes a scan
        kernel reads scale with the data's true range, not its declared type.
        Reference analog: the selective readers' narrow decode paths
        (dwio/common/SelectiveColumnReader.h).  On CUDA the tile is staged in
        pinned memory and copied with ``non_blocking=True``.
        """
        device = resolve_device(device)
        start = index * tile_rows
        stop = min(start + tile_rows, self.num_rows)
        n = max(0, stop - start)
        cols: List[Column] = []
        for name, dtype in zip(self.schema.names, self.schema.types):
            if dtype.is_complex:
                # HostSegments / HostStruct (vector/complex.py): spans and
                # power-of-two element pools of this tile's rows
                validity = self.validities.get(name)
                if validity is not None:
                    validity = validity[start:stop]
                cols.append(
                    self.columns[name]
                    .slice_rows(start, stop)
                    .device_column(tile_rows, validity)
                )
                continue
            arr = np.asarray(self.columns[name][start:stop])
            narrow = self._narrow_dtype(name, dtype, arr)
            if narrow != arr.dtype:
                arr = arr.astype(narrow)
            if n < tile_rows:
                pad_shape = (tile_rows - n,) + np.shape(arr)[1:]
                arr = np.concatenate([arr, np.zeros(pad_shape, dtype=arr.dtype)])
            validity = self.validities.get(name)
            if validity is not None:
                validity = validity[start:stop]
                if n < tile_rows:
                    validity = np.concatenate(
                        [validity, np.zeros(tile_rows - n, dtype=bool)]
                    )
            cols.append(
                Column.from_numpy(
                    arr, dtype, validity, self.string_tables.get(name)
                )
            )
        batch = Batch.make(
            self.schema, cols, n, capacity=tile_rows, row_offset=start,
            device=torch.device("cpu"),
        )
        if device.type == "cuda":
            batch = _pin(batch).to(device, non_blocking=True)
        return batch

    def tiles(self, tile_rows: int, device=None) -> Iterator[Batch]:
        for i in range(self.num_tiles(tile_rows)):
            yield self.tile(i, tile_rows, device)

    def device_tiles(self, tile_rows: int, device=None) -> List[Batch]:
        """Materialize all tiles device-resident up front (tables live in
        device memory in this engine's steady state)."""
        return [
            self.tile(i, tile_rows, device)
            for i in range(self.num_tiles(tile_rows))
        ]

    # ---- pandas ----------------------------------------------------------
    def to_pandas(self, decode: bool = True):
        import pandas as pd

        out = {}
        for name, dtype in zip(self.schema.names, self.schema.types):
            arr = self.columns[name]
            if dtype.is_complex:
                lst = arr.to_pylist(self.validities.get(name))
                obj = np.empty(len(lst), dtype=object)
                obj[:] = lst
                out[name] = obj
                continue
            if decode and dtype.is_string and name in self.string_tables:
                arr = self.string_tables[name].decode(arr)
            elif decode and dtype.is_long_decimal:
                from decimal import Context, Decimal

                from ..ops.int128 import np_to_int

                # 50-digit context: the default (28) would round 38-digit
                # unscaled values during the scaleb
                cx = Context(prec=50)
                ints = np_to_int(arr[:, 1], arr[:, 0])
                arr = np.empty(len(ints), dtype=object)
                arr[:] = [Decimal(v).scaleb(-dtype.scale, cx) for v in ints]
            elif decode and dtype.kind == TypeKind.DECIMAL:
                arr = arr.astype(np.float64) / 10.0**dtype.scale
            validity = self.validities.get(name)
            if validity is not None and not validity.all():
                arr = arr.astype(object)
                arr = arr.copy()
                arr[~validity] = None
            out[name] = arr
        return pd.DataFrame(out)

    # ---- file formats (later slices) ---------------------------------------
    def save_parquet(self, path: str) -> None:
        raise NotImplementedError("parquet I/O is not ported yet")

    @staticmethod
    def load_parquet(path: str, columns=None, ranges=None) -> "Table":
        raise NotImplementedError("parquet I/O is not ported yet")

    @staticmethod
    def from_arrow(reader) -> "Table":
        raise NotImplementedError("Arrow ingestion is not ported yet")


def _pin(batch: Batch) -> Batch:
    """The batch with every host tensor copied into page-locked memory, so
    the following upload can be asynchronous."""

    def pin(c: Column) -> Column:
        return dataclasses.replace(
            c,
            data=c.data.pin_memory(),
            validity=None if c.validity is None else c.validity.pin_memory(),
            base=None if c.base is None else pin(c.base),
            children=tuple(pin(ch) for ch in c.children),
        )

    return dataclasses.replace(batch, columns=tuple(pin(c) for c in batch.columns))
