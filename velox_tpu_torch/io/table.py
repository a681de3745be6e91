"""Host-side table abstraction: the ingest boundary of the engine.

Counterpart of the JAX package's ``io/table.py``.  Reference: the reader half
of velox/dwio/common/Reader.h:162 + the connector DataSource contract
(velox/connectors/Connector.h:163).  The host side owns variable-width data;
the device only ever sees fixed-width column tiles.  A ``Table`` is the
materialized host form: numpy columns + string tables, sliced into device
``Batch`` tiles by the scan.

Parquet / Arrow / ORC round-trips go through pyarrow, imported inside the
functions that use it (the reference similarly wraps Arrow for its Parquet
writer, velox/dwio/parquet/writer/).  The file formats are the JAX package's
byte for byte: each column's logical type rides in the parquet schema metadata
under the ``velox_tpu:`` key prefix, so either package reads the other's
files.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import DataType, RowType, TypeKind
from ..utils.trace import span
from ..vector.column import Batch, Column
from ..vector.string_table import StringTable


@dataclasses.dataclass
class Table:
    """An immutable host-resident table in device-ready layout.

    Columns are numpy arrays in the *device representation* already: decimals are
    unscaled int64, dates int32 days, strings int32 codes into ``string_tables``.

    A streaming scan to CUDA (``tiles``) keeps each numeric column's tile as it
    wrote it into page-locked memory (narrowed, padded) and uploads every later
    scan of that tile from it.  The kept bytes are shared with the table's
    ``select`` views, live as long as the table and its views, and go with
    them; so no column array may be written once a scan has read it.
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
    # the streaming scan's page-locked tiles by (id of the column or validity
    # array, first row, stop row, upload dtype, capacity) -> (array, tensor);
    # the array is held so that its id is not reused while the entry lives
    _kept: Dict[tuple, tuple] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
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
        # column statistics stay valid for the projected view, and its scans
        # share the page-locked tiles (keyed by column array)
        out._bounds.update({n: b for n, b in self._bounds.items() if n in names})
        out._kept = self._kept
        return out

    @staticmethod
    def concat(parts: Sequence["Table"]) -> "Table":
        """Row-concatenate same-schema tables, unifying the parts' string
        dictionaries into one (codes are remapped part by part); complex
        columns raise NotImplementedError, as in the JAX package."""
        parts = list(parts)
        schema = parts[0].schema
        for p in parts[1:]:
            if p.schema != schema:
                raise ValueError(f"Table.concat over different schemas: {schema} vs {p.schema}")
        cols: Dict[str, np.ndarray] = {}
        tables: Dict[str, StringTable] = {}
        validities: Dict[str, np.ndarray] = {}
        for name, dtype in zip(schema.names, schema.types):
            if dtype.is_complex:
                raise NotImplementedError("Table.concat over complex-typed columns")
            if dtype.is_string:
                st = StringTable()
                chunks = []
                for p in parts:
                    remap = st.intern_all(list(p.string_tables[name].values()))
                    chunks.append(np.asarray(remap)[np.asarray(p.columns[name])])
                cols[name] = np.concatenate(chunks)
                tables[name] = st
            else:
                cols[name] = np.concatenate([np.asarray(p.columns[name]) for p in parts])
            if any(name in p.validities for p in parts):
                validities[name] = np.concatenate([
                    np.asarray(p.validities.get(name, np.ones(p.num_rows, dtype=bool)))
                    for p in parts
                ])
        return Table(schema, cols, tables, validities)

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

    def _upload_dtype(self, name: str, dtype) -> np.dtype:
        """The host dtype a non-complex column's tiles ship in: the narrowest
        its bounds allow (``_narrow_dtype``), as ``Column`` keeps it."""
        have = np.asarray(self.columns[name])
        return Column.host_dtype(self._narrow_dtype(name, dtype, have), dtype)

    def tile_bytes(self, tile_rows: int) -> int:
        """The bytes ``exec/memory.py batch_bytes`` counts in every tile of
        ``tile_rows`` rows: a tile is padded to ``tile_rows``, and a column's
        upload width and validity are the same in each tile."""
        total = 0
        for name, dtype in zip(self.schema.names, self.schema.types):
            if dtype.is_complex:
                # an ARRAY's or MAP's spans [rows, 2] of int64, a ROW's int8
                # placeholder (the child pools are not counted)
                width = 16 if dtype.kind in (TypeKind.ARRAY, TypeKind.MAP) else 1
            else:
                shape = np.shape(self.columns[name])
                width = self._upload_dtype(name, dtype).itemsize * int(np.prod(shape[1:]))
            total += tile_rows * (width + (self.validities.get(name) is not None))
        return total

    def tile(self, index: int, tile_rows: int, device=None) -> Batch:
        """Materialize tile ``index`` as a fixed-capacity Batch (zero-padded)
        on ``device`` (None = the CUDA device).

        Integer columns ship at the NARROWEST width their cached table-wide
        bounds allow (int8/16/32) and widen on the device at first decode
        (Column._widen), so the bytes over the host link and the bytes a scan
        kernel reads scale with the data's true range, not its declared type.
        Reference analog: the selective readers' narrow decode paths
        (dwio/common/SelectiveColumnReader.h).  On CUDA the tile is staged in
        page-locked memory and copied with ``non_blocking=True``; the staging
        is not kept (``tiles`` keeps it).  The trace's span is
        ``velox.tile[bytes=N,staged=M]``: N the tile's bytes (``tile_bytes``),
        M the part of them the call wrote into page-locked memory.
        """
        return self._scan(index, tile_rows, resolve_device(device), keep=False)

    def tiles(self, tile_rows: int, device=None) -> Iterator[Batch]:
        """The streaming scan: tile after tile, each numeric column's staging
        kept for the next scan of the table or of a view of it (the class
        docstring); a kept tile's span reads ``staged=0``."""
        device = resolve_device(device)
        for i in range(self.num_tiles(tile_rows)):
            yield self._scan(i, tile_rows, device, keep=True)

    def device_tiles(self, tile_rows: int, device=None) -> List[Batch]:
        """Materialize all tiles device-resident up front (tables live in
        device memory in this engine's steady state); their staging is not
        kept, since the tiles stay on the device."""
        return [
            self.tile(i, tile_rows, device)
            for i in range(self.num_tiles(tile_rows))
        ]

    def kept_bytes(self) -> int:
        """The page-locked bytes the table and its views keep for their
        streaming scans."""
        return sum(t.nbytes for _, t in self._kept.values())

    def _scan(self, index: int, tile_rows: int, device: torch.device, keep: bool) -> Batch:
        with span("tile", lambda: {
            "bytes": self.tile_bytes(tile_rows),
            "staged": self._staged_bytes(index, tile_rows, device, keep),
        }):
            return self._tile(index, tile_rows, device, keep)

    def _rows(self, index: int, tile_rows: int) -> tuple:
        start = index * tile_rows
        return start, min(start + tile_rows, self.num_rows)

    def _staged_parts(self, index: int, tile_rows: int) -> Iterator[tuple]:
        """(array, first row, stop row, upload dtype) of every host array a
        tile stages in page-locked memory one by one: each numeric column's
        values and validity."""
        start, stop = self._rows(index, tile_rows)
        for name, dtype in zip(self.schema.names, self.schema.types):
            if dtype.is_complex or np.asarray(self.columns[name]).dtype.kind not in "bif":
                continue
            yield self.columns[name], start, stop, self._upload_dtype(name, dtype)
            validity = self.validities.get(name)
            if validity is not None:
                yield validity, start, stop, np.dtype(np.bool_)

    def _staged_bytes(self, index: int, tile_rows: int, device: torch.device, keep: bool) -> int:
        """The bytes a scan of tile ``index`` writes into page-locked memory:
        all of ``tile_bytes`` but the columns it finds kept."""
        if not _stages(device):
            return 0
        found = 0
        if keep:
            for arr, start, stop, np_dtype in self._staged_parts(index, tile_rows):
                kept = self._kept.get((id(arr), start, stop, np_dtype, tile_rows))
                found += 0 if kept is None else kept[1].nbytes
        return self.tile_bytes(tile_rows) - found

    def _stage(self, arr, start: int, stop: int, np_dtype: np.dtype, rows: int,
               keep: bool) -> torch.Tensor:
        """``arr[start:stop]`` as ``np_dtype``, zero-padded to ``rows`` rows,
        in page-locked memory; with ``keep``, written once and kept, and a
        fresh block for this scan alone where page-locked memory is refused."""
        if not keep:
            return _pinned(np.asarray(arr[start:stop]), np_dtype, rows)
        key = (id(arr), start, stop, np_dtype, rows)
        kept = self._kept.get(key)
        if kept is None:
            part = np.asarray(arr[start:stop])
            try:
                out = _page_locked((rows,) + part.shape[1:], np_dtype)
            except RuntimeError:
                return _pinned(part, np_dtype, rows)
            kept = self._kept[key] = (arr, _fill(out, part))
        return kept[1]

    def _tile(self, index: int, tile_rows: int, device: torch.device, keep: bool) -> Batch:
        start, stop = self._rows(index, tile_rows)
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
            if _stages(device) and arr.dtype.kind in "bif":
                validity = self.validities.get(name)
                cols.append(Column.flat(
                    self._stage(self.columns[name], start, stop,
                                self._upload_dtype(name, dtype), tile_rows, keep),
                    dtype,
                    None if validity is None
                    else self._stage(validity, start, stop, np.dtype(np.bool_), tile_rows, keep),
                    self.string_tables.get(name),
                ))
                continue
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

    # ---- parquet ---------------------------------------------------------
    def save_parquet(self, path: str) -> None:
        """Write as parquet, each column's logical type in the schema
        metadata (``velox_tpu:<column>``).  NULLs are written as NULLs: the
        JAX package's writer drops the validity (its NULL rows read back as
        zeros); a table without NULLs gives the same bytes in both."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        arrays, names = [], []
        meta = {}
        for name, dtype in zip(self.schema.names, self.schema.types):
            names.append(name)
            arr = self.columns[name]
            validity = self.validities.get(name)
            mask = None if validity is None else ~np.asarray(validity, dtype=bool)
            if dtype.is_string and name in self.string_tables:
                arrays.append(
                    pa.DictionaryArray.from_arrays(
                        pa.array(arr, type=pa.int32(), mask=mask),
                        pa.array(self.string_tables[name].values()),
                    )
                )
            elif dtype.is_long_decimal:
                # (n, 2) [lo, hi] limbs ARE the decimal128 storage layout
                limbs = np.ascontiguousarray(np.asarray(arr, np.int64))
                arrays.append(
                    pa.Array.from_buffers(
                        pa.decimal128(dtype.precision, dtype.scale),
                        len(limbs),
                        [_validity_buffer(mask), pa.py_buffer(limbs.tobytes())],
                        null_count=0 if mask is None else int(mask.sum()),
                    )
                )
            else:
                arrays.append(pa.array(arr, mask=mask))
            meta[name] = _dtype_tag(dtype)
        table = pa.Table.from_arrays(arrays, names=names)
        table = table.replace_schema_metadata(
            {f"velox_tpu:{k}": v for k, v in meta.items()}
        )
        from .filesystems import filesystem_for

        fs, local = filesystem_for(path)
        with fs.open_output(local) as f:
            pq.write_table(table, f)

    # ---- Arrow interop (C ABI) --------------------------------------------
    def to_arrow(self):
        """Export as a pyarrow Table (reference: vector/arrow/Bridge.h
        exportToArrow).  VARCHAR columns export as dictionary arrays —
        zero string copies; fixed-width columns are zero-copy numpy views."""
        import pyarrow as pa

        arrays, names = [], []
        for name, dtype in zip(self.schema.names, self.schema.types):
            if dtype.is_complex:
                validity = self.validities.get(name)
                arrays.append(pa.array(self.columns[name].to_pylist(validity)))
                names.append(name)
                continue
            arr = self.columns[name]
            mask = None
            validity = self.validities.get(name)
            if validity is not None:
                mask = ~np.asarray(validity)
            if dtype.is_string and name in self.string_tables:
                a = pa.DictionaryArray.from_arrays(
                    pa.array(np.asarray(arr), type=pa.int32(), mask=mask),
                    pa.array(self.string_tables[name].values()),
                )
            elif dtype.kind == TypeKind.DECIMAL:
                # unscaled int64 -> decimal128 storage (16-byte two's
                # complement little-endian: low limb + sign extension);
                # long decimals are already stored as (n, 2) [lo, hi]
                if dtype.is_long_decimal:
                    limbs = np.ascontiguousarray(np.asarray(arr, np.int64))
                    vals = limbs[:, 0]
                else:
                    vals = np.asarray(arr, dtype=np.int64)
                    limbs = np.empty((len(vals), 2), dtype=np.int64)
                    limbs[:, 0] = vals
                    limbs[:, 1] = vals >> 63
                a = pa.Array.from_buffers(
                    pa.decimal128(dtype.precision, dtype.scale),
                    len(vals),
                    [_validity_buffer(mask), pa.py_buffer(limbs.tobytes())],
                    null_count=int(mask.sum()) if mask is not None else 0,
                )
            elif dtype.kind == TypeKind.DATE:
                a = pa.array(
                    np.asarray(arr).astype(np.int32), mask=mask
                ).cast(pa.date32())
            else:
                a = pa.array(np.asarray(arr), mask=mask)
            arrays.append(a)
            names.append(name)
        return pa.Table.from_arrays(arrays, names=names)

    def __arrow_c_stream__(self, requested_schema=None):
        """Arrow PyCapsule protocol: any capsule-aware consumer (polars,
        duckdb, pandas>=2.2, ...) can ingest a Table zero-copy (reference:
        the C-ABI half of vector/arrow/Bridge.h:57)."""
        return self.to_arrow().__arrow_c_stream__(requested_schema)

    @staticmethod
    def from_arrow(source) -> "Table":
        """Ingest a pyarrow Table / RecordBatchReader / iterable of batches /
        any object implementing the Arrow PyCapsule protocol
        (``__arrow_c_stream__`` / ``__arrow_c_array__``) — reference:
        vector/arrow/Bridge.h import + exec/ArrowStream.cpp."""
        import pyarrow as pa

        if isinstance(source, pa.Table):
            pa_table = source
        elif hasattr(source, "read_all"):
            pa_table = source.read_all()
        elif hasattr(source, "__arrow_c_stream__") or hasattr(
            source, "__arrow_c_array__"
        ):
            pa_table = pa.table(source)
        else:
            batches = list(source)
            pa_table = pa.Table.from_batches(batches)
        return Table._from_arrow_table(pa_table, {})

    # ---- ORC (reference: velox/dwio/dwrf + dwio/orc readers) --------------
    def save_orc(self, path: str) -> None:
        """Write as ORC — the reference's native DWRF/ORC family; here via
        Arrow's ORC writer over the same export path as to_arrow()."""
        import pyarrow as pa
        import pyarrow.orc as orc

        from .filesystems import filesystem_for

        at = self.to_arrow()
        # ORC has no dictionary encoding at the Arrow boundary: decode
        # VARCHAR columns to plain strings (re-interned on read)
        cols = []
        for field, col in zip(at.schema, at.columns):
            if pa.types.is_dictionary(field.type):
                col = col.cast(pa.string())
            cols.append(col)
        at = pa.Table.from_arrays(cols, names=at.schema.names)
        fs, local = filesystem_for(path)
        with fs.open_output(local) as f:
            orc.write_table(at, f)

    @staticmethod
    def load_orc(path: str, columns: Optional[Sequence[str]] = None) -> "Table":
        """Read an ORC file (reference: dwio/orc/reader) — column-pruned at
        the stripe reader, types inferred from the Arrow schema."""
        import pyarrow.orc as orc

        from .filesystems import filesystem_for

        fs, local = filesystem_for(path)
        with fs.open_input(local) as f:
            pa_table = orc.ORCFile(f).read(
                columns=list(columns) if columns else None
            )
        return Table._from_arrow_table(pa_table, {})

    @staticmethod
    def load_parquet(
        path: str,
        columns: Optional[Sequence[str]] = None,
        ranges: Optional[Dict[str, tuple]] = None,
    ) -> "Table":
        """Load a parquet file, optionally pruning row groups by predicate.

        ``ranges`` maps column name -> (lo, hi) inclusive bounds (either may
        be None); row groups whose column statistics prove no overlap are
        never decoded — the selective-reader capability of the reference's
        dwio stack (velox/dwio/common/SelectiveColumnReader.h:121), applied
        at row-group granularity: the filter still runs row-exact on device,
        this skips the IO + decode for provably-dead stripes."""
        import pyarrow.parquet as pq

        from .filesystems import filesystem_for

        fs, local = filesystem_for(path)
        with fs.open_input(local) as f:
            if ranges:
                pf = pq.ParquetFile(f)
                keep = [
                    i
                    for i in range(pf.metadata.num_row_groups)
                    if _row_group_may_match(pf.metadata.row_group(i), ranges)
                ]
                if len(keep) < pf.metadata.num_row_groups:
                    if not keep:
                        pa_table = pf.schema_arrow.empty_table()
                        if columns:
                            pa_table = pa_table.select(list(columns))
                    else:
                        pa_table = pf.read_row_groups(
                            keep, columns=list(columns) if columns else None
                        )
                else:
                    pa_table = pf.read(
                        columns=list(columns) if columns else None
                    )
            else:
                pa_table = pq.read_table(
                    f, columns=list(columns) if columns else None
                )
        meta = {
            k.decode().split(":", 1)[1]: v.decode()
            for k, v in (pa_table.schema.metadata or {}).items()
            if k.startswith(b"velox_tpu:")
        }
        return Table._from_arrow_table(pa_table, meta)

    @staticmethod
    def _from_arrow_table(pa_table, meta: Dict[str, str]) -> "Table":
        import pyarrow as pa

        names, types, cols, tables = [], [], {}, {}
        validities: Dict[str, np.ndarray] = {}
        for field in pa_table.schema:
            name = field.name
            dtype = _dtype_from_tag(meta.get(name, ""), field)
            names.append(name)
            types.append(dtype)
            chunked = pa_table.column(name).combine_chunks()
            validity = None
            if chunked.null_count:
                validity = np.asarray(
                    chunked.is_valid().to_numpy(zero_copy_only=False)
                )
            if pa.types.is_decimal(chunked.type):
                # decimal128 storage is 16-byte two's complement little-endian
                # [lo, hi]; short decimals keep the low limb, long decimals
                # (p > 18, reference HUGEINT) keep both as an (n, 2) column
                # lowered by exec/hugeint.py
                flat = chunked.fill_null(0)
                buf = flat.buffers()[1]
                limbs = np.frombuffer(
                    buf, dtype=np.int64, count=2 * len(flat),
                    offset=16 * flat.offset,
                )
                if chunked.type.precision > 18:
                    cols[name] = np.stack(
                        [limbs[0::2], limbs[1::2]], axis=1
                    )
                else:
                    cols[name] = limbs[0::2].copy()
            elif pa.types.is_date32(chunked.type):
                cols[name] = (
                    chunked.fill_null(0).cast(pa.int32()).to_numpy(
                        zero_copy_only=False
                    )
                )
            elif pa.types.is_timestamp(chunked.type):
                cols[name] = (
                    chunked.fill_null(0)
                    .cast(pa.timestamp("us"))
                    .cast(pa.int64())
                    .to_numpy(zero_copy_only=False)
                )
            elif isinstance(chunked, pa.DictionaryArray):
                codes = (
                    chunked.indices.fill_null(0)
                    .to_numpy(zero_copy_only=False)
                    .astype(np.int32)
                )
                values = chunked.dictionary.to_pylist()
                table = StringTable()
                remap = table.intern_all([str(v) for v in values])
                cols[name] = remap[codes]
                tables[name] = table
            elif pa.types.is_string(chunked.type) or pa.types.is_large_string(
                chunked.type
            ):
                # plain string column (externally-written parquet): dictionary-
                # encode at ingest — natively when available (native/)
                table, codes = _intern_arrow_strings(chunked)
                cols[name] = codes
                tables[name] = table
            elif validity is not None:
                cols[name] = chunked.fill_null(0).to_numpy(
                    zero_copy_only=False
                )
            else:
                cols[name] = chunked.to_numpy(zero_copy_only=False)
            if validity is not None and not validity.all():
                validities[name] = validity
        return Table(RowType(names, types), cols, tables, validities)


def _stages(device: torch.device) -> bool:
    """Whether a scan to ``device`` stages its numeric columns in page-locked
    memory (``_stage``) before the upload."""
    return device.type == "cuda"


def _page_locked(shape: tuple, np_dtype: np.dtype) -> torch.Tensor:
    """An uninitialised page-locked block from torch's caching host
    allocator (a block is reused once its tensor is freed and its upload
    done)."""
    torch_dtype = torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype
    return torch.empty(shape, dtype=torch_dtype, pin_memory=True)


def _fill(out: torch.Tensor, arr: np.ndarray) -> torch.Tensor:
    """``out`` holding ``arr`` cast to its dtype, zero-padded to its rows,
    written once: no host temporaries to allocate and fault in.  One thread:
    on a shared host, torch's parallel copy and fill spread the query times
    wider than they saved."""
    view = out.numpy()
    np.copyto(view[: arr.shape[0]], arr, casting="unsafe")
    view[arr.shape[0]:] = 0
    return out


def _pinned(arr: np.ndarray, np_dtype: np.dtype, rows: int) -> torch.Tensor:
    """``arr`` cast to ``np_dtype`` and zero-padded to ``rows`` rows in a
    fresh page-locked block."""
    return _fill(_page_locked((rows,) + arr.shape[1:], np_dtype), arr)


def _pin(batch: Batch) -> Batch:
    """The batch with every host tensor in page-locked memory, so the
    following upload can be asynchronous."""

    def page_locked(t: torch.Tensor) -> torch.Tensor:
        return t if t.is_pinned() else t.pin_memory()

    def pin(c: Column) -> Column:
        return dataclasses.replace(
            c,
            data=page_locked(c.data),
            validity=None if c.validity is None else page_locked(c.validity),
            base=None if c.base is None else pin(c.base),
            children=tuple(pin(ch) for ch in c.children),
        )

    return dataclasses.replace(batch, columns=tuple(pin(c) for c in batch.columns))


def _validity_buffer(mask: Optional[np.ndarray]):
    """Arrow validity bitmap of a NULL mask (None: no bitmap)."""
    import pyarrow as pa

    return None if mask is None else pa.array(~mask, type=pa.bool_()).buffers()[1]


def _intern_arrow_strings(arr):
    """Dictionary-encode an Arrow string array -> (StringTable, int32 codes).

    Fast path: native interning over the Arrow buffers (zero string copies on
    the dedup scan); fallback: python-level interning.
    """
    import pyarrow as pa

    from .. import native

    arr = arr.cast(pa.large_string())
    if arr.null_count:
        arr = arr.fill_null("")
    bufs = arr.buffers()
    n = len(arr)
    offsets = np.frombuffer(bufs[1], dtype=np.int64, count=n + 1, offset=arr.offset * 8)
    blob = np.frombuffer(bufs[2], dtype=np.uint8) if bufs[2] is not None else np.zeros(0, np.uint8)
    result = native.intern_strings(blob, offsets)
    if result is None:
        table = StringTable()
        return table, table.intern_all([str(v) for v in arr.to_pylist()])
    codes, uniq = result
    raw = blob.tobytes()
    values = [""]
    for row in uniq[1:]:
        values.append(raw[offsets[row] : offsets[row + 1]].decode("utf-8"))
    return StringTable.from_values(values), codes


def _dtype_tag(dtype: DataType) -> str:
    if dtype.kind == TypeKind.DECIMAL:
        return f"DECIMAL:{dtype.precision}:{dtype.scale}"
    return dtype.kind.value


def _dtype_from_tag(tag: str, field) -> DataType:
    import pyarrow as pa

    if tag.startswith("DECIMAL:"):
        _, p, s = tag.split(":")
        from ..dtypes import decimal

        return decimal(int(p), int(s))
    if tag:
        return DataType(TypeKind(tag))
    # Fall back to the Arrow type for externally-written files.
    t = field.type
    if pa.types.is_dictionary(t) or pa.types.is_string(t):
        return DataType(TypeKind.VARCHAR)
    if pa.types.is_int64(t):
        return DataType(TypeKind.BIGINT)
    if pa.types.is_int32(t):
        return DataType(TypeKind.INTEGER)
    if pa.types.is_float64(t):
        return DataType(TypeKind.DOUBLE)
    if pa.types.is_float32(t):
        return DataType(TypeKind.REAL)
    if pa.types.is_boolean(t):
        return DataType(TypeKind.BOOLEAN)
    if pa.types.is_date32(t):
        return DataType(TypeKind.DATE)
    if pa.types.is_timestamp(t):
        return DataType(TypeKind.TIMESTAMP)
    if pa.types.is_decimal(t):
        from ..dtypes import decimal

        return decimal(t.precision, t.scale)
    if pa.types.is_int16(t):
        return DataType(TypeKind.SMALLINT)
    if pa.types.is_int8(t):
        return DataType(TypeKind.TINYINT)
    raise TypeError(f"cannot infer type for arrow field {field}")


def _row_group_may_match(rg_meta, ranges: Dict[str, tuple]) -> bool:
    """Can this row group contain a row satisfying every (lo, hi) range?

    Conservative: missing/untyped statistics keep the group.  Reference:
    the reader-level stats pruning of dwio/common/ScanSpec + the row-group
    skipping in velox/dwio/parquet/reader/ParquetReader.cpp."""
    for ci in range(rg_meta.num_columns):
        col = rg_meta.column(ci)
        name = col.path_in_schema
        if name not in ranges:
            continue
        stats = col.statistics
        if stats is None or not stats.has_min_max:
            continue
        lo, hi = ranges[name]
        try:
            if lo is not None and stats.max is not None and stats.max < lo:
                return False
            if hi is not None and stats.min is not None and stats.min > hi:
                return False
        except TypeError:
            continue  # incomparable stats type: keep the group
    return True
