"""Row wire formats: UnsafeRow (Spark-compatible) and CompactRow.

Counterpart of the JAX package's ``serde/rows.py``, byte for byte.
Reference: velox/serializers/UnsafeRowSerializer.cpp +
velox/row/UnsafeRowFast.h:23 (Spark's fixed 8-byte-slot row layout) and
velox/row/CompactRow.cpp (denser variable-width layout).  These exist for external interchange (handing rows to
Spark-ecosystem shuffles) and as a spill row format.

UnsafeRow layout per row (all little-endian, 8-byte aligned):
  [null bitset: ceil(nfields/64) * 8 bytes]
  [one 8-byte slot per field: value, or (offset << 32 | size) for var-width]
  [var-width data, 8-byte aligned]

CompactRow layout per row:
  [null bitset: ceil(nfields/8) bytes]
  fixed-width values packed at native width; var-width as u32 size + bytes.

Both encoders and decoders loop over rows in Python, as the JAX package's do.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from ..dtypes import DataType, RowType, TypeKind
from ..io.table import Table
from ..vector.string_table import StringTable

_WIDTHS = {
    TypeKind.BOOLEAN: 1,
    TypeKind.TINYINT: 1,
    TypeKind.SMALLINT: 2,
    TypeKind.INTEGER: 4,
    TypeKind.BIGINT: 8,
    TypeKind.REAL: 4,
    TypeKind.DOUBLE: 8,
    TypeKind.TIMESTAMP: 8,
    TypeKind.DATE: 4,
    TypeKind.DECIMAL: 8,
}


def _column_bytes(table: Table, name: str, dtype: DataType):
    """(fixed numpy array | None, list-of-bytes | None) for a column."""
    arr = table.columns[name]
    if getattr(dtype, "is_long_decimal", False):
        raise NotImplementedError(
            "UnsafeRow DECIMAL(p>18) uses the 16-byte var-width form "
            "(Spark BigInteger bytes); only long-backed decimals are encoded"
        )
    if dtype.is_string:
        strings = table.string_tables.get(name)
        if strings is None:
            raise ValueError(f"string column {name} lacks a dictionary")
        decoded = strings.decode(arr)
        return None, [s.encode("utf-8") for s in decoded]
    return np.asarray(arr), None


def encode_unsaferow(table: Table) -> List[bytes]:
    """Encode each row in Spark UnsafeRow layout; returns a list of row buffers."""
    schema = table.schema
    n = table.num_rows
    nfields = len(schema)
    null_words = (nfields + 63) // 64
    fixed_len = null_words * 8 + nfields * 8

    cols = []
    for name, dtype in zip(schema.names, schema.types):
        fixed, varlen = _column_bytes(table, name, dtype)
        validity = table.validities.get(name)
        cols.append((dtype, fixed, varlen, validity))

    rows: List[bytes] = []
    for i in range(n):
        nulls = 0
        slots = bytearray()
        var = bytearray()
        for f, (dtype, fixed, varlen, validity) in enumerate(cols):
            if validity is not None and not validity[i]:
                nulls |= 1 << f
                slots += b"\x00" * 8
                continue
            if varlen is not None:
                data = varlen[i]
                offset = fixed_len + len(var)
                slots += struct.pack("<Q", (offset << 32) | len(data))
                var += data
                if len(var) % 8:
                    var += b"\x00" * (8 - len(var) % 8)
            else:
                v = fixed[i]
                if dtype.kind == TypeKind.BOOLEAN:
                    slots += struct.pack("<Q", int(bool(v)))
                elif dtype.is_floating:
                    # Spark canonicalizes NaN before writing
                    # (UnsafeRowWriter.write(float/double))
                    fv = float(v)
                    if fv != fv:
                        fv = float("nan")
                    fmt = "<d" if dtype.kind == TypeKind.DOUBLE else "<f"
                    raw = struct.pack(fmt, fv)
                    slots += raw + b"\x00" * (8 - len(raw))
                else:
                    # sub-8-byte ints occupy the LOW bytes of a zeroed slot
                    # (UnsafeRowWriter zeroes the slot then putInt/putShort/
                    # putByte) — NOT sign-extended to 8 bytes
                    w = _WIDTHS[dtype.kind]
                    fmt = {1: "<b", 2: "<h", 4: "<i", 8: "<q"}[w]
                    raw = struct.pack(fmt, int(v))
                    slots += raw + b"\x00" * (8 - len(raw))
        row = struct.pack(f"<{null_words}Q", *( (nulls >> (64*w)) & ((1<<64)-1) for w in range(null_words))) + bytes(slots) + bytes(var)
        rows.append(row)
    return rows


def decode_unsaferow(rows: List[bytes], schema: RowType) -> Table:
    nfields = len(schema)
    null_words = (nfields + 63) // 64
    fixed_len = null_words * 8 + nfields * 8
    out_cols: List[list] = [[] for _ in range(nfields)]
    out_valid: List[list] = [[] for _ in range(nfields)]
    for row in rows:
        words = struct.unpack_from(f"<{null_words}Q", row, 0)
        nulls = 0
        for w, word in enumerate(words):
            nulls |= word << (64 * w)
        for f, dtype in enumerate(schema.types):
            slot_off = null_words * 8 + f * 8
            is_null = bool(nulls & (1 << f))
            out_valid[f].append(not is_null)
            if is_null:
                out_cols[f].append("" if dtype.is_string else 0)
                continue
            if dtype.is_string:
                (packed,) = struct.unpack_from("<Q", row, slot_off)
                offset, size = packed >> 32, packed & 0xFFFFFFFF
                out_cols[f].append(row[offset : offset + size].decode("utf-8"))
            elif dtype.kind == TypeKind.BOOLEAN:
                out_cols[f].append(bool(struct.unpack_from("<Q", row, slot_off)[0]))
            elif dtype.is_floating:
                fmt = "<d" if dtype.kind == TypeKind.DOUBLE else "<f"
                out_cols[f].append(struct.unpack_from(fmt, row, slot_off)[0])
            else:
                # read the field at its native width from the slot's low
                # bytes (Spark's UnsafeRow.getInt/getShort/getByte)
                w = _WIDTHS.get(dtype.kind, 8)
                fmt = {1: "<b", 2: "<h", 4: "<i", 8: "<q"}[w]
                out_cols[f].append(struct.unpack_from(fmt, row, slot_off)[0])
    cols, tables, validities = {}, {}, {}
    for f, (name, dtype) in enumerate(zip(schema.names, schema.types)):
        if dtype.is_string:
            table = StringTable()
            cols[name] = table.intern_all(out_cols[f])
            tables[name] = table
        else:
            np_dtype = {
                TypeKind.BOOLEAN: np.bool_,
                TypeKind.REAL: np.float32,
                TypeKind.DOUBLE: np.float64,
                TypeKind.DATE: np.int32,
                TypeKind.INTEGER: np.int32,
                TypeKind.SMALLINT: np.int16,
                TypeKind.TINYINT: np.int8,
            }.get(dtype.kind, np.int64)
            cols[name] = np.asarray(out_cols[f], dtype=np_dtype)
        validity = np.asarray(out_valid[f])
        if not validity.all():
            validities[name] = validity
    return Table(schema, cols, tables, validities)


def serialize_unsaferow_stream(table: Table) -> bytes:
    """Frame each UnsafeRow with a BIG-endian uint32 size — the wire format
    of the reference's Spark serializer (UnsafeRowVectorSerializer,
    velox/serializers/UnsafeRowSerializer.cpp:69-73: "Write raw size. Needs
    to be in big endian order.")."""
    out = bytearray()
    for row in encode_unsaferow(table):
        out += struct.pack(">I", len(row))
        out += row
    return bytes(out)


def deserialize_unsaferow_stream(data: bytes, schema: RowType) -> Table:
    rows: List[bytes] = []
    off = 0
    while off < len(data):
        (size,) = struct.unpack_from(">I", data, off)
        off += 4
        rows.append(data[off : off + size])
        off += size
    return decode_unsaferow(rows, schema)


def encode_compactrow(table: Table) -> List[bytes]:
    """Denser row format: native-width fields, u32-prefixed var-width."""
    schema = table.schema
    n = table.num_rows
    nfields = len(schema)
    null_bytes = (nfields + 7) // 8
    cols = []
    for name, dtype in zip(schema.names, schema.types):
        fixed, varlen = _column_bytes(table, name, dtype)
        validity = table.validities.get(name)
        cols.append((dtype, fixed, varlen, validity))
    rows = []
    for i in range(n):
        nulls = 0
        body = bytearray()
        for f, (dtype, fixed, varlen, validity) in enumerate(cols):
            if validity is not None and not validity[i]:
                nulls |= 1 << f
                continue
            if varlen is not None:
                data = varlen[i]
                body += struct.pack("<I", len(data)) + data
            else:
                v = fixed[i]
                if dtype.kind == TypeKind.BOOLEAN:
                    body += struct.pack("<B", int(bool(v)))
                elif dtype.is_floating:
                    fmt = "<d" if dtype.kind == TypeKind.DOUBLE else "<f"
                    body += struct.pack(fmt, float(v))
                else:
                    body += int(v).to_bytes(
                        _WIDTHS[dtype.kind], "little", signed=True
                    )
        rows.append(nulls.to_bytes(null_bytes, "little") + bytes(body))
    return rows


def decode_compactrow(rows: List[bytes], schema: RowType) -> Table:
    nfields = len(schema)
    null_bytes = (nfields + 7) // 8
    out_cols: List[list] = [[] for _ in range(nfields)]
    out_valid: List[list] = [[] for _ in range(nfields)]
    for row in rows:
        nulls = int.from_bytes(row[:null_bytes], "little")
        off = null_bytes
        for f, dtype in enumerate(schema.types):
            if nulls & (1 << f):
                out_valid[f].append(False)
                out_cols[f].append("" if dtype.is_string else 0)
                continue
            out_valid[f].append(True)
            if dtype.is_string:
                (size,) = struct.unpack_from("<I", row, off)
                off += 4
                out_cols[f].append(row[off : off + size].decode("utf-8"))
                off += size
            elif dtype.kind == TypeKind.BOOLEAN:
                out_cols[f].append(bool(row[off]))
                off += 1
            elif dtype.is_floating:
                fmt = "<d" if dtype.kind == TypeKind.DOUBLE else "<f"
                out_cols[f].append(struct.unpack_from(fmt, row, off)[0])
                off += 8 if dtype.kind == TypeKind.DOUBLE else 4
            else:
                w = _WIDTHS[dtype.kind]
                out_cols[f].append(
                    int.from_bytes(row[off : off + w], "little", signed=True)
                )
                off += w
    cols, tables, validities = {}, {}, {}
    for f, (name, dtype) in enumerate(zip(schema.names, schema.types)):
        if dtype.is_string:
            table = StringTable()
            cols[name] = table.intern_all(out_cols[f])
            tables[name] = table
        else:
            np_dtype = {
                TypeKind.BOOLEAN: np.bool_,
                TypeKind.REAL: np.float32,
                TypeKind.DOUBLE: np.float64,
                TypeKind.DATE: np.int32,
                TypeKind.INTEGER: np.int32,
                TypeKind.SMALLINT: np.int16,
                TypeKind.TINYINT: np.int8,
            }.get(dtype.kind, np.int64)
            cols[name] = np.asarray(out_cols[f], dtype=np_dtype)
        validity = np.asarray(out_valid[f])
        if not validity.all():
            validities[name] = validity
    return Table(schema, cols, tables, validities)
