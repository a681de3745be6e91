"""Columnar page wire format (the engine's PrestoPage analog).

Reference: velox/serializers/PrestoSerializer.cpp (the default shuffle format:
columnar, optionally compressed, CRC-protected) and the VectorSerde registry
(velox/vector/VectorStream.h:63); integer columns use lightweight RLE/varint
encodings like the reference's dwio integer encoders
(velox/dwio/common/IntDecoder.h), implemented natively (native/).

Counterpart of the JAX package's ``serde/page.py``, byte for byte.  This
format serves the *host* boundaries the reference also serves: persistence of
intermediate results, spill files, cross-process interchange, and parity
testing.  Layout (little-endian):

  [magic u32][flags u8][ncols u16][nrows u64][crc u32][payload]
  payload per column:
    [name_len u16][name utf8][dtype_tag u16][precision u8][scale u8]
    [has_validity u8][validity bitmap ceil(n/8) bytes]
    [encoding u8][data_len u64][data bytes]
        encoding 0: raw numpy little-endian
        encoding 1: zigzag-varint RLE over int64
        encoding 2: zigzag-varint RLE over int64 deltas (sorted-ish columns)
    [dict_len u64][dictionary utf8 blob]            (VARCHAR only: \\x00-joined)

flags bit0: zlib-compressed payload.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Dict, Optional

import numpy as np

from ..dtypes import DataType, RowType, TypeKind
from ..io.table import Table
from ..vector.string_table import StringTable
from .. import native

_MAGIC = 0x56585047  # "VXPG"

_TAGS = {k: i for i, k in enumerate(TypeKind)}
_KINDS = {i: k for k, i in _TAGS.items()}

_RAW, _RLE, _RLE_DELTA = 0, 1, 2


def _pack_bitmap(validity: np.ndarray) -> bytes:
    return np.packbits(validity.astype(np.uint8), bitorder="little").tobytes()


def _unpack_bitmap(data: bytes, n: int) -> np.ndarray:
    return np.unpackbits(
        np.frombuffer(data, dtype=np.uint8), bitorder="little", count=n
    ).astype(bool)


def _encode_column(arr: np.ndarray) -> tuple:
    """Pick the smallest of raw / RLE / delta-RLE for integer columns."""
    raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    if arr.dtype.kind not in "iu" or arr.size == 0:
        return _RAW, raw
    i64 = arr.astype(np.int64)
    rle = native.encode_i64(i64)
    best_enc, best = _RAW, raw
    if len(rle) < len(best):
        best_enc, best = _RLE, rle
    # delta pays off on sorted/sequential columns; cheap to try
    delta = native.encode_i64(i64, delta=True)
    if len(delta) < len(best):
        best_enc, best = _RLE_DELTA, delta
    return best_enc, best


def _write_leaf(body, dtype, arr, validity, strings) -> None:
    """[has_validity][bitmap][enc u8][len u64][data][dict_len u64][dict]."""
    if validity is None:
        body.write(struct.pack("<B", 0))
    else:
        body.write(struct.pack("<B", 1))
        body.write(_pack_bitmap(validity))
    arr = np.ascontiguousarray(arr)
    encoding, data = _encode_column(arr)
    body.write(struct.pack("<BQ", encoding, len(data)))
    body.write(data)
    if dtype.is_string and strings is not None:
        blob = "\x00".join(strings.values()).encode("utf-8")
        body.write(struct.pack("<Q", len(blob)))
        body.write(blob)
    else:
        body.write(struct.pack("<Q", 0))


def _write_block(body, dtype, value, validity, strings) -> None:
    """One value block: leaf column bytes, or recursive complex layout
    (ARRAY/MAP: sizes block + [pool_len u64] + child blocks; ROW: child
    blocks row-aligned)."""
    from ..vector.complex import HostSegments, HostStruct

    if not dtype.is_complex:
        _write_leaf(body, dtype, value, validity, strings)
        return
    if validity is None:
        body.write(struct.pack("<B", 0))
    else:
        body.write(struct.pack("<B", 1))
        body.write(_pack_bitmap(validity))
    if dtype.kind == TypeKind.ROW:
        assert isinstance(value, HostStruct)
        for child, cv, tab, ft in zip(
            value.children, value.child_validities, value.string_tables,
            dtype.children,
        ):
            _write_block(body, ft, child, cv, tab)
        return
    assert isinstance(value, HostSegments)
    encoding, data = _encode_column(value.sizes.astype(np.int64))
    body.write(struct.pack("<BQ", encoding, len(data)))
    body.write(data)
    body.write(struct.pack("<Q", value.pool_len))
    child_types = (
        (dtype.element,)
        if dtype.kind == TypeKind.ARRAY
        else (dtype.key_type, dtype.value_type)
    )
    for child, cv, tab, ft in zip(
        value.children, value.child_validities, value.string_tables, child_types
    ):
        _write_block(body, ft, child, cv, tab)


def serialize_page(table: Table, compress: bool = True) -> bytes:
    """Serialize a host Table chunk to one page."""
    n = table.num_rows
    body = io.BytesIO()
    for name, dtype in zip(table.schema.names, table.schema.types):
        nb = name.encode("utf-8")
        body.write(struct.pack("<H", len(nb)))
        body.write(nb)
        body.write(
            struct.pack(
                "<HBB",
                _TAGS[dtype.kind],
                dtype.precision or 0,
                dtype.scale or 0,
            )
        )
        if dtype.is_complex:
            # nested children types ride as a JSON blob (DataType serde)
            import json

            tj = json.dumps(dtype.to_json()).encode("utf-8")
            body.write(struct.pack("<I", len(tj)))
            body.write(tj)
        _write_block(
            body,
            dtype,
            table.columns[name],
            table.validities.get(name),
            table.string_tables.get(name),
        )
    payload = body.getvalue()
    flags = 0
    if compress:
        payload = zlib.compress(payload, level=1)
        flags |= 1
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    header = struct.pack(
        "<IBHQI", _MAGIC, flags, len(table.schema.names), n, crc
    )
    return header + payload


_NP_DTYPES = {
    TypeKind.BOOLEAN: np.bool_,
    TypeKind.TINYINT: np.int8,
    TypeKind.SMALLINT: np.int16,
    TypeKind.INTEGER: np.int32,
    TypeKind.BIGINT: np.int64,
    TypeKind.REAL: np.float32,
    TypeKind.DOUBLE: np.float64,
    TypeKind.TIMESTAMP: np.int64,
    TypeKind.DATE: np.int32,
    TypeKind.DECIMAL: np.int64,
    TypeKind.VARCHAR: np.int32,
    TypeKind.VARBINARY: np.int32,
}


def deserialize_page(buf: bytes) -> Table:
    magic, flags, ncols, nrows, crc = struct.unpack_from("<IBHQI", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not a velox page")
    payload = buf[struct.calcsize("<IBHQI") :]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise ValueError("page checksum mismatch")
    if flags & 1:
        payload = zlib.decompress(payload)
    off = 0
    names, types = [], []
    cols: Dict[str, np.ndarray] = {}
    validities: Dict[str, np.ndarray] = {}
    tables: Dict[str, StringTable] = {}
    for _ in range(ncols):
        (name_len,) = struct.unpack_from("<H", payload, off)
        off += 2
        name = payload[off : off + name_len].decode("utf-8")
        off += name_len
        tag, precision, scale = struct.unpack_from("<HBB", payload, off)
        off += 4
        kind = _KINDS[tag]
        if kind == TypeKind.DECIMAL:
            dtype = DataType(kind, precision=precision, scale=scale)
        elif kind in (TypeKind.ARRAY, TypeKind.MAP, TypeKind.ROW):
            import json

            (tlen,) = struct.unpack_from("<I", payload, off)
            off += 4
            dtype = DataType.from_json(
                json.loads(payload[off : off + tlen].decode("utf-8"))
            )
            off += tlen
        else:
            dtype = DataType(kind)
        value, validity, strings, off = _read_block(payload, off, dtype, nrows)
        if validity is not None:
            validities[name] = validity
        if strings is not None:
            tables[name] = strings
        names.append(name)
        types.append(dtype)
        cols[name] = value
    return Table(RowType(names, types), cols, tables, validities)


def _read_values(payload, off, n):
    """[enc u8][len u64][data] -> (int64 array, off)."""
    encoding, data_len = struct.unpack_from("<BQ", payload, off)
    off += 9
    raw = payload[off : off + data_len]
    off += data_len
    return encoding, raw, off


def _read_block(payload, off, dtype: DataType, n: int):
    """Inverse of _write_block -> (value, validity|None, strings|None, off)."""
    from ..vector.complex import HostSegments, HostStruct

    (has_validity,) = struct.unpack_from("<B", payload, off)
    off += 1
    validity = None
    if has_validity:
        nbytes = (n + 7) // 8
        validity = _unpack_bitmap(payload[off : off + nbytes], n)
        off += nbytes
    if dtype.kind == TypeKind.ROW:
        children, cvs, tabs = [], [], []
        for ft in dtype.children:
            cv_value, cv, tab, off = _read_block(payload, off, ft, n)
            children.append(cv_value)
            cvs.append(cv)
            tabs.append(tab)
        return (
            HostStruct(dtype, tuple(children), tuple(cvs), tuple(tabs)),
            validity,
            None,
            off,
        )
    if dtype.kind in (TypeKind.ARRAY, TypeKind.MAP):
        encoding, raw, off = _read_values(payload, off, n)
        if encoding == _RAW:
            sizes = np.frombuffer(raw, dtype=np.int64).copy()
        else:
            sizes = native.decode_i64(raw, n, delta=(encoding == _RLE_DELTA))
        (pool_len,) = struct.unpack_from("<Q", payload, off)
        off += 8
        child_types = (
            (dtype.element,)
            if dtype.kind == TypeKind.ARRAY
            else (dtype.key_type, dtype.value_type)
        )
        children, cvs, tabs = [], [], []
        for ft in child_types:
            cv_value, cv, tab, off = _read_block(payload, off, ft, pool_len)
            children.append(cv_value)
            cvs.append(cv)
            tabs.append(tab)
        return (
            HostSegments(
                dtype,
                sizes.astype(np.int32),
                tuple(children),
                tuple(cvs),
                tuple(tabs),
            ),
            validity,
            None,
            off,
        )
    encoding, raw, off = _read_values(payload, off, n)
    np_dtype = _NP_DTYPES[dtype.kind]
    if encoding == _RAW:
        arr = np.frombuffer(raw, dtype=np_dtype).copy()
    else:
        arr = native.decode_i64(raw, n, delta=(encoding == _RLE_DELTA)).astype(
            np_dtype
        )
    (dict_len,) = struct.unpack_from("<Q", payload, off)
    off += 8
    strings = None
    if dict_len:
        blob = payload[off : off + dict_len].decode("utf-8")
        off += dict_len
        strings = StringTable()
        remap = strings.intern_all(blob.split("\x00"))
        arr = remap[arr]
    return arr, validity, strings, off
