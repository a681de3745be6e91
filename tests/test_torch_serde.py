"""Host formats of the port (``velox_tpu_torch/native/``, ``serde/``,
``vector/saver.py``) against the JAX package: the cases of
``tests/test_native.py`` and ``tests/test_serde.py``, and bytes across
packages: the native codecs, ``serialize_page`` (compressed and not, complex
columns included) and the UnsafeRow / CompactRow encoders write the same bytes
as the JAX package's for the same table, and each package decodes the
other's bytes into an equal table."""

import struct

import numpy as np
import pandas as pd
import pytest

import velox_tpu as vt
import velox_tpu_torch as vtt
from velox_tpu import native as ref_native
from velox_tpu import serde as ref_serde
from velox_tpu.io.table import Table as RefTable
from velox_tpu.vector.string_table import StringTable as RefStringTable
from velox_tpu_torch import native
from velox_tpu_torch.io.table import Table
from velox_tpu_torch.serde import (
    decode_compactrow,
    decode_unsaferow,
    deserialize_page,
    deserialize_unsaferow_stream,
    encode_compactrow,
    encode_unsaferow,
    serialize_page,
    serialize_unsaferow_stream,
)
from velox_tpu_torch.vector.string_table import StringTable


# ---- tests/test_native.py --------------------------------------------------------


def test_native_builds():
    assert native.available()


CODEC_CASES = [
    np.zeros(100, dtype=np.int64),
    np.arange(1000, dtype=np.int64),
    np.random.default_rng(7).integers(-(2**62), 2**62, 257),
    np.repeat(np.random.default_rng(8).integers(0, 50, 40),
              np.random.default_rng(9).integers(1, 9, 40)),
    np.array([], dtype=np.int64),
    np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max]),
]


@pytest.mark.parametrize("delta", [False, True])
def test_i64_codec_roundtrip(delta):
    for arr in CODEC_CASES:
        arr = arr.astype(np.int64)
        blob = native.encode_i64(arr, delta=delta)
        np.testing.assert_array_equal(native.decode_i64(blob, len(arr), delta=delta), arr)
        # python fallback agrees with the native stream both ways
        assert native._py_encode_i64(arr.copy(), delta) == blob
        np.testing.assert_array_equal(native._py_decode_i64(blob, len(arr), delta), arr)
        # and the JAX package writes the same stream
        assert ref_native.encode_i64(arr, delta=delta) == blob


def test_i64_decode_rejects_a_short_stream():
    blob = native.encode_i64(np.arange(10, dtype=np.int64))
    with pytest.raises(ValueError, match="corrupt"):
        native.decode_i64(blob, 11)


def test_intern_strings_matches_python():
    values = ["apple", "", "pear", "apple", "fig", "pear", "apple", "日本語"]
    blob = "".join(values).encode("utf-8")
    offsets = np.cumsum([0] + [len(v.encode("utf-8")) for v in values]).astype(np.int64)
    codes, uniq = native.intern_strings(np.frombuffer(blob, np.uint8), offsets)
    dict_values = [""] + [blob[offsets[r]: offsets[r + 1]].decode("utf-8") for r in uniq[1:]]
    assert [dict_values[c] for c in codes] == values
    assert codes[0] == codes[3] == codes[6]  # same string, same code
    assert codes[1] == 0  # '' is the canonical entry 0
    r_codes, r_uniq = ref_native.intern_strings(np.frombuffer(blob, np.uint8), offsets)
    np.testing.assert_array_equal(codes, r_codes)
    np.testing.assert_array_equal(uniq, r_uniq)


def _rle_tables():
    n = 500
    rng = np.random.default_rng(0)
    cols = {
        "k": np.arange(n, dtype=np.int64),  # delta-friendly
        "d": np.repeat(np.int32(8000), n),  # RLE-friendly
        "s": rng.integers(0, 3, n).astype(np.int32),
        "dec": rng.integers(-(10**9), 10**9, n),
    }
    validities = {"dec": rng.random(n) > 0.1}
    out = []
    for mod, table_cls, st_cls in ((vt, RefTable, RefStringTable), (vtt, Table, StringTable)):
        schema = mod.RowType(["k", "d", "s", "dec"],
                             [mod.BIGINT, mod.DATE, mod.VARCHAR, mod.decimal(12, 2)])
        out.append(table_cls(schema, dict(cols), {"s": st_cls(["a", "bb", "ccc"])},
                             dict(validities)))
    return out


def test_page_roundtrip_with_rle_columns():
    _, table = _rle_tables()
    out = deserialize_page(serialize_page(table))
    for col in table.schema.names:
        np.testing.assert_array_equal(out.columns[col], table.columns[col])
    np.testing.assert_array_equal(out.validities["dec"], table.validities["dec"])
    assert out.string_tables["s"].decode(out.columns["s"]).tolist() == (
        table.string_tables["s"].decode(table.columns["s"]).tolist()
    )


@pytest.mark.parametrize("native_on", [True, False])
def test_page_bytes_equal_reference(monkeypatch, native_on):
    """The same page, byte for byte, through the native codecs or the Python
    fallback, compressed or not; each package decodes the other's page."""
    ref, port = _rle_tables()
    if not native_on:
        monkeypatch.setattr(native, "_load", lambda: None)
    for compress in (False, True):
        mine = serialize_page(port, compress=compress)
        theirs = ref_serde.serialize_page(ref, compress=compress)
        assert mine == theirs
        _assert_same_rows(deserialize_page(theirs), port)
        _assert_same_rows(ref_serde.deserialize_page(mine), ref)


# ---- tests/test_serde.py ---------------------------------------------------------


def _serde_table(mod=vtt, table_cls=Table, st_cls=StringTable):
    strings = st_cls()
    codes = strings.intern_all(["alpha", "beta", "", "alpha", "delta"])
    return table_cls(
        mod.RowType(
            ["id", "price", "name", "flag", "ratio"],
            [mod.BIGINT, mod.decimal(12, 2), mod.VARCHAR, mod.BOOLEAN, mod.DOUBLE],
        ),
        {
            "id": np.arange(5, dtype=np.int64),
            "price": np.asarray([100, -250, 0, 99999, 7], dtype=np.int64),
            "name": codes,
            "flag": np.asarray([True, False, True, True, False]),
            "ratio": np.asarray([0.5, -1.25, float("inf"), 0.0, 3.25]),
        },
        {"name": strings},
        {"ratio": np.asarray([True, True, True, False, True])},
    )


@pytest.fixture
def table():
    return _serde_table()


def _assert_tables_equal(a, b):
    assert str(a.schema) == str(b.schema)
    pd.testing.assert_frame_equal(a.to_pandas(), b.to_pandas())


def _assert_same_rows(a, b):
    """Equal schemas, columns (dtype included), validity and strings."""
    assert str(a.schema) == str(b.schema)
    for name, dtype in zip(b.schema.names, b.schema.types):
        x, y = np.asarray(a.columns[name]), np.asarray(b.columns[name])
        assert x.dtype == y.dtype, name
        if dtype.is_string:
            x, y = a.string_tables[name].decode(x), b.string_tables[name].decode(y)
        np.testing.assert_array_equal(x, y, err_msg=name)
        va, vb = a.validities.get(name), b.validities.get(name)
        assert (va is None) == (vb is None), name
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=name)


def test_page_roundtrip(table):
    for compress in (False, True):
        _assert_tables_equal(table, deserialize_page(serialize_page(table, compress=compress)))


def test_page_crc_detects_corruption(table):
    buf = bytearray(serialize_page(table))
    buf[-1] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        deserialize_page(bytes(buf))
    buf = bytearray(serialize_page(table))
    buf[0] ^= 0xFF
    with pytest.raises(ValueError, match="not a velox page"):
        deserialize_page(bytes(buf))


def test_unsaferow_roundtrip(table):
    rows = encode_unsaferow(table)
    assert len(rows) == table.num_rows
    for r in rows:  # UnsafeRow invariants: 8-byte aligned
        assert len(r) % 8 == 0
    _assert_tables_equal(table, decode_unsaferow(rows, table.schema))


def test_compactrow_roundtrip_and_density(table):
    urows = encode_unsaferow(table)
    crows = encode_compactrow(table)
    _assert_tables_equal(table, decode_compactrow(crows, table.schema))
    assert sum(map(len, crows)) < sum(map(len, urows))  # compact is denser


def test_rows_bytes_equal_reference(table):
    """UnsafeRow, CompactRow and the framed UnsafeRow stream: the JAX
    package's bytes, and each package decodes the other's rows."""
    ref = _serde_table(vt, RefTable, RefStringTable)
    assert encode_unsaferow(table) == ref_serde.encode_unsaferow(ref)
    assert encode_compactrow(table) == ref_serde.encode_compactrow(ref)
    stream = serialize_unsaferow_stream(table)
    assert stream == ref_serde.serialize_unsaferow_stream(ref)
    _assert_tables_equal(deserialize_unsaferow_stream(stream, table.schema), table)
    _assert_same_rows(
        decode_unsaferow(ref_serde.encode_unsaferow(ref), table.schema),
        ref_serde.decode_unsaferow(encode_unsaferow(table), ref.schema),
    )
    _assert_same_rows(
        decode_compactrow(ref_serde.encode_compactrow(ref), table.schema),
        ref_serde.decode_compactrow(encode_compactrow(table), ref.schema),
    )


def test_rows_of_every_fixed_width_type_equal_reference():
    rng = np.random.default_rng(21)
    n = 300
    cols = {
        "b": rng.random(n) < 0.5,
        "t": rng.integers(-128, 128, n).astype(np.int8),
        "s": rng.integers(-(1 << 15), 1 << 15, n).astype(np.int16),
        "i": rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
        "l": rng.integers(-(1 << 62), 1 << 62, n),
        "r": rng.standard_normal(n).astype(np.float32),
        "d": rng.standard_normal(n),
        "dt": rng.integers(0, 30000, n).astype(np.int32),
        "ts": rng.integers(0, 1 << 52, n),
        "m": rng.integers(-(10**15), 10**15, n),
    }
    valid = {"i": rng.random(n) > 0.3, "d": rng.random(n) > 0.3}
    tables = []
    for mod, table_cls in ((vt, RefTable), (vtt, Table)):
        schema = mod.RowType(list(cols), [
            mod.BOOLEAN, mod.TINYINT, mod.SMALLINT, mod.INTEGER, mod.BIGINT, mod.REAL,
            mod.DOUBLE, mod.DATE, mod.TIMESTAMP, mod.decimal(18, 3)])
        tables.append(table_cls(schema, dict(cols), {}, dict(valid)))
    ref, port = tables
    assert encode_unsaferow(port) == ref_serde.encode_unsaferow(ref)
    assert encode_compactrow(port) == ref_serde.encode_compactrow(ref)
    _assert_tables_equal(decode_unsaferow(encode_unsaferow(port), port.schema), port)
    _assert_tables_equal(decode_compactrow(encode_compactrow(port), port.schema), port)


def test_vector_saver_roundtrip(tmp_path):
    """Reference: vector/VectorSaver.h — persist exact inputs for repro."""
    from velox_tpu.vector.saver import load_table as ref_load_table
    from velox_tpu_torch.vector.saver import load_batch, save_batch, save_table

    st = StringTable()
    codes = st.intern_all(["a", "bb", "a", "ccc"])
    t = Table(
        vtt.RowType(["s", "x"], [vtt.VARCHAR, vtt.BIGINT]),
        {"s": codes, "x": np.array([1, 2, 3, 4], np.int64)},
        string_tables={"s": st},
        validities={"x": np.array([True, False, True, True])},
    )
    batch = t.tile(0, 8, "cpu")
    path = str(tmp_path / "repro" / "batch.vxpg")
    save_batch(batch, path)
    back = load_batch(path, device="cpu")
    assert list(back.schema.names) == ["s", "x"]
    assert back.capacity == 4
    vals, validity = back.column("x").decode(back.capacity)
    n = int(back.length)
    np.testing.assert_array_equal(vals.numpy()[:n], [1, 2, 3, 4])
    np.testing.assert_array_equal(validity.numpy()[:n], [True, False, True, True])
    s = back.column("s")
    assert s.strings.decode(s.data.numpy()[:n]).tolist() == ["a", "bb", "a", "ccc"]
    assert load_batch(path, capacity=16, device="cpu").capacity == 16
    # the JAX package reads the saved file
    assert ref_load_table(path).to_pandas().equals(t.to_pandas())
    # a table saved directly gives the same bytes as the batch's rows
    assert open(save_table(t, str(tmp_path / "t.vxpg")), "rb").read() == open(path, "rb").read()


def test_saver_flattens_every_encoding(tmp_path):
    """A fuzzed batch of every encoding (SEQUENCE and BIAS included) saves
    its live rows, decoded."""
    from velox_tpu_torch.vector.fuzzer import FuzzerOptions, VectorFuzzer
    from velox_tpu_torch.vector.saver import load_batch, save_batch

    fz = VectorFuzzer(5, FuzzerOptions(sequence_ratio=0.3, bias_ratio=0.3), device="cpu")
    schema = fz.schema(8)
    batch = fz.batch(schema, 64)
    path = save_batch(batch, str(tmp_path / "fz.vxpg"))
    back = load_batch(path, device="cpu")
    pd.testing.assert_frame_equal(back.to_pandas(), batch.to_pandas(), check_dtype=False)


def test_page_roundtrip_complex_columns():
    from velox_tpu_torch.dtypes import array, map_, row
    from velox_tpu_torch.vector.complex import HostSegments, HostStruct

    at, mt = array(vtt.BIGINT), map_(vtt.VARCHAR, vtt.BIGINT)
    rt = row(["a", "b"], [vtt.BIGINT, vtt.VARCHAR])
    seg, sv = HostSegments.from_pylist([[1, 2], None, [3, None]], at)
    mseg, _ = HostSegments.from_pylist([{"x": 1}, {}, {"y": 2, "z": 3}], mt)
    st, rv = HostStruct.from_pylist([{"a": 1, "b": "p"}, None, {"a": 3, "b": "q"}], rt)
    t = Table(
        vtt.RowType(["k", "arr", "m", "r"], [vtt.BIGINT, at, mt, rt]),
        {"k": np.array([10, 20, 30], np.int64), "arr": seg, "m": mseg, "r": st},
        validities={"arr": sv, "r": rv},
    )
    page = serialize_page(t)
    back = deserialize_page(page)
    assert back.columns["k"].tolist() == [10, 20, 30]
    assert back.columns["arr"].to_pylist(back.validities["arr"]) == [[1, 2], None, [3, None]]
    assert back.columns["m"].to_pylist() == [{"x": 1}, {}, {"y": 2, "z": 3}]
    assert back.columns["r"].to_pylist(back.validities["r"]) == [
        {"a": 1, "b": "p"}, None, {"a": 3, "b": "q"}
    ]
    # the JAX package's page of the same rows is the same bytes
    from velox_tpu.dtypes import array as r_array, map_ as r_map, row as r_row
    from velox_tpu.vector.complex import HostSegments as RSeg, HostStruct as RStruct

    rat, rmt = r_array(vt.BIGINT), r_map(vt.VARCHAR, vt.BIGINT)
    rrt = r_row(["a", "b"], [vt.BIGINT, vt.VARCHAR])
    rseg, rsv = RSeg.from_pylist([[1, 2], None, [3, None]], rat)
    rmseg, _ = RSeg.from_pylist([{"x": 1}, {}, {"y": 2, "z": 3}], rmt)
    rst, rrv = RStruct.from_pylist([{"a": 1, "b": "p"}, None, {"a": 3, "b": "q"}], rrt)
    ref = RefTable(
        vt.RowType(["k", "arr", "m", "r"], [vt.BIGINT, rat, rmt, rrt]),
        {"k": np.array([10, 20, 30], np.int64), "arr": rseg, "m": rmseg, "r": rst},
        validities={"arr": rsv, "r": rrv},
    )
    assert ref_serde.serialize_page(ref) == page


# ---- UnsafeRow golden bytes (Spark layout; independent of the encoder) -------------


def test_unsaferow_golden_bigint_varchar_nulldouble():
    strings = StringTable()
    codes = strings.intern_all(["hello"])
    t = Table(
        vtt.RowType(["a", "s", "d"], [vtt.BIGINT, vtt.VARCHAR, vtt.DOUBLE]),
        {"a": np.asarray([42], dtype=np.int64), "s": codes, "d": np.asarray([0.0])},
        {"s": strings},
        {"d": np.asarray([False])},
    )
    (row,) = encode_unsaferow(t)
    expected = bytes.fromhex(
        "0400000000000000"  # null bitset: field 2 (d) is null
        "2a00000000000000"  # a = 42
        "0500000020000000"  # s: size=5, offset=32 -> (32<<32)|5, little-endian
        "0000000000000000"  # d: null slot is zeroed
        "68656c6c6f000000"  # "hello" + 3 pad bytes to 8-byte alignment
    )
    assert row == expected
    _assert_tables_equal(decode_unsaferow([row], t.schema), t)


def test_unsaferow_golden_negative_int_zero_padded():
    t = Table(
        vtt.RowType(["i", "b", "f"], [vtt.INTEGER, vtt.BOOLEAN, vtt.REAL]),
        {"i": np.asarray([-7], dtype=np.int32), "b": np.asarray([True]),
         "f": np.asarray([1.5], dtype=np.float32)},
    )
    (row,) = encode_unsaferow(t)
    expected = bytes.fromhex(
        "0000000000000000"  # no nulls
        "f9ffffff00000000"  # int32 -7: low 4 bytes, HIGH 4 BYTES ZERO
        "0100000000000000"  # boolean true: one byte
        "0000c03f00000000"  # float 1.5 = 0x3FC00000, low 4 bytes
    )
    assert row == expected
    back = decode_unsaferow([row], t.schema)
    assert int(back.columns["i"][0]) == -7
    _assert_tables_equal(back, t)


def test_unsaferow_golden_date_timestamp_smallint():
    t = Table(
        vtt.RowType(["dt", "ts", "sh"], [vtt.DATE, vtt.TIMESTAMP, vtt.SMALLINT]),
        {"dt": np.asarray([19000], dtype=np.int32),
         "ts": np.asarray([1_600_000_000_000_000], dtype=np.int64),
         "sh": np.asarray([-2], dtype=np.int16)},
    )
    (row,) = encode_unsaferow(t)
    expected = (
        b"\x00" * 8
        + b"\x38\x4a\x00\x00" + b"\x00" * 4  # date 19000 days = 0x4A38
        + struct.pack("<q", 1_600_000_000_000_000)
        + b"\xfe\xff" + b"\x00" * 6  # int16 -2, zero-padded
    )
    assert row == expected
    _assert_tables_equal(decode_unsaferow([row], t.schema), t)


def test_unsaferow_stream_framing_big_endian():
    t = Table(vtt.RowType(["a"], [vtt.BIGINT]), {"a": np.asarray([1, 2], dtype=np.int64)})
    data = serialize_unsaferow_stream(t)
    assert data[:4] == b"\x00\x00\x00\x10"
    assert len(data) == 2 * (4 + 16)
    assert data[20:24] == b"\x00\x00\x00\x10"
    _assert_tables_equal(deserialize_unsaferow_stream(data, t.schema), t)


def test_unsaferow_nan_canonicalized():
    t = Table(
        vtt.RowType(["d"], [vtt.DOUBLE]),
        {"d": np.frombuffer(struct.pack("<Q", 0x7FF8000000000001), np.float64)},
    )
    (row,) = encode_unsaferow(t)
    assert row[8:16] == struct.pack("<d", float("nan"))


def test_unsaferow_long_decimal_raises():
    t = Table(vtt.RowType(["m"], [vtt.decimal(38, 2)]),
              {"m": np.zeros((2, 2), dtype=np.int64)})
    with pytest.raises(NotImplementedError, match="DECIMAL"):
        encode_unsaferow(t)
