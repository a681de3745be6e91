"""File formats and the Arrow bridge of the port (``velox_tpu_torch/io/``)
against the JAX package: the cases of ``tests/test_filesystems.py``,
``tests/test_arrow_bridge.py``, the parquet row-group pruning of
``tests/test_connectors.py`` and the plain-string ingest of
``tests/test_native.py``, and files across packages: parquet written by
either package reads in the other into an equal table (DECIMAL(38, 2) with
NULLs, DATE, NULLs, VARCHAR), and both packages write the same bytes for the
same table.  Tables are compared column by column, exactly."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import velox_tpu as vt
import velox_tpu_torch as vtt
from velox_tpu.io.table import Table as RefTable
from velox_tpu.vector.string_table import StringTable as RefStringTable
from velox_tpu_torch.io.filesystems import (
    MemoryFileSystem,
    filesystem_for,
    register_filesystem,
)
from velox_tpu_torch.io.table import Table, _row_group_may_match
from velox_tpu_torch.vector.string_table import StringTable


def make_table(n=500, seed=1, mod=vtt, table_cls=Table, st_cls=StringTable):
    rng = np.random.default_rng(seed)
    tab = st_cls()
    codes = tab.intern_all(["red", "green", "blue"])
    return table_cls(
        mod.RowType(["k", "v", "c"], [mod.BIGINT, mod.BIGINT, mod.VARCHAR]),
        {
            "k": rng.integers(0, 10, n),
            "v": rng.integers(0, 100, n),
            "c": np.asarray(codes)[rng.integers(0, 3, n)].astype(np.int32),
        },
        string_tables={"c": tab},
    )


def assert_tables_equal(got, want):
    """Same schema (by type text), columns, validity and decoded strings."""
    assert list(got.schema.names) == list(want.schema.names)
    assert [str(t) for t in got.schema.types] == [str(t) for t in want.schema.types]
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        if dtype.is_string:
            g = got.string_tables[name].decode(g)
            w = want.string_tables[name].decode(w)
        assert g.dtype == w.dtype or dtype.is_string, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)
        gv, wv = got.validities.get(name), want.validities.get(name)
        assert (gv is None) == (wv is None), name
        if gv is not None:
            np.testing.assert_array_equal(gv, wv, err_msg=name)


# ---- tests/test_filesystems.py ---------------------------------------------------


def test_memory_parquet_roundtrip():
    t = make_table()
    path = "memory://datasets/t1.parquet"
    t.save_parquet(path)
    back = Table.load_parquet(path)
    assert back.num_rows == t.num_rows
    np.testing.assert_array_equal(back.columns["v"], t.columns["v"])
    assert back.to_pandas()["c"].tolist() == t.to_pandas()["c"].tolist()


def test_hive_dataset_on_memory_fs():
    from velox_tpu_torch.connectors.hive import read_table, write_table

    t = make_table(300, seed=2)
    root = "memory://warehouse/tbl"
    written = write_table(root, t, partition_by=["c"])
    assert all(p.startswith("memory://") for p in written)
    back = read_table(root)
    assert back.num_rows == t.num_rows
    # partition column round-trips as a synthesized constant column, last
    assert list(back.schema.names) == ["k", "v", "c"]
    assert sorted(back.to_pandas()["c"].tolist()) == sorted(t.to_pandas()["c"].tolist())


def test_gated_remote_schemes():
    for scheme in ("s3", "hdfs", "gs", "abfs"):
        fs, local = filesystem_for(f"{scheme}://bucket/key")
        with pytest.raises(NotImplementedError, match="no network egress"):
            fs.open_input(local)


def test_unknown_scheme():
    with pytest.raises(ValueError, match="no filesystem registered"):
        filesystem_for("ftp://host/x")


def test_custom_scheme_registration():
    class Upper(MemoryFileSystem):
        pass

    register_filesystem("torchtestfs", Upper)
    fs, local = filesystem_for("torchtestfs://a/b")
    assert isinstance(fs, Upper)
    with fs.open_output(local) as f:
        f.write(b"hello")
    assert fs.open_input(local).read() == b"hello"
    assert fs.exists(local)
    fs.remove(local)
    assert not fs.exists(local)


def test_local_roundtrip(tmp_path):
    t = make_table(100, seed=3)
    p = str(tmp_path / "x.parquet")
    t.save_parquet(p)
    assert_tables_equal(Table.load_parquet(p), t)


def test_orc_roundtrip(tmp_path):
    """ORC read/write (reference: dwio/dwrf + dwio/orc) via the Arrow
    exporter; dictionary strings survive (re-interned on read)."""
    t = make_table(300, seed=7)
    p = str(tmp_path / "x.orc")
    t.save_orc(p)
    back = Table.load_orc(p)
    assert back.num_rows == 300
    np.testing.assert_array_equal(np.asarray(back.columns["v"]), np.asarray(t.columns["v"]))
    assert back.to_pandas()["c"].tolist() == t.to_pandas()["c"].tolist()
    pruned = Table.load_orc(p, columns=["k"])
    assert list(pruned.schema.names) == ["k"]
    # the JAX package reads the port's ORC file into an equal table
    assert_tables_equal(RefTable.load_orc(p), back)


def test_hive_dataset_with_orc_files(tmp_path):
    from velox_tpu_torch.connectors.hive import read_table

    t = make_table(200, seed=8)
    root = str(tmp_path / "tbl")
    os.makedirs(root)
    t.save_orc(os.path.join(root, "part-0.orc"))
    back = read_table(root)
    assert back.num_rows == 200


# ---- tests/test_arrow_bridge.py --------------------------------------------------


def make_arrow_table(n=200, seed=5, mod=vtt, table_cls=Table, st_cls=StringTable):
    rng = np.random.default_rng(seed)
    st = st_cls()
    codes = st.intern_all(["ash", "oak", "fir"])
    return table_cls(
        mod.RowType(
            ["i", "d", "s", "dt", "ts", "m"],
            [mod.BIGINT, mod.DOUBLE, mod.VARCHAR, mod.DATE, mod.TIMESTAMP, mod.decimal(12, 2)],
        ),
        {
            "i": rng.integers(-100, 100, n),
            "d": rng.random(n),
            "s": np.asarray(codes)[rng.integers(0, 3, n)].astype(np.int32),
            "dt": rng.integers(0, 20000, n).astype(np.int32),
            "ts": rng.integers(0, 10**15, n),
            "m": rng.integers(-(10**6), 10**6, n),
        },
        string_tables={"s": st},
        validities={"i": rng.random(n) > 0.1},
    )


def test_roundtrip_through_arrow():
    t = make_arrow_table()
    at = t.to_arrow()
    assert at.num_rows == t.num_rows
    back = Table.from_arrow(at)
    for col in ("i", "d", "dt", "ts", "m"):
        np.testing.assert_array_equal(
            np.asarray(back.columns[col]),
            np.asarray(t.columns[col])
            if col != "i"
            else np.where(t.validities["i"], t.columns["i"], 0),
        )
    assert back.schema.type_of("m").scale == 2
    assert back.to_pandas()["s"].tolist() == t.to_pandas()["s"].tolist()
    np.testing.assert_array_equal(back.validities["i"], t.validities["i"])
    # the same Arrow table as the JAX package exports, and the same import
    ref = make_arrow_table(mod=vt, table_cls=RefTable, st_cls=RefStringTable)
    assert at.equals(ref.to_arrow())
    assert_tables_equal(back, RefTable.from_arrow(at))


def test_capsule_export():
    """Any PyCapsule-aware consumer ingests a Table directly."""
    t = make_arrow_table(50, seed=6)
    at = pa.table(t)  # consumes __arrow_c_stream__
    assert at.num_rows == 50
    assert set(at.schema.names) == set(t.schema.names)


def test_capsule_import():
    """from_arrow accepts any object exposing __arrow_c_stream__."""

    class Shim:
        def __init__(self, inner):
            self._inner = inner

        def __arrow_c_stream__(self, requested_schema=None):
            return self._inner.__arrow_c_stream__(requested_schema)

    src = pa.table({"a": [1, 2, 3], "b": [1.5, None, 2.5]})
    t = Table.from_arrow(Shim(src))
    assert t.num_rows == 3
    np.testing.assert_array_equal(t.columns["a"], [1, 2, 3])
    np.testing.assert_array_equal(t.validities["b"], [True, False, True])


def test_from_arrow_reader_and_batches():
    batches = [pa.record_batch({"k": pa.array([1, 2], pa.int64())}),
               pa.record_batch({"k": pa.array([3], pa.int64())})]
    reader = pa.RecordBatchReader.from_batches(batches[0].schema, batches)
    np.testing.assert_array_equal(Table.from_arrow(reader).columns["k"], [1, 2, 3])
    np.testing.assert_array_equal(Table.from_arrow(iter(batches)).columns["k"], [1, 2, 3])


def test_arrow_scan_pipeline():
    """An arrow table feeds a plan through a table scan."""
    from velox_tpu_torch.exec.runner import run_plan
    from velox_tpu_torch.plan import PlanBuilder

    src = pa.table({"k": pa.array([1, 2, 1, 3] * 50), "v": pa.array(range(200))})
    t = Table.from_arrow(src)
    out = run_plan(
        PlanBuilder().table_scan(t).aggregation(["k"], ["sum(v) as s"]).orderby(["k"]).build(),
        device="cpu",
    ).to_pandas()
    expect = src.to_pandas().groupby("k").v.sum().sort_index()
    assert out["s"].tolist() == expect.tolist()


# ---- decimal buffers, sliced and chunked -------------------------------------------


def _long_decimal_arrow():
    vals = [None, 10**36 + 7, -(10**36) - 3, 12345, None, -1, 99**18]
    from decimal import Context, Decimal

    cx = Context(prec=50)  # the default 28 digits would round the values
    arr = pa.array([None if v is None else Decimal(v).scaleb(-2, cx) for v in vals],
                   pa.decimal128(38, 2))
    return arr, vals


def test_long_decimal_limbs_at_an_offset():
    """DECIMAL(38, 2) with NULLs: the (n, 2) [lo, hi] limbs read at the
    array's offset (a slice, and chunks) equal the JAX package's, and the
    limbs are the two's-complement value ops/int128.py reads."""
    from velox_tpu_torch.ops.int128 import np_to_int

    arr, vals = _long_decimal_arrow()
    for source in (
        pa.table({"x": arr.slice(2)}),
        pa.table({"x": pa.chunked_array([arr.slice(0, 3), arr.slice(3)])}),
    ):
        t = Table.from_arrow(source)
        assert_tables_equal(t, RefTable.from_arrow(source))
        want = vals[-source.num_rows:]
        limbs = t.columns["x"]
        assert limbs.shape == (source.num_rows, 2)
        valid = t.validities["x"]
        ints = np_to_int(limbs[:, 1], limbs[:, 0])
        for got, ok, w in zip(ints, valid, want):
            assert ok == (w is not None)
            if ok:
                assert got == w


# ---- parquet row-group pruning (tests/test_connectors.py) ---------------------------


def test_parquet_row_group_pruning(tmp_path):
    path = str(tmp_path / "t.parquet")
    ks = np.arange(3000, dtype=np.int64)
    pq.write_table(pa.table({"k": ks, "v": ks * 10}), path, row_group_size=1000)
    assert Table.load_parquet(path).num_rows == 3000
    pruned = Table.load_parquet(path, ranges={"k": (1200, 1300)})
    assert pruned.num_rows == 1000  # only the middle row group survives
    assert pruned.columns["k"].min() == 1000 and pruned.columns["k"].max() == 1999
    assert Table.load_parquet(path, ranges={"k": (5000, None)}).num_rows == 0
    assert Table.load_parquet(path, ranges={"k": (None, 999)}).num_rows == 1000
    empty = Table.load_parquet(path, columns=["v"], ranges={"k": (5000, None)})
    assert list(empty.schema.names) == ["v"] and empty.num_rows == 0
    meta = pq.ParquetFile(path).metadata
    ranges = {"k": (1200, 2100)}
    assert [_row_group_may_match(meta.row_group(i), ranges) for i in range(3)] == [
        False, True, True,
    ]
    for r in ({"k": (1200, 1300)}, {"v": (None, 25_000)}, {"k": (2999, 2999)}):
        assert_tables_equal(
            Table.load_parquet(path, ranges=r), RefTable.load_parquet(path, ranges=r)
        )


def test_parquet_plain_string_ingest(tmp_path):
    """Plain (not dictionary) string columns intern natively in order of
    first appearance, as the Python fallback and the JAX package do."""
    path = str(tmp_path / "plain.parquet")
    pq.write_table(pa.table({"name": ["x", "y", "x", "", "zzz"], "v": [1, 2, 3, 4, 5]}), path)
    t = Table.load_parquet(path)
    assert t.string_tables["name"].decode(t.columns["name"]).tolist() == [
        "x", "y", "x", "", "zzz",
    ]
    np.testing.assert_array_equal(t.columns["v"], [1, 2, 3, 4, 5])
    ref = RefTable.load_parquet(path)
    np.testing.assert_array_equal(t.columns["name"], ref.columns["name"])
    assert t.string_tables["name"].values() == ref.string_tables["name"].values()


def test_plain_string_native_and_fallback_codes_agree(monkeypatch):
    from velox_tpu_torch import native
    from velox_tpu_torch.io.table import _intern_arrow_strings

    rng = np.random.default_rng(4)
    words = ["", "a", "bb", "日本", "ccc", "a "]
    arr = pa.array([None if i % 7 == 0 else words[j] for i, j in
                    enumerate(rng.integers(0, len(words), 400))]).slice(3)
    table, codes = _intern_arrow_strings(arr)
    assert native.available()
    monkeypatch.setattr(native, "intern_strings", lambda blob, offsets: None)
    fb_table, fb_codes = _intern_arrow_strings(arr)
    np.testing.assert_array_equal(codes, fb_codes)
    assert table.values() == fb_table.values()


# ---- files across packages ---------------------------------------------------------


def _rich_tables():
    """The same rows in both packages: BIGINT with NULLs, DOUBLE, VARCHAR,
    DATE, DECIMAL(12, 2), DECIMAL(38, 2) with NULLs, BOOLEAN, TIMESTAMP."""
    rng = np.random.default_rng(11)
    n = 777
    lo = rng.integers(-(1 << 62), 1 << 62, n)
    hi = rng.integers(-(1 << 40), 1 << 40, n)
    cols = {
        "id": np.arange(n, dtype=np.int64),
        "x": rng.integers(-1000, 1000, n),
        "d": rng.standard_normal(n),
        "s": rng.integers(0, 4, n).astype(np.int32),
        "dt": rng.integers(8000, 11000, n).astype(np.int32),
        "m": rng.integers(-(10**9), 10**9, n),
        "big": np.stack([lo, hi], axis=1),
        "b": rng.random(n) < 0.5,
        "ts": rng.integers(0, 10**15, n),
    }
    validities = {"x": rng.random(n) > 0.2, "big": rng.random(n) > 0.3,
                  "d": rng.random(n) > 0.1}
    out = []
    for mod, table_cls, st_cls in ((vt, RefTable, RefStringTable), (vtt, Table, StringTable)):
        st = st_cls()
        st.intern_all(["alpha", "beta", "gamma", "日本語"])
        schema = mod.RowType(
            list(cols),
            [mod.BIGINT, mod.BIGINT, mod.DOUBLE, mod.VARCHAR, mod.DATE, mod.decimal(12, 2),
             mod.decimal(38, 2), mod.BOOLEAN, mod.TIMESTAMP],
        )
        # NULL rows hold zeros, as every reader returns them
        data = {k: v.copy() for k, v in cols.items()}
        for k, v in validities.items():
            data[k][~v] = 0
        out.append(table_cls(schema, data, {"s": st}, dict(validities)))
    return out


def _without_nulls(t, table_cls):
    return table_cls(t.schema, t.columns, t.string_tables, {})


def test_parquet_across_packages(tmp_path):
    ref, port = _rich_tables()
    # without NULLs: the same file, byte for byte, from the same rows, and
    # each package reads the other's file into the rows written
    paths = {k: str(tmp_path / f"{k}.parquet") for k in ("ref", "port", "ref_n", "port_n")}
    _without_nulls(ref, RefTable).save_parquet(paths["ref"])
    _without_nulls(port, Table).save_parquet(paths["port"])
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    assert_tables_equal(Table.load_parquet(paths["ref"]), _without_nulls(port, Table))
    assert_tables_equal(RefTable.load_parquet(paths["port"]), _without_nulls(ref, RefTable))
    # with NULLs (BIGINT, DOUBLE, DECIMAL(38, 2)): the port writes them and
    # the JAX package reads them back; the JAX package's writer drops them
    # (NULL rows read back as zeros, in both packages alike)
    ref.save_parquet(paths["ref_n"])
    port.save_parquet(paths["port_n"])
    assert_tables_equal(RefTable.load_parquet(paths["port_n"]), ref)
    assert_tables_equal(Table.load_parquet(paths["port_n"]), port)
    assert pq.read_table(paths["ref_n"]).column("big").null_count == 0
    assert pq.read_table(paths["port_n"]).column("big").null_count == int(
        (~port.validities["big"]).sum()
    )
    assert_tables_equal(Table.load_parquet(paths["ref_n"]), RefTable.load_parquet(paths["ref_n"]))
    meta = pq.read_schema(paths["port_n"]).metadata
    assert meta[b"velox_tpu:big"] == b"DECIMAL:38:2" and meta[b"velox_tpu:dt"] == b"DATE"
    cols = ["s", "big", "dt"]
    assert_tables_equal(Table.load_parquet(paths["port_n"], columns=cols),
                        RefTable.load_parquet(paths["port_n"], columns=cols))


def test_arrow_export_across_packages():
    ref, port = _rich_tables()
    small = [c for c in port.schema.names if c != "big"]  # to_arrow of short types
    a = port.select(small).to_arrow()
    b = ref.select(small).to_arrow()
    assert a.equals(b)
    assert_tables_equal(Table.from_arrow(b), RefTable.from_arrow(a))


def test_loaded_table_tiles_on_the_cpu(tmp_path):
    """A table read back from parquet slices into device tiles like the one
    written (narrow integer uploads, validity, dictionary codes)."""
    _, port = _rich_tables()
    path = str(tmp_path / "t.parquet")
    port.save_parquet(path)
    back = Table.load_parquet(path)
    cols = ["id", "x", "s", "dt", "m", "b", "ts"]
    for i in range(port.num_tiles(256)):
        got = back.select(cols).tile(i, 256, "cpu").to_pandas()
        want = port.select(cols).tile(i, 256, "cpu").to_pandas()
        assert got.equals(want)
