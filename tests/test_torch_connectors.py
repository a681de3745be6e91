"""Connectors of the port (``velox_tpu_torch/connectors/``, the table-write
plan nodes, the reporter and the config tier) against the JAX package: the
cases of ``tests/test_connectors.py``, the ``tests/test_misc_components.py``
cases for Arrow streams, table-write merge, the reporter and the config
tier, and the TPC-H parquet cache.  A partitioned or bucketed Hive write gives
the JAX package's directory tree, file names and rows a file (and, for rows
without NULLs, the same bytes a file), from a vectorized split where the JAX
package loops over rows."""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import velox_tpu as vt
import velox_tpu_torch as vtt
from velox_tpu.connectors.hive import HiveDataSink as RefSink
from velox_tpu.connectors.hive import HiveDataSource as RefSource
from velox_tpu.connectors.hive import _discover as ref_discover
from velox_tpu.io.table import Table as RefTable
from velox_tpu.vector.string_table import StringTable as RefStringTable
from velox_tpu_torch.connectors.base import ConnectorSplit, get_connector
from velox_tpu_torch.connectors.hive import (
    HiveDataSink,
    HiveDataSource,
    _discover,
    hash64_np,
    read_table,
    write_table,
)
from velox_tpu_torch.exec import run_plan
from velox_tpu_torch.io.table import Table
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.vector.string_table import StringTable

CPU = "cpu"


def sample_table(n=200, seed=0):
    rng = np.random.default_rng(seed)
    st = StringTable()
    regions = ["asia", "europe", "americas"]
    codes = st.intern_all([regions[i % 3] for i in range(n)])
    return Table(
        vtt.RowType(["id", "v", "region"], [vtt.BIGINT, vtt.DOUBLE, vtt.VARCHAR]),
        {"id": np.arange(n, dtype=np.int64), "v": rng.normal(size=n), "region": codes},
        string_tables={"region": st},
    )


# ---- tests/test_connectors.py ----------------------------------------------------


def test_write_read_roundtrip(tmp_path):
    t = sample_table()
    root = str(tmp_path / "flat")
    paths = write_table(root, t)
    assert len(paths) == 1 and paths[0].endswith(".parquet")
    back = read_table(root)
    pd.testing.assert_frame_equal(
        back.to_pandas().sort_values("id").reset_index(drop=True), t.to_pandas()
    )


def test_partitioned_write_and_pruned_scan(tmp_path):
    t = sample_table()
    root = str(tmp_path / "part")
    paths = write_table(root, t, partition_by=["region"])
    assert len(paths) == 3
    assert any("region=asia" in p for p in paths)
    back = read_table(root, columns=["id", "v", "region"])
    a = back.to_pandas().sort_values("id").reset_index(drop=True)
    b = t.to_pandas().sort_values("id").reset_index(drop=True)
    pd.testing.assert_frame_equal(a[["id", "v", "region"]], b[["id", "v", "region"]])
    asia = read_table(root, columns=["id", "region"],
                      partition_filter=lambda keys: keys.get("region") == "asia")
    expect_ids = b.loc[b["region"] == "asia", "id"].to_numpy()
    np.testing.assert_array_equal(np.sort(asia.columns["id"]), np.sort(expect_ids))
    assert set(asia.string_tables["region"].decode(asia.columns["region"])) == {"asia"}


def test_table_write_plan_node(tmp_path):
    t = sample_table()
    root = str(tmp_path / "sinkout")
    plan = PlanBuilder().table_scan(t).filter("v > 0e0").table_write(root).build()
    out = run_plan(plan, device=CPU).to_pandas()
    kept = int((t.to_pandas()["v"] > 0).sum())
    assert out["rows"].iloc[0] == kept
    assert read_table(root).num_rows == kept


def test_partitioned_table_write_of_an_aggregation(tmp_path):
    """The write consumes the whole result of the plan below it, after the
    aggregation's finish: one file a group key."""
    t = sample_table(300, seed=5)
    root = str(tmp_path / "agg")
    plan = (
        PlanBuilder().table_scan(t).aggregation(["region"], ["count(*) as n", "sum(id) as s"])
        .table_write(root, partition_by=["region"]).build()
    )
    assert run_plan(plan, device=CPU).columns["rows"].tolist() == [3]
    back = read_table(root).to_pandas().sort_values("region").reset_index(drop=True)
    assert back["region"].tolist() == ["americas", "asia", "europe"]
    assert back["n"].tolist() == [100, 100, 100]


def test_connector_registry_and_splits(tmp_path):
    t = sample_table(50)
    root = str(tmp_path / "reg")
    write_table(root, t, partition_by=["region"])
    conn = get_connector("hive")
    src = conn.create_data_source(columns=["id", "region"])
    splits = _discover(root)
    assert all(isinstance(s, ConnectorSplit) for s in splits)
    for s in splits:
        src.add_split(s)
    assert src.to_table().num_rows == 50
    with pytest.raises(ValueError, match="no splits"):
        HiveDataSource().to_table()


def test_bucketed_partitioned_writes(tmp_path):
    st = StringTable()
    t = Table(
        vtt.RowType(["region", "k", "v"], [vtt.VARCHAR, vtt.BIGINT, vtt.BIGINT]),
        {"region": st.intern_all(["eu", "eu", "us", "us"]),
         "k": np.array([1, 2, 3, 4], np.int64), "v": np.array([10, 20, 30, 40], np.int64)},
        {"region": st},
    )
    root = str(tmp_path / "bp")
    sink = HiveDataSink(root, partition_by=["region"], bucket_by=["k"], bucket_count=2)
    sink.append(t)
    files = sink.finish()
    assert all(os.sep + "region=" in f for f in files)
    assert any("00000_0_" in os.path.basename(f) or "00001_0_" in os.path.basename(f)
               for f in files)
    assert sorted(np.asarray(read_table(root).columns["v"]).tolist()) == [10, 20, 30, 40]


def test_hive_source_range_filter(tmp_path):
    path = str(tmp_path / "part.parquet")
    pq.write_table(pa.table({"k": np.arange(2000, dtype=np.int64)}), path, row_group_size=500)
    src = HiveDataSource(columns=["k"], range_filter={"k": (600, 700)})
    src.add_split(ConnectorSplit(path=path, partition_keys={}))
    t = src.to_table()
    assert t.num_rows == 500  # one of four row groups decoded
    assert t.columns["k"].min() == 500


def test_hash64_matches_the_exchange_hash():
    import jax.numpy as jnp

    from velox_tpu.parallel.exchange import hash64

    keys = np.random.default_rng(3).integers(-(1 << 62), 1 << 62, 4096)
    keys[:4] = [0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    np.testing.assert_array_equal(hash64_np(keys), np.asarray(hash64(jnp.asarray(keys))))


# ---- Hive trees across packages --------------------------------------------------


def _tree(root):
    """{relative path: file bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _pair(n, seed, nulls=False):
    """The same rows as a JAX-package table and a port table: a VARCHAR key,
    a BIGINT key whose values sort differently as text ("10" < "9"), a DOUBLE
    key with -0.0, 0.0 and NaN, and payload columns."""
    rng = np.random.default_rng(seed)
    words = ["b", "a", "c", "", "日本"]
    cols = {
        "s": rng.integers(0, len(words), n).astype(np.int32),
        "k": rng.choice(np.array([9, 10, 11, -2, 100], np.int64), n),
        "f": rng.choice(np.array([-0.0, 0.0, np.nan, 1.5]), n),
        "id": np.arange(n, dtype=np.int64),
        "v": rng.integers(-(10**6), 10**6, n),
    }
    validities = {"v": rng.random(n) > 0.2} if nulls else {}
    out = []
    for mod, table_cls, st_cls in ((vt, RefTable, RefStringTable), (vtt, Table, StringTable)):
        st = st_cls()
        st.intern_all(words)
        schema = mod.RowType(list(cols), [mod.VARCHAR, mod.BIGINT, mod.DOUBLE, mod.BIGINT,
                                          mod.decimal(12, 2)])
        out.append(table_cls(schema, dict(cols), {"s": st}, dict(validities)))
    return out


@pytest.mark.parametrize(
    "partition_by,bucket_by,bucket_count",
    [(["s"], [], 0), (["k"], [], 0), (["f"], [], 0), (["k", "s"], [], 0),
     (["s"], ["id"], 4), ([], ["k", "id"], 3)],
)
def test_hive_writes_match_reference(tmp_path, partition_by, bucket_by, bucket_count):
    ref, port = _pair(1500, seed=len(partition_by) * 10 + bucket_count)
    trees, listed = {}, {}
    for sink_cls, table, name in ((RefSink, ref, "ref"), (HiveDataSink, port, "port")):
        root = str(tmp_path / name)
        sink = sink_cls(root, partition_by=partition_by, bucket_by=bucket_by,
                        bucket_count=bucket_count)
        sink.append(table)
        sink.append(table)  # a second append continues the file sequence
        listed[name] = [os.path.relpath(p, root) for p in sink.finish()]
        trees[name] = _tree(root)
    assert listed["port"] == listed["ref"]
    assert sorted(trees["port"]) == sorted(trees["ref"]) == sorted(listed["ref"])
    for rel, data in trees["ref"].items():
        assert trees["port"][rel] == data, rel


def test_partitioned_write_with_nulls_keeps_rows(tmp_path):
    """With NULLs the port's files carry them (the JAX package's writer drops
    the validity, so the bytes differ): the same tree and file names, and a
    file's rows are the JAX package's with the NULLs kept."""
    ref, port = _pair(900, seed=4, nulls=True)
    RefSink(str(tmp_path / "ref"), partition_by=["k"]).append(ref)
    HiveDataSink(str(tmp_path / "port"), partition_by=["k"]).append(port)
    ref_tree, port_tree = _tree(str(tmp_path / "ref")), _tree(str(tmp_path / "port"))
    assert sorted(ref_tree) == sorted(port_tree)
    for rel in ref_tree:
        got = Table.load_parquet(str(tmp_path / "port" / rel))
        want = RefTable.load_parquet(str(tmp_path / "ref" / rel))
        np.testing.assert_array_equal(got.columns["id"], want.columns["id"])
        valid = port.validities["v"][got.columns["id"]]
        np.testing.assert_array_equal(got.validities["v"], valid)
        np.testing.assert_array_equal(got.columns["v"][valid], want.columns["v"][valid])


def test_source_reads_match_reference(tmp_path):
    """Discovery, partition and range pruning, the appended partition
    columns (VARCHAR, last) and the merged dictionaries: the JAX package's
    rows, codes included."""
    ref, port = _pair(1200, seed=9)
    root = str(tmp_path / "ds")
    write_table(root, port, partition_by=["s", "k"])
    assert [s.path for s in _discover(root)] == [s.path for s in ref_discover(root)]
    cases = [
        dict(),
        dict(columns=["id", "s", "v"]),
        dict(partition_filter=lambda keys: keys["k"] in ("9", "10")),
        dict(columns=["v", "k", "id"], range_filter={"id": (100, 300)}),
    ]
    for kwargs in cases:
        src, rsrc = HiveDataSource(**kwargs), RefSource(**kwargs)
        for split in _discover(root):
            src.add_split(split)
        for split in ref_discover(root):
            rsrc.add_split(split)
        got, want = src.to_table(), rsrc.to_table()
        assert list(got.schema.names) == list(want.schema.names)
        assert [str(t) for t in got.schema.types] == [str(t) for t in want.schema.types]
        for name in got.schema.names:
            np.testing.assert_array_equal(got.columns[name], want.columns[name], err_msg=name)
            if name in want.string_tables:
                assert got.string_tables[name].values() == want.string_tables[name].values()
    full = read_table(root)
    assert list(full.schema.names)[-2:] == ["s", "k"]  # partition keys come last
    assert str(full.schema.type_of("k")) == "VARCHAR"


def test_to_table_does_not_grow_the_cached_dictionary(tmp_path):
    """The first split's table can be the data cache's own entry: merging
    the splits' dictionaries copies it first (the JAX package interns the
    other splits' strings into it)."""
    from velox_tpu_torch.io.cache import DEFAULT_CACHE

    root = str(tmp_path / "dict")
    os.makedirs(root)
    for i, words in enumerate((["x", "y"], ["z", "y", "w"])):
        st = StringTable()
        codes = st.intern_all(words)
        Table(vtt.RowType(["s"], [vtt.VARCHAR]), {"s": codes}, {"s": st}).save_parquet(
            os.path.join(root, f"part-{i}.parquet")
        )
    src = HiveDataSource()
    for split in _discover(root):
        src.add_split(split)
    first = DEFAULT_CACHE.get_or_load(os.path.join(root, "part-0.parquet"))
    before = first.string_tables["s"].values()
    merged = src.to_table()
    assert first.string_tables["s"].values() == before
    assert merged.string_tables["s"].decode(merged.columns["s"]).tolist() == [
        "x", "y", "z", "y", "w",
    ]


# ---- tests/test_misc_components.py ------------------------------------------------


def test_stats_reporter_counts_queries():
    from velox_tpu_torch.utils import reporter

    before = reporter.reporter().counter(reporter.METRIC_QUERY_COUNT)
    t = Table(vtt.RowType(["x"], [vtt.BIGINT]), {"x": np.arange(10, dtype=np.int64)})
    run_plan(PlanBuilder().table_scan(t).filter("x > 3").build(), device=CPU)
    assert reporter.reporter().counter(reporter.METRIC_QUERY_COUNT) == before + 1
    assert reporter.reporter().counter(reporter.METRIC_ROWS_SCANNED) >= 10
    assert reporter.reporter().values[reporter.METRIC_QUERY_SECONDS][-1] > 0

    class Capture(reporter.BaseStatsReporter):
        pass

    prev = reporter.set_reporter(Capture())
    try:
        reporter.increment_counter("custom.metric", 5)
        assert reporter.reporter().counter("custom.metric") == 5
    finally:
        reporter.set_reporter(prev)


def test_data_cache_counts_hits_and_misses(tmp_path):
    from velox_tpu_torch.io.cache import DataCache
    from velox_tpu_torch.utils import reporter

    path = str(tmp_path / "t.parquet")
    sample_table(100).save_parquet(path)
    cache = DataCache(max_bytes=1 << 20)
    misses = reporter.reporter().counter(reporter.METRIC_CACHE_MISSES)
    a = cache.get_or_load(path)
    b = cache.get_or_load(path)
    assert a is b and cache.hits == 1 and cache.misses == 1
    assert reporter.reporter().counter(reporter.METRIC_CACHE_MISSES) == misses + 1
    assert cache.cached_bytes > 0 and cache.pool.reserved == cache.cached_bytes
    cache.prefetch(path, ["id"])
    assert cache.get_or_load(path, ["id"]).num_rows == 100  # joins the in-flight load
    assert cache.hits == 2
    assert cache.evict_bytes(1) > 0
    cache.clear()
    assert cache.cached_bytes == 0 and cache.pool.reserved == 0


def test_arrow_stream_source():
    batches = [
        pa.record_batch({"k": pa.array([1, 2], pa.int64()), "s": pa.array(["a", "b"])}),
        pa.record_batch({"k": pa.array([3], pa.int64()), "s": pa.array(["a"])}),
    ]
    out = run_plan(
        PlanBuilder().arrow_stream(iter(batches)).filter("k >= 2").project(["k", "s"]).build(),
        device=CPU,
    ).to_pandas()
    assert out["k"].tolist() == [2, 3]
    assert out["s"].tolist() == ["b", "a"]


def test_arrow_stream_literal_binds_to_its_dictionary():
    """A string literal binds against the stream's dictionary, and the
    executor scans the stream as a source (no barrier)."""
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.plan import ArrowStreamNode

    reader = pa.RecordBatchReader.from_batches(
        pa.schema([("k", pa.int64()), ("s", pa.string())]),
        [pa.record_batch({"k": pa.array(range(6), pa.int64()),
                          "s": pa.array(["a", "b", "c"] * 2)})],
    )
    plan = PlanBuilder().arrow_stream(reader).filter("s = 'b'").aggregation([], ["sum(k) as t"])
    ex = LocalExecutor(plan.build(), device=CPU)
    assert isinstance(ex.lin.source, ArrowStreamNode)
    assert ex.run().columns["t"].tolist() == [1 + 4]


def test_table_write_merge(tmp_path):
    from velox_tpu_torch.plan import TableWriteMergeNode, TableWriteNode

    t = Table(vtt.RowType(["x"], [vtt.BIGINT]), {"x": np.arange(7, dtype=np.int64)})
    root = str(tmp_path / "out")
    node = TableWriteNode(PlanBuilder().table_scan(t).build(),
                          sink_factory=lambda: HiveDataSink(root))
    assert run_plan(TableWriteMergeNode(node), device=CPU).to_pandas()["rows"].tolist() == [7]
    assert read_table(root).num_rows == 7


class TestQueryConfigProperties:
    """String-keyed session property bridge (reference: core/Config.h:29)."""

    def test_from_properties(self):
        from velox_tpu_torch.config import QueryConfig

        cfg = QueryConfig.from_properties(
            {"device_agg_merge": "false", "kll_points": "128",
             "query_memory_limit_bytes": "1000000", "percentile_sketch": "ddsketch"}
        )
        assert cfg.device_agg_merge is False
        assert cfg.kll_points == 128
        assert cfg.query_memory_limit_bytes == 1_000_000
        assert cfg.percentile_sketch == "ddsketch"
        assert QueryConfig.from_properties({"query_memory_limit_bytes": ""}).query_memory_limit_bytes is None
        with pytest.raises(ValueError, match="bad boolean"):
            QueryConfig.from_properties({"device-agg-merge": "maybe"})

    def test_unknown_property_raises(self):
        from velox_tpu_torch.config import QueryConfig

        with pytest.raises(KeyError, match="unknown session property"):
            QueryConfig.from_properties({"no_such_knob": "1"})
        with pytest.raises(KeyError, match="unknown session property"):
            QueryConfig.from_properties({"_connector_configs": "1"})

    def test_roundtrip_and_connector_tier(self):
        from velox_tpu.config import DEFAULT_CONFIG as REF_DEFAULT
        from velox_tpu_torch.config import DEFAULT_CONFIG, QueryConfig

        props = DEFAULT_CONFIG.to_properties()
        cfg = QueryConfig.from_properties(props)
        assert cfg == DEFAULT_CONFIG
        # the port's fields are the JAX package's, rendered the same way
        ref_props = REF_DEFAULT.to_properties()
        assert {k: ref_props[k] for k in props} == props
        hive = cfg.connector("hive")
        assert hive.split_preload_threads == REF_DEFAULT.connector("hive").split_preload_threads
        assert cfg.connector("hive") is hive
        with pytest.raises(KeyError):
            cfg.connector("iceberg")


# ---- the TPC-H parquet cache ---------------------------------------------------------


def test_tpch_parquet_cache(tmp_path):
    from velox_tpu_torch.connectors import tpch
    from velox_tpu_torch.io.cache import DEFAULT_CACHE

    cache_dir = str(tmp_path / "tpch")
    cols = ["l_orderkey", "l_returnflag", "l_shipdate", "l_extendedprice"]
    generated = tpch.load_table("lineitem", 0.001, cols, cache_dir=None)
    first = tpch.load_table("lineitem", 0.001, cols, cache_dir=cache_dir)
    [name] = os.listdir(cache_dir)  # written under a temporary name, then renamed
    assert name.startswith("lineitem_sf0.001_") and name.endswith(".parquet")
    hits = DEFAULT_CACHE.hits
    second = tpch.load_table("lineitem", 0.001, cols, cache_dir=cache_dir)
    third = tpch.load_table("lineitem", 0.001, cols, cache_dir=cache_dir)
    assert third is second and DEFAULT_CACHE.hits == hits + 1  # host-RAM cache
    for t in (first, second):
        assert list(t.schema.names) == cols
        for c in cols:
            g, w = np.asarray(t.columns[c]), np.asarray(generated.columns[c])
            assert g.dtype == w.dtype
            if c in generated.string_tables:
                g = t.string_tables[c].decode(g)
                w = generated.string_tables[c].decode(w)
            np.testing.assert_array_equal(g, w)
    # a file that does not read is written again
    with open(os.path.join(cache_dir, name), "wb") as f:
        f.write(b"not parquet")
    DEFAULT_CACHE.clear()
    again = tpch.load_table("lineitem", 0.001, cols, cache_dir=cache_dir)
    assert again.num_rows == generated.num_rows
    assert pq.ParquetFile(os.path.join(cache_dir, name)).metadata.num_rows == generated.num_rows
    assert os.listdir(cache_dir) == [name]


def test_tpch_cache_is_keyed_by_the_generator(tmp_path, monkeypatch):
    """The cache file's name holds a hash of the generator's source: another
    hash (an edited ``gen.py``) misses the old file and generates again."""
    from velox_tpu_torch.connectors import tpch

    cache_dir = str(tmp_path / "tpch")
    cols = ["l_orderkey", "l_quantity"]
    calls = []

    def counting(*args):
        calls.append(args)
        return tpch.gen.generate_table(*args)

    monkeypatch.setattr(tpch, "generate_table", counting)
    tpch.load_table("lineitem", 0.001, cols, cache_dir=cache_dir)
    tpch.load_table("lineitem", 0.001, cols, cache_dir=cache_dir)
    [old] = os.listdir(cache_dir)
    assert len(calls) == 1
    monkeypatch.setattr(tpch, "_generator_digest", lambda: "edited-generator")
    tpch.load_table("lineitem", 0.001, cols, cache_dir=cache_dir)
    assert len(calls) == 2
    [new] = set(os.listdir(cache_dir)) - {old}
    assert new.startswith("lineitem_sf0.001_") and new != old


def test_tpch_cached_query_rows(tmp_path):
    """Q1 over tables read back from the cache gives the rows of Q1 over
    generated tables."""
    from velox_tpu_torch.connectors import tpch
    from velox_tpu_torch.connectors.tpch.plans import build_query
    from velox_tpu_torch.connectors.tpch.queries import QUERY_COLUMNS

    want = None
    for cache_dir in (None, str(tmp_path / "c"), str(tmp_path / "c")):
        tables = {t: tpch.load_table(t, 0.002, c, cache_dir=cache_dir)
                  for t, c in QUERY_COLUMNS[1].items()}
        got = run_plan(build_query(1, tables, device=CPU), tile_rows=4096, device=CPU).to_pandas()
        if want is None:
            want = got
        pd.testing.assert_frame_equal(got, want)


def test_chip_smoke_files_io_lines_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s files_io phase (I1-I7) at SF 0.01 in tiles of 2^12
    rows on the CPU: every line ``correct``, and the paths it asserts."""
    import chip_smoke as cs
    from velox_tpu_torch.ops.group_piece import grouped_piece_sums
    from velox_tpu_torch.ops.group_sum import grouped_int64_sums
    from velox_tpu_torch.ops.selective_sum import selective_sum

    wrappers = {"selective_sum": selective_sum, "grouped_piece_sums": grouped_piece_sums,
                "grouped_int64_sums": grouped_int64_sums}
    workdir = str(tmp_path / "files_io")
    lines = cs.run_files_io(cs.TpchTables(0.01), 1 << 12, 1, CPU, workdir, wrappers,
                            fuzz_rows=1 << 12, row_count=2000)
    assert [f["line"] for f in lines] == [f"I{i}" for i in range(1, 8)]
    for f in lines:
        assert f["correct"], f
    i1, i2, i3, i4 = lines[:4]
    assert i1["files"] == 7 and sum(i1["rows_per_file"].values()) == i1["rows"]
    assert i2["piece_path"] and i2["tiles"] > 1
    assert i2["warm"]["hits"] == 7 and i2["cold"]["files_decoded"] == 7
    assert i3["splits_read"] == 1
    assert 0 < i4["groups_read"] < i4["row_groups"] or i4["row_groups"] == 1
    assert not os.path.exists(workdir)
