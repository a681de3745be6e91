"""Hive-style connector: directory datasets of parquet files.

Counterpart of the JAX package's ``connectors/hive``.  Reference:
velox/connectors/hive/ — HiveConnector (:29), HiveConnectorSplit (file + byte
range + partition keys), HiveDataSource (builds a ScanSpec from pushed
filters, HiveDataSource.h:76), HiveDataSink (partitioned/bucketed writes,
HiveDataSink.h:398), partition-name codecs (dwio/catalog/fbhive).

Supported here: datasets laid out as ``root/col=value/.../part-*.parquet``
(Hive partition directories, any depth), column pruning, partition-key
pruning from a pushed predicate (the reference's partition filter), parallel
file reads on a thread pool (the reference's split preloading,
velox/exec/TableScan.cpp:245), and partitioned and bucketed writes.

A partitioned write splits the rows with numpy (``_partition_rows``: one
``np.unique`` a key column and one stable sort), where the JAX package builds
a Python tuple a row; the directories, file names and rows a file are the
same.  Every partition (or bucket) of one ``append`` goes into one file: the
JAX package's ``rows_per_file`` is stored and never read, so the port has no
such knob.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ...dtypes import RowType, VARCHAR
from ...io.table import Table
from ...parallel.shuffle_join import hash64_np
from ...vector.string_table import StringTable
from ..base import Connector, ConnectorSplit, DataSink, DataSource, register_connector

_PART_RE = re.compile(r"^([A-Za-z_][A-Za-z_0-9]*)=(.*)$")


def _discover(root: str) -> List[ConnectorSplit]:
    """Walk a dataset directory into splits with partition keys.

    The walk goes through the filesystem registry (io/filesystems.py), so
    datasets on any registered scheme (memory://, future remote adapters)
    discover identically — reference: FileSystems.h + HiveConnectorUtil."""
    from ...io.filesystems import filesystem_for

    fs, local_root = filesystem_for(root)
    splits: List[ConnectorSplit] = []
    for dirpath, filenames in fs.walk(local_root):
        rel = os.path.relpath(dirpath, local_root)
        keys: Dict[str, str] = {}
        if rel != ".":
            for comp in rel.split(os.sep):
                m = _PART_RE.match(comp)
                if m:
                    keys[m.group(1)] = m.group(2)
        for fn in sorted(filenames):
            if fn.endswith((".parquet", ".orc")):
                splits.append(
                    ConnectorSplit(
                        dirpath + "/" + fn
                        if "://" in root
                        else os.path.join(dirpath, fn),
                        partition_keys=keys,
                    )
                )
    return splits


class HiveDataSource(DataSource):
    def __init__(
        self,
        columns: Optional[Sequence[str]] = None,
        partition_filter: Optional[Callable[[Dict[str, str]], bool]] = None,
        max_workers: Optional[int] = None,
        range_filter: Optional[Dict[str, tuple]] = None,
    ):
        self.columns = list(columns) if columns else None
        self.partition_filter = partition_filter
        # column -> (lo, hi) pushed predicate bounds: row groups whose file
        # statistics prove no overlap are never decoded (the reference's
        # ScanSpec/selective-reader stats pruning); the row-exact filter
        # still runs on device
        self.range_filter = dict(range_filter) if range_filter else None
        if max_workers is None:
            # connector config tier (reference: HiveConfig split preloading)
            from ...config import DEFAULT_CONFIG

            max_workers = DEFAULT_CONFIG.connector("hive").split_preload_threads
        self.max_workers = max_workers
        self.splits: List[ConnectorSplit] = []

    def add_split(self, split: ConnectorSplit) -> None:
        if self.partition_filter and not self.partition_filter(
            split.partition_keys
        ):
            return  # partition pruned (reference: partition filter pushdown)
        self.splits.append(split)
        if not split.path.endswith(".orc"):
            # async prefetch into the data cache as splits are DISCOVERED,
            # so decode overlaps discovery and chunks() hits warm entries
            # (reference: TableScan preload + CachedBufferedInput prefetch,
            # velox/exec/TableScan.cpp:245)
            from ...io.cache import DEFAULT_CACHE

            part_names = list(split.partition_keys)
            file_cols = None
            if self.columns is not None:
                file_cols = [c for c in self.columns if c not in part_names]
            if self.range_filter is None:
                # predicate-pruned reads skip the whole-file cache
                DEFAULT_CACHE.prefetch(split.path, file_cols)

    def _read_one(self, split: ConnectorSplit) -> Table:
        part_names = list(split.partition_keys)
        file_cols = None
        if self.columns is not None:
            file_cols = [c for c in self.columns if c not in part_names]
        if split.path.endswith(".orc"):
            t = Table.load_orc(split.path, columns=file_cols)
        else:
            from ...io.cache import cached_load_parquet

            t = cached_load_parquet(
                split.path, columns=file_cols, ranges=self.range_filter
            )
        # attach partition-key columns as constants (reference: HiveDataSource
        # synthesizes partition columns)
        want = self.columns or (list(t.schema.names) + part_names)
        names, types, cols, tables = [], [], {}, dict(t.string_tables)
        for name in want:
            if name in split.partition_keys:
                st = StringTable()
                code = st.intern(split.partition_keys[name])
                names.append(name)
                types.append(VARCHAR)
                cols[name] = np.full(t.num_rows, code, dtype=np.int32)
                tables[name] = st
            else:
                names.append(name)
                types.append(t.schema.type_of(name))
                cols[name] = t.columns[name]
        return Table(RowType(names, types), cols, tables, dict(t.validities))

    def chunks(self) -> Iterator[Table]:
        if not self.splits:
            return
        # parallel reads: the reference preloads splits on an I/O executor
        with concurrent.futures.ThreadPoolExecutor(self.max_workers) as pool:
            yield from pool.map(self._read_one, self.splits)


def _partition_rows(table: Table, cols: Sequence[str]):
    """[(value texts, row indices in input order)] of every combination of
    the partition columns present in ``table``, sorted as tuples of the texts
    (the JAX package's ``sorted(set(combo))``): one ``np.unique`` a column
    and one stable ``np.lexsort``.  A value's text is what the directory name
    spells: a string column's decoded value, any other column's
    ``astype(str)``."""
    if not table.num_rows:
        return []
    texts, ranks = [], []
    for col in cols:
        arr = np.asarray(table.columns[col])
        raw = arr
        if arr.dtype.kind == "f":  # by their bits: -0.0 and 0.0 have two texts
            raw = arr.view(np.int32 if arr.itemsize == 4 else np.int64)
        distinct, inv = np.unique(raw, return_inverse=True)
        distinct = distinct.view(arr.dtype)
        if col in table.string_tables:
            txt = table.string_tables[col].decode(distinct).astype(str)
        else:
            txt = distinct.astype(str)
        # distinct values may share a text (NaN payloads): rank by text
        uniq, text_of = np.unique(txt, return_inverse=True)
        texts.append(uniq)
        ranks.append(text_of[inv.reshape(-1)])
    order = np.lexsort(ranks[::-1])  # stable: a group's rows stay in input order
    keys = np.stack([r[order] for r in ranks])
    starts = np.flatnonzero(np.r_[True, (keys[:, 1:] != keys[:, :-1]).any(axis=0)])
    return [
        (tuple(str(t[k[s]]) for t, k in zip(texts, keys)), rows)
        for s, rows in zip(starts, np.split(order, starts[1:]))
    ]


class HiveDataSink(DataSink):
    def __init__(
        self,
        root: str,
        partition_by: Sequence[str] = (),
        bucket_by: Sequence[str] = (),
        bucket_count: int = 0,
    ):
        self.root = root
        self.partition_by = list(partition_by)
        self.bucket_by = list(bucket_by)
        self.bucket_count = bucket_count
        self._written: List[str] = []
        self._seq = 0

    def _bucket_split(self, table: Table):
        """Rows -> (bucket id, sub-table) by key hash (reference:
        HiveDataSink bucketed writes + HivePartitionFunction)."""
        # the exchange's 64-bit mix (``parallel/exchange.py hash64``), as the
        # JAX package's writer: every row lands in the same bucket file
        keys = np.zeros(table.num_rows, np.uint64)
        for col in self.bucket_by:
            keys ^= hash64_np(np.asarray(table.columns[col], np.int64))
        buckets = (keys % np.uint64(self.bucket_count)).astype(np.int64)
        for b in range(self.bucket_count):
            mask = buckets == b
            if not mask.any():
                continue
            yield b, Table(
                table.schema,
                {n: v[mask] for n, v in table.columns.items()},
                table.string_tables,
                {n: v[mask] for n, v in table.validities.items()},
            )

    def append(self, table: Table) -> None:
        if not self.partition_by:
            self._append_to_dir(self.root, table)
            return
        # split rows by partition values; one directory per combination, in
        # the order of the values' text
        sub_names = [n for n in table.schema.names if n not in self.partition_by]
        sub_schema = RowType(sub_names, [table.schema.type_of(n) for n in sub_names])
        for values, rows in _partition_rows(table, self.partition_by):
            sub = Table(
                sub_schema,
                {n: table.columns[n][rows] for n in sub_names},
                {n: t for n, t in table.string_tables.items() if n in sub_names},
                {n: v[rows] for n, v in table.validities.items() if n in sub_names},
            )
            d = os.path.join(
                self.root,
                *[f"{c}={v}" for c, v in zip(self.partition_by, values)],
            )
            self._append_to_dir(d, sub)

    def _append_to_dir(self, directory: str, table: Table) -> None:
        if self.bucket_by and self.bucket_count:
            for b, sub in self._bucket_split(table):
                self._write_file(directory, sub, bucket=b)
        else:
            self._write_file(directory, table)

    def _write_file(
        self, directory: str, table: Table, bucket: Optional[int] = None
    ) -> None:
        if "://" not in directory:
            os.makedirs(directory, exist_ok=True)
        if bucket is None:
            fname = f"part-{self._seq:05d}.parquet"
        else:
            # Hive bucket-file naming convention: fixed bucket prefix
            fname = f"{bucket:05d}_0_part-{self._seq:05d}.parquet"
        path = os.path.join(directory, fname)
        self._seq += 1
        table.save_parquet(path)
        self._written.append(path)

    def finish(self) -> List[str]:
        return list(self._written)


class HiveConnector(Connector):
    name = "hive"

    def create_data_source(self, **kwargs) -> HiveDataSource:
        return HiveDataSource(**kwargs)

    def create_data_sink(self, **kwargs) -> HiveDataSink:
        return HiveDataSink(**kwargs)


register_connector(HiveConnector())


def read_table(
    root: str,
    columns: Optional[Sequence[str]] = None,
    partition_filter: Optional[Callable[[Dict[str, str]], bool]] = None,
) -> Table:
    """Convenience: discover + read a dataset directory into one host Table."""
    src = HiveDataSource(columns=columns, partition_filter=partition_filter)
    for split in _discover(root):
        src.add_split(split)
    return src.to_table()


def write_table(
    root: str, table: Table, partition_by: Sequence[str] = ()
) -> List[str]:
    """Convenience: write one host Table as a (optionally partitioned) dataset."""
    sink = HiveDataSink(root, partition_by)
    sink.append(table)
    return sink.finish()
