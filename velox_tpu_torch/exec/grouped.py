"""Grouped (bucketed) execution: split groups as independent execution units,
and the row concatenation of host Tables.

Counterpart of the JAX package's ``exec/grouped.py``.  Reference:
velox/exec/Task.cpp:839-1015 (createSplitGroupStateLocked, per-group driver
cohorts, ``concurrentSplitGroups``) + PlanFragment grouped execution — the
unit of elastic / partial restart in Presto-on-Velox.

A split group is a self-contained slice of a partitioned dataset (Hive
partition directories).  Each group runs the same plan as its own query;
results checkpoint to parquet so a failed or preempted run resumes from the
finished groups (the reference's restart unit); ``concurrent_groups`` bounds
how many groups are in flight, like the reference's concurrentSplitGroups
throttle.  Valid for plans whose groups are independent — the bucketing
contract grouped execution has in the reference (group-by / join keys
aligned with the partitioning).  ``concat_tables`` also serves UNION ALL,
MergeExchange, the chunked window and the spill paths; complex-typed (ARRAY
/ MAP / ROW) columns concatenate through their host form
(``vector/complex.py``).
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.table import Table
from ..plan.nodes import PlanNode
from ..utils.testvalue import adjust
from ..vector.string_table import StringTable


def split_groups(
    root: str, columns: Optional[Sequence[str]] = None
) -> List[Tuple[str, Table]]:
    """One (group_key, Table) per first-level Hive partition directory."""
    from ..connectors.hive import HiveDataSource, _discover

    by_group: Dict[str, List] = {}
    for split in _discover(root):
        if split.partition_keys:
            key = "/".join(f"{k}={v}" for k, v in sorted(split.partition_keys.items()))
        else:
            key = "all"
        by_group.setdefault(key, []).append(split)
    out = []
    for key in sorted(by_group):
        src = HiveDataSource(columns=columns)
        for s in by_group[key]:
            src.add_split(s)
        out.append((key, src.to_table()))
    return out


def concat_tables(tables: Sequence[Table]) -> Table:
    """Row-concatenate Tables, remapping string dictionaries into one.

    Each string column gets one merged dictionary: the first table's values
    keep their codes, later tables' values are interned after them and their
    codes remapped.  Validity is kept; a table without a validity array for a
    column is all-valid there."""
    tables = [t for t in tables if t.num_rows or len(tables) == 1]
    if not tables:
        raise ValueError("concat_tables: no input")
    first = tables[0]
    cols: Dict[str, np.ndarray] = {}
    out_tables: Dict[str, StringTable] = {}
    validities: Dict[str, np.ndarray] = {}
    for name, dtype in zip(first.schema.names, first.schema.types):
        if dtype.is_complex:
            parts = [t.columns[name] for t in tables]
            cols[name] = type(parts[0]).concat(parts)
        elif dtype.is_string and any(name in t.string_tables for t in tables):
            combined = StringTable()
            parts = []
            for t in tables:
                st = t.string_tables.get(name)
                codes = np.asarray(t.columns[name], np.int64)
                values = st.values() if st is not None else [""]
                remap = np.asarray([combined.intern(v) for v in values], np.int32)
                parts.append(remap[np.clip(codes, 0, len(remap) - 1)])
            cols[name] = np.concatenate(parts)
            out_tables[name] = combined
        else:
            cols[name] = np.concatenate([np.asarray(t.columns[name]) for t in tables])
        vs = [t.validities.get(name) for t in tables]
        if any(v is not None for v in vs):
            validities[name] = np.concatenate(
                [
                    v if v is not None else np.ones(t.num_rows, bool)
                    for v, t in zip(vs, tables)
                ]
            )
    return Table(first.schema, cols, out_tables, validities)


class GroupedExecution:
    """Run one plan shape over independent split groups with bounded
    concurrency and per-group checkpoint / restart.  ``device`` None = the
    CUDA device; the groups in flight share it (each thread issues its own
    group's work)."""

    def __init__(
        self,
        make_plan: Callable[[Table], PlanNode],
        groups: Sequence[Tuple[str, Table]],
        concurrent_groups: int = 2,
        checkpoint_dir: Optional[str] = None,
        tile_rows: int = 1 << 20,
        device=None,
    ):
        from ..device import resolve_device

        self.make_plan = make_plan
        self.groups = list(groups)
        self.concurrent_groups = max(1, concurrent_groups)
        self.checkpoint_dir = checkpoint_dir
        self.tile_rows = tile_rows
        self.device = resolve_device(device)
        self.groups_run = 0  # groups actually executed (not restored)
        self._lock = threading.Lock()

    def _ckpt_path(self, key: str) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        safe = key.replace(os.sep, "_").replace("=", "-")
        return os.path.join(self.checkpoint_dir, f"group-{safe}.parquet")

    def _run_group(self, key: str, table: Table) -> Table:
        from .runner import run_plan

        path = self._ckpt_path(key)
        if path and os.path.exists(path):
            return Table.load_parquet(path)  # restart: group already done
        adjust("GroupedExecution::runGroup", key)
        result = run_plan(self.make_plan(table), tile_rows=self.tile_rows, device=self.device)
        with self._lock:
            self.groups_run += 1
        if path:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            tmp = path + ".tmp"
            result.save_parquet(tmp)
            os.replace(tmp, path)  # atomic publish, like SsdCache checkpoints
        return result

    def run(self) -> Table:
        results: List[Optional[Table]] = [None] * len(self.groups)
        with concurrent.futures.ThreadPoolExecutor(self.concurrent_groups) as pool:
            futures = {
                pool.submit(self._run_group, key, t): i
                for i, (key, t) in enumerate(self.groups)
            }
            for fut in concurrent.futures.as_completed(futures):
                results[futures[fut]] = fut.result()
        return concat_tables([r for r in results if r is not None])
