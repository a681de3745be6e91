"""Connector API: the engine's pluggable storage boundary.

Counterpart of the JAX package's ``connectors/base.py``.  Reference:
velox/connectors/Connector.h — Connector (:324) creating DataSource (:163,
scan side) and DataSink (:136, write side) instances, ConnectorSplit (:58) as
the unit of scan work, and a process-wide registry (:393,419).

The engine keeps the same seams with a host-side simplification: a
DataSource yields host ``Table`` chunks (the device only ever sees tiles the
executor slices), and a DataSink consumes host ``Table`` chunks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

from ..io.table import Table
from ..vector.string_table import StringTable


@dataclasses.dataclass
class ConnectorSplit:
    """One unit of scan work (reference: ConnectorSplit / HiveConnectorSplit:
    file path + byte range + partition keys)."""

    path: str
    start: int = 0
    length: Optional[int] = None
    partition_keys: Dict[str, str] = dataclasses.field(default_factory=dict)


class DataSource:
    """Scan-side contract (reference: DataSource::addSplit + next)."""

    def add_split(self, split: ConnectorSplit) -> None:
        raise NotImplementedError

    def chunks(self) -> Iterator[Table]:
        """Yield host Table chunks for all added splits."""
        raise NotImplementedError

    def to_table(self) -> Table:
        """Materialize every chunk into one host Table."""
        import numpy as np

        parts = list(self.chunks())
        if not parts:
            raise ValueError("no splits added")
        first = parts[0]
        if len(parts) == 1:
            return first
        cols = {
            n: np.concatenate([p.columns[n] for p in parts])
            for n in first.schema.names
        }
        # dictionaries may differ per file: re-encode through a copy of the
        # first table's (the first part may be a data-cache entry, which must
        # not grow; the JAX package interns into the first part's own table)
        validities = {}
        tables = dict(first.string_tables)
        for n, t in zip(first.schema.names, first.schema.types):
            if t.is_string:
                merged = StringTable.from_values(tables[n].values())
                tables[n] = merged
                offset_parts = []
                for p in parts:
                    codes = p.columns[n]
                    remap = merged.intern_all(p.string_tables[n].values())
                    offset_parts.append(remap[codes])
                cols[n] = np.concatenate(offset_parts)
            if any(n in p.validities for p in parts):
                validities[n] = np.concatenate(
                    [
                        p.validities.get(
                            n, np.ones(p.num_rows, dtype=bool)
                        )
                        for p in parts
                    ]
                )
        return Table(first.schema, cols, tables, validities)


class DataSink:
    """Write-side contract (reference: DataSink::appendData + finish)."""

    def append(self, table: Table) -> None:
        raise NotImplementedError

    def finish(self) -> List[str]:
        """Flush and return the written file paths."""
        raise NotImplementedError


class Connector:
    """Factory for sources/sinks (reference: connector::Connector)."""

    name: str = "base"

    def create_data_source(self, **kwargs) -> DataSource:
        raise NotImplementedError

    def create_data_sink(self, **kwargs) -> DataSink:
        raise NotImplementedError


_REGISTRY: Dict[str, Connector] = {}


def register_connector(connector: Connector) -> None:
    _REGISTRY[connector.name] = connector


def get_connector(name: str) -> Connector:
    return _REGISTRY[name]
