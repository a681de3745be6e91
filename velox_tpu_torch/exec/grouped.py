"""Row-concatenation of host Tables.

Counterpart of the part of the JAX package's ``exec/grouped.py`` that UNION
ALL, MergeExchange and the chunked window need: ``concat_tables``.  The rest
of that module (Hive ``split_groups`` and ``GroupedExecution``, the grouped
execution of split groups with checkpoints) comes with the memory, spill and
grouped-execution slice.  Complex-typed (ARRAY / MAP) columns raise by name:
their host form (``HostSegments``) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..io.table import Table
from ..vector.string_table import StringTable


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
            raise NotImplementedError(
                "concat_tables of complex-typed columns (HostSegments) is not ported yet"
            )
        if dtype.is_string and any(name in t.string_tables for t in tables):
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
