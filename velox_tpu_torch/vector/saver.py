"""Batch/table persistence for debugging and fuzzer repro.

Counterpart of the JAX package's ``vector/saver.py``.  Reference:
velox/vector/VectorSaver.h + docs/develop/debugging/vector-saver.rst — persist
the exact input of a failing operation to disk so it can be replayed offline;
the expression fuzzer's --repro_persist_path uses it.

The payload is the page serde (encoding-exact for this engine: batches are
decoded to flat columns + validity + dictionary, all of which pages carry).
``save_batch`` snapshots a Batch's live rows to one file; ``load_batch``
reconstitutes it on a device with identical values, validity and
dictionaries.
"""

from __future__ import annotations

import os
from typing import Optional


from ..io.table import Table
from ..serde.page import deserialize_page, serialize_page
from .column import Batch


def batch_to_table(batch: Batch) -> Table:
    """Materialize a Batch's live rows to a host Table."""
    mask = batch.active_mask().cpu().numpy()
    cols, tables, validities = {}, {}, {}
    for name, col in zip(batch.schema.names, batch.columns):
        values, validity = col.decode(batch.capacity)
        cols[name] = values.cpu().numpy()[mask]
        if validity is not None:
            validities[name] = validity.cpu().numpy()[mask]
        if col.strings is not None:
            tables[name] = col.strings
    return Table(batch.schema, cols, tables, validities)


def save_batch(batch: Batch, path: str) -> str:
    """Persist a batch's live rows; returns the path (dirs created)."""
    return save_table(batch_to_table(batch), path)


def save_table(table: Table, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(serialize_page(table))
    return path


def load_table(path: str) -> Table:
    with open(path, "rb") as f:
        return deserialize_page(f.read())


def load_batch(path: str, capacity: Optional[int] = None, device=None) -> Batch:
    """The saved rows as one Batch of ``capacity`` rows (default: the row
    count) on ``device`` (None = the CUDA device)."""
    table = load_table(path)
    return table.tile(0, capacity or max(table.num_rows, 1), device)
