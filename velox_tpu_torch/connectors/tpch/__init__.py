"""TPC-H connector: tables generated on the fly.

Counterpart of the JAX package's ``connectors/tpch``.  Reference:
velox/connectors/tpch/TpchConnector.h:24 (a Connector whose DataSource
generates TPC-H rows on demand).  The parquet cache in front of the generator
is not ported yet: every load generates.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ...io.table import Table
from .gen import SCHEMAS, TABLE_NAMES, generate_table


def load_table(
    name: str, sf: float = 1.0, columns: Optional[Sequence[str]] = None
) -> Table:
    """Generate a TPC-H table, column-pruned."""
    return generate_table(name, sf, list(columns) if columns is not None else None)


__all__ = ["SCHEMAS", "TABLE_NAMES", "generate_table", "load_table"]
