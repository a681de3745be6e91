"""TPC-H connector: on-the-fly generated, parquet-cached tables.

Counterpart of the JAX package's ``connectors/tpch``.  Reference:
velox/connectors/tpch/TpchConnector.h:24 (a Connector whose DataSource
generates TPC-H rows on demand, backed by dbgen).  A parquet cache sits in
front of the generator: the first load of a (table, scale factor, columns)
writes the generated table to a file, later loads read it back through the
host data cache (io/cache.py).  The file is written under a temporary name
and renamed into place, so a concurrent reader never sees half of it.  Its
name holds a hash of the generator's source (``gen.py``), so an edited
generator writes new files instead of serving the old tables.
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
from typing import Optional, Sequence

from ...io.cache import cached_load_parquet
from ...io.table import Table
from . import gen
from .gen import SCHEMAS, TABLE_NAMES, generate_table


def _default_cache_dir() -> str:
    from ...ops.cuda_build import build_dir

    return os.path.join(build_dir(), "tpch", "parquet")


# ``tpch/parquet`` in the build directory (``ops/cuda_build.build_dir``:
# ``build/`` beside the package, or ``$VELOX_TORCH_BUILD_DIR``)
DEFAULT_CACHE_DIR = _default_cache_dir()


@functools.lru_cache(maxsize=None)
def _generator_digest() -> str:
    """Hash of the generator's source, part of every cache file's name."""
    with open(gen.__file__, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()[:16]


def load_table(
    name: str,
    sf: float = 1.0,
    columns: Optional[Sequence[str]] = None,
    cache_dir: Optional[str] = DEFAULT_CACHE_DIR,
) -> Table:
    """Generate (or load from the parquet cache) a TPC-H table, column-pruned.
    ``cache_dir`` None generates without a cache.  A cache file that does not
    read is written again; a cache that cannot be written is skipped."""
    if columns is not None:
        columns = list(columns)
    if cache_dir is None:
        return generate_table(name, sf, columns)
    os.makedirs(cache_dir, exist_ok=True)
    col_key = ",".join(columns) if columns else "*"
    key = f"{_generator_digest()}|{col_key}"
    digest = hashlib.sha1(key.encode()).hexdigest()[:10]
    path = os.path.join(cache_dir, f"{name}_sf{sf:g}_{digest}.parquet")
    if os.path.exists(path):
        try:
            # host-RAM cache fronting the parquet file (io/cache.py)
            return cached_load_parquet(path, columns)
        except (OSError, ValueError):  # pyarrow's ArrowInvalid is a ValueError
            _unlink(path)
    table = generate_table(name, sf, columns)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        table.save_parquet(tmp)
        os.replace(tmp, path)
    except (OSError, ValueError):
        _unlink(tmp)
    return table


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


__all__ = ["DEFAULT_CACHE_DIR", "SCHEMAS", "TABLE_NAMES", "generate_table", "load_table"]
