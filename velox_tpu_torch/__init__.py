"""velox_tpu_torch — the PyTorch/CUDA port of the vectorized query-execution engine.

The JAX package ``velox_tpu`` beside it is the reference; this package has the
same sub-package and module names so a reader finds the counterpart, imports
``torch`` and never ``jax``, and runs on an NVIDIA GPU: plain tensor code is
eager PyTorch and the grouped / selective sum kernels are hand-written CUDA
C++ (``csrc/``, built at first use by ``ops/cuda_build.py``).

Layering:

  dtypes         logical types -> fixed-width device representations
  vector         fixed-capacity columnar batches (flat/dict/const + validity + masks)
  expr           typed expression IR evaluated as eager torch ops
  functions      Presto- and Spark-semantic scalar function packages
  plan           plan nodes + PlanBuilder (fully-specified physical plans, no SQL)
  exec           plan -> pipeline -> per-tile programs; aggregation executors
  ops            masked / grouped reductions and the CUDA kernels' wrappers
  io / connectors  host-side tables, TPC-H generator
  testing        tables from plain host data, plan-result assertions

Every entry point that places data or runs a plan takes ``device=None``, which
means the CUDA device and raises when there is none; pass ``device="cpu"`` to
run on the host.
"""

from . import dtypes
from .dtypes import (  # noqa: F401
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    REAL,
    SMALLINT,
    TIMESTAMP,
    TINYINT,
    UNKNOWN,
    VARBINARY,
    VARCHAR,
    DataType,
    RowType,
    TypeKind,
    decimal,
)
from .vector import Batch, Column, Encoding, StringTable  # noqa: F401
from .functions import presto as _presto_functions  # noqa: F401  (registers fns)
from .functions import spark as _spark_functions  # noqa: E402,F401  (registers fns)


def run_sql(sql, catalog, tile_rows=None, device=None):
    """Plan and execute a SQL SELECT over host Tables (sql/planner.py);
    ``device`` None = the CUDA device."""
    from .sql.planner import run_sql as _run

    return _run(sql, catalog, tile_rows, device=device)


def run_plan(plan, tile_rows=1 << 20, device=None):
    """Execute a PlanNode (exec/runner.py); ``device`` None = the CUDA device."""
    from .exec.runner import run_plan as _run

    return _run(plan, tile_rows, device=device)


__version__ = "0.1.0"
