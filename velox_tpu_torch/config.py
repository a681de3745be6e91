"""Query configuration.

Counterpart of the JAX package's ``config.py``, with the fields this package's
executor reads so far.  Reference: velox/core/QueryConfig.h:44.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class QueryConfig:
    """Per-query options (reference: core::QueryConfig)."""

    # Device-memory budget for one query's device-resident state (scan tiles,
    # join builds, aggregation carries);
    # None = untracked.  Reference: QueryConfig kQueryMaxMemoryPerNode +
    # MemoryArbitrator.h:43.
    query_memory_limit_bytes: Optional[int] = None
    # Grouped aggregation: merge per-tile partial groups on device (sorted-
    # carry state, no per-tile host fetches).  False = host merge of the
    # per-tile partials (one fetch a tile), which handles any group count.
    device_agg_merge: bool = True
    # approx_percentile sketch family (reference: functions/lib/KllSketch.h):
    # "kll" = rank-error sketch (deterministic rank-compressed ECDF; error
    # <= 2/kll_points of the rank, Presto's semantics); "ddsketch" = legacy
    # value-error log buckets (0.5% relative value error).
    percentile_sketch: str = "kll"
    # Rank-space compression points per group for the kll sketch; rank error
    # <= 2/kll_points.  An explicit accuracy argument overrides this
    # (m = ceil(2 / accuracy)).
    kll_points: int = 256

    def copy(self, **overrides) -> "QueryConfig":
        return dataclasses.replace(self, **overrides)


DEFAULT_CONFIG = QueryConfig()
