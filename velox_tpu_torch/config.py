"""Query configuration.

Counterpart of the JAX package's ``config.py``, with the same fields and
defaults.  Reference: velox/core/QueryConfig.h:44 — string-keyed
session options over a generic Config map (core/Config.h:29), plus
per-connector config tiers (velox/connectors/hive/HiveConfig.h).  The knob set
here is typed; a string-keyed bridge (``QueryConfig.from_properties``) accepts
the reference's session-property style, and ``connector()`` exposes the
per-connector tier.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class HiveConnectorConfig:
    """Per-connector options (reference: connectors/hive/HiveConfig.h).

    One tier per connector name; reach it via ``QueryConfig.connector("hive")``.
    """

    # Parallel split reads (reference: split preloading executor,
    # TableScan.cpp:245 + kMaxSplitPreloadPerDriver).
    split_preload_threads: int = 8


@dataclasses.dataclass
class QueryConfig:
    """Per-query options (reference: core::QueryConfig).

    ``tile_rows``, ``bench_tile_rows``, ``max_array_groups``,
    ``abandon_partial_min_pct``, ``strict_errors``, ``session_timezone`` and
    ``adjust_timestamp_to_session_timezone`` are accepted and round-tripped
    as the JAX package's are; as there, no executor reads them (the tile size
    is a run argument)."""

    # kPreferredOutputBatchRows analog: rows per device tile.
    tile_rows: int = 1 << 20
    # kMaxOutputBatchRows analog for the benchmark path.
    bench_tile_rows: int = 1 << 22
    # HashTable kArray-mode ceiling (reference: HashTable::decideHashMode).
    max_array_groups: int = 256
    # kAbandonPartialAggregation* analog (future use).
    abandon_partial_min_pct: float = 0.8
    # Spill: host-offload accumulated partial batches beyond this many bytes
    # (reference: kSpillWriteBufferSize / kAggregationSpillEnabled family).
    spill_bytes_threshold: int = 4 << 30
    spill_enabled: bool = True
    # Spill file compression (reference: kSpillCompressionKind): "zlib"|"none".
    spill_compression: str = "zlib"
    # Device-memory budget for one query's device-resident state (scan tiles,
    # join builds, aggregation carries); None = untracked.  On pressure the
    # arbitrator reclaims (data cache first), the grouped-aggregation carry
    # degrades to the spilling host-merge path, and joins degrade to the
    # Grace partitioned path (exec/grace.py).  Reference:
    # QueryConfig kQueryMaxMemoryPerNode + MemoryArbitrator.h:43.
    query_memory_limit_bytes: Optional[int] = None
    # Grouped aggregation: merge per-tile partial groups on device (sorted-
    # carry state, no per-tile host fetches).  False = host merge of the
    # per-tile partials (one fetch a tile), which handles any group count and
    # spills the partials past spill_bytes_threshold.
    device_agg_merge: bool = True
    # approx_percentile sketch family (reference: functions/lib/KllSketch.h):
    # "kll" = rank-error sketch (deterministic rank-compressed ECDF; error
    # <= 2/kll_points of the rank, Presto's semantics); "ddsketch" = legacy
    # value-error log buckets (0.5% relative value error).
    # Expression eval: raise on row errors (False = silently null, non-Presto).
    strict_errors: bool = True
    # Exchange: per-destination bucket rows of a shuffle join's probe
    # exchange (None = the balanced share of a shard with 4x slack;
    # parallel/runner.py).
    exchange_bucket_rows: Optional[int] = None
    # Distributed joins: build sides up to this many rows replicate to every
    # rank (kBroadcast); larger builds hash-partition and probe rows shuffle
    # (kPartitioned).  Reference: core/PlanNode.h:1107 PartitionedOutput modes.
    broadcast_join_max_rows: int = 1 << 16
    # Distributed grouped aggregation: initial carry slots a rank (grown 4x on
    # overflow and the query retried — the backpressure analog of
    # OutputBuffer limits, velox/exec/OutputBuffer.h:131).  None = the rows
    # of a rank's shard of a tile.
    distributed_carry_rows: Optional[int] = None
    percentile_sketch: str = "kll"
    # Rank-space compression points per group for the kll sketch; rank error
    # <= 2/kll_points.  An explicit accuracy argument overrides this
    # (m = ceil(2 / accuracy)).
    kll_points: int = 256
    # Timezone for timestamp functions (reference: kSessionTimezone).
    session_timezone: str = "UTC"
    # Adjust timestamps to the session timezone before extracting calendar
    # fields (reference: kAdjustTimestampToTimezone).
    adjust_timestamp_to_session_timezone: bool = False

    # ---- per-connector tier (reference: connector config maps) ---------
    _connector_configs: Dict[str, object] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def connector(self, name: str):
        """The per-connector config tier (created on first access)."""
        if name not in self._connector_configs:
            if name == "hive":
                self._connector_configs[name] = HiveConnectorConfig()
            else:
                raise KeyError(f"no connector config tier for {name!r}")
        return self._connector_configs[name]

    def copy(self, **overrides) -> "QueryConfig":
        return dataclasses.replace(self, **overrides)

    # ---- string-keyed session property bridge ---------------------------
    @staticmethod
    def from_properties(props: Dict[str, str]) -> "QueryConfig":
        """Build a config from a string-keyed property map — the reference's
        session-property surface (core/Config.h:29).  Values are parsed by
        the field's declared type; unknown keys raise (the reference's
        checked config accessors do too)."""
        return DEFAULT_CONFIG.with_properties(props)

    def with_properties(self, props: Dict[str, str]) -> "QueryConfig":
        fields = {f.name: f for f in dataclasses.fields(self)}
        overrides = {}
        for key, raw in props.items():
            name = key.replace(".", "_").replace("-", "_")
            f = fields.get(name)
            if f is None or name.startswith("_"):
                raise KeyError(f"unknown session property {key!r}")
            overrides[name] = _parse_property(f, raw)
        return self.copy(**overrides)

    def to_properties(self) -> Dict[str, str]:
        out = {}
        for f in dataclasses.fields(self):
            if f.name.startswith("_"):
                continue
            v = getattr(self, f.name)
            out[f.name] = "" if v is None else str(v).lower() if isinstance(v, bool) else str(v)
        return out


def _parse_property(field, raw: str):
    t = str(field.type)
    raw = raw.strip()
    if "bool" in t:
        if raw.lower() in ("true", "1", "yes"):
            return True
        if raw.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"bad boolean for {field.name!r}: {raw!r}")
    if "Optional[int]" in t:
        return None if raw in ("", "none", "null") else int(raw)
    if "int" in t:
        return int(raw)
    if "float" in t:
        return float(raw)
    return raw


DEFAULT_CONFIG = QueryConfig()
