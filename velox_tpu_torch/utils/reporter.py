"""Pluggable process-wide metric sink.

Counterpart of the JAX package's ``utils/reporter.py``; the metric names are
the same, so a sink reads either package's counters under one set of keys.
Reference: velox/common/base/StatsReporter.h:64 (BaseStatsReporter + the
RECORD_METRIC_VALUE macros, with a process singleton integrators replace)
and base/Counters.h (the registered metric set).

Engine code calls :func:`record_metric` / :func:`increment_counter`; the
default reporter accumulates in memory (tests/inspection), and integrators
install their own sink with :func:`set_reporter`.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class BaseStatsReporter:
    """Interface + in-memory default implementation."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        self.values: Dict[str, list] = {}

    def add_counter(self, name: str, delta: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def record_value(self, name: str, value: float) -> None:
        with self._lock:
            self.values.setdefault(name, []).append(value)

    def counter(self, name: str) -> int:
        return self.counters.get(name, 0)


_reporter: BaseStatsReporter = BaseStatsReporter()


def reporter() -> BaseStatsReporter:
    return _reporter


def set_reporter(r: BaseStatsReporter) -> Optional[BaseStatsReporter]:
    """Install a custom sink; returns the previous one."""
    global _reporter
    prev, _reporter = _reporter, r
    return prev


def increment_counter(name: str, delta: int = 1) -> None:
    _reporter.add_counter(name, delta)


def record_metric(name: str, value: float) -> None:
    _reporter.record_value(name, value)


# Registered metric names (reference: common/base/Counters.h documents the
# process metric set; docs/develop/debugging/metrics.rst lists cache/IO ones).
METRIC_QUERY_COUNT = "velox_tpu.query_count"
METRIC_QUERY_SECONDS = "velox_tpu.query_seconds"
METRIC_TILES_EXECUTED = "velox_tpu.tiles_executed"
METRIC_ROWS_SCANNED = "velox_tpu.rows_scanned"
METRIC_SPILLED_BYTES = "velox_tpu.spilled_bytes"
METRIC_CACHE_HITS = "velox_tpu.host_cache_hits"
METRIC_CACHE_MISSES = "velox_tpu.host_cache_misses"
