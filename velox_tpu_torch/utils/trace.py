"""Process-wide scoped tracing of outstanding operations, and the device
profiler around a query.

Counterpart of the JAX package's ``utils/trace.py``.  Reference:
velox/common/process/TraceContext.h:50 (scoped counters of in-flight
operations, dumpable for forensics) and ThreadDebugInfo (query / task ids
stamped on threads).  Thread-safe; ``status()`` is the crash-forensics dump.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict

_lock = threading.Lock()
_live: Dict[str, int] = collections.defaultdict(int)
_totals: Dict[str, int] = collections.defaultdict(int)
_since: Dict[str, float] = {}
_thread_local = threading.local()


@contextlib.contextmanager
def trace_context(label: str):
    """Scoped 'operation in progress' marker (reference: TraceContext ctor/dtor)."""
    with _lock:
        _live[label] += 1
        _totals[label] += 1
        _since.setdefault(label, time.time())
    try:
        yield
    finally:
        with _lock:
            _live[label] -= 1
            if _live[label] == 0:
                del _live[label]
                _since.pop(label, None)


def status() -> str:
    """Reference: TraceContext::statusLine — dump of outstanding operations."""
    with _lock:
        now = time.time()
        lines = [
            f"{label}: live={count} total={_totals[label]} "
            f"oldest={now - _since.get(label, now):.1f}s"
            for label, count in sorted(_live.items())
        ]
    return "\n".join(lines) if lines else "(no outstanding operations)"


@contextlib.contextmanager
def device_profile(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and, where there is one, CUDA
    activity) around a query and write it to ``log_dir/trace.json`` in the
    Chrome trace format (open in Perfetto or ``chrome://tracing``).  The JAX
    package's counterpart is ``xla_profile(log_dir)``; host-side counters
    live in ``utils/stats`` and ``utils/reporter``.  Yields the profiler, so
    a caller can read ``key_averages()`` too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def set_thread_query(query_id: str, task_id: str = "") -> None:
    """Reference: ThreadDebugInfo — stamp ids on the current thread."""
    _thread_local.query_id = query_id
    _thread_local.task_id = task_id


def thread_query() -> tuple:
    return (
        getattr(_thread_local, "query_id", None),
        getattr(_thread_local, "task_id", None),
    )
