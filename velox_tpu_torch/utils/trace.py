"""The port's spans, and the device profiler around a query.

``span(name, counts)`` marks one piece of the engine's work on the host.
While a ``torch.profiler`` records, it is a ``record_function`` named
``velox.<name>``, which lands in the profiler's Chrome trace on the same
clock as every kernel, copy and CUDA runtime call; a trace reader charges a
device interval to the span whose host interval holds the runtime call that
launched it (the trace's ``correlation`` id links the two).  ``counts``, a
callable returning a small dict of integers (or lists of them), is written
into the name as ``velox.tile[bytes=123456]`` or
``velox.k2[rows=8,widths=1/4,specs=2,groups=3]``: the profiler keeps a
``record_function``'s name in the trace and drops its arguments.

With no profiler recording, ``span`` returns one shared no-op context: it
formats no name and calls no ``counts``.  Tracing is on exactly when a
profiler records; there is no switch of its own.  A span never synchronises
the device.

Reference: velox/common/process/TraceContext.h (scoped markers of work in
flight).  The spans take the place of the JAX package's ``trace_context``,
``status`` and ``thread_query``, which have no counterpart here.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable, Dict, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "velox."
_OFF = contextlib.nullcontext()


def _value(v) -> str:
    if isinstance(v, (list, tuple)):
        return "/".join(str(int(x)) for x in v)
    return str(int(v))


def span_name(name: str, counts: Optional[Dict[str, object]] = None) -> str:
    """The name a span of ``name`` with ``counts`` takes in the trace."""
    if not counts:
        return PREFIX + name
    return PREFIX + name + "[" + ",".join(f"{k}={_value(v)}" for k, v in counts.items()) + "]"


def span(name: str, counts: Optional[Callable[[], Dict[str, object]]] = None):
    """A context that marks ``name`` in the profiler's trace while one
    records, and the shared no-op context otherwise."""
    if not _profiler_enabled():
        return _OFF
    return record_function(span_name(name, counts() if counts is not None else None))


def spanned(name: str):
    """Decorate a function so that each call of it is one span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


@contextlib.contextmanager
def device_profile(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and, where there is one, CUDA
    activity) around a query and write it to ``log_dir/trace.json`` in the
    Chrome trace format (open in Perfetto or ``chrome://tracing``); the
    engine's spans are in it.  The JAX package's counterpart is
    ``xla_profile(log_dir)``; host-side counters live in ``utils/stats`` and
    ``utils/reporter``.  Yields the profiler, so a caller can read
    ``key_averages()`` too."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
