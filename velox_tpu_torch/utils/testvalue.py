"""Named test-injection points.

Counterpart of the JAX package's ``utils/testvalue.py``.  Reference:
velox/common/testutil/TestValue.h:32 — ``TestValue::adjust(name, state)``
calls placed in the execution engine let tests pause, fail or mutate state at
exact internal points, and count which path ran (the spill, Grace and grouped
execution paths call them).  A dictionary miss unless a hook is registered.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict

_hooks: Dict[str, Callable[[Any], None]] = {}
_lock = threading.Lock()


def adjust(point: str, state: Any = None) -> None:
    """Invoke the hook registered for ``point``, if any."""
    hook = _hooks.get(point)
    if hook is not None:
        hook(state)


def register(point: str, hook: Callable[[Any], None]) -> None:
    with _lock:
        _hooks[point] = hook


def unregister(point: str) -> None:
    with _lock:
        _hooks.pop(point, None)


class scoped:
    """Context manager: register a hook for the scope of a test."""

    def __init__(self, point: str, hook: Callable[[Any], None]):
        self.point = point
        self.hook = hook

    def __enter__(self):
        register(self.point, self.hook)
        return self

    def __exit__(self, *exc):
        unregister(self.point)
        return False
