"""Reading a profiled stretch of the window: the device's intervals, the
harness's host spans, and the idle gaps between device work.

The stretch is recorded by ``torch.profiler`` (CPU and CUDA activities) and
exported as a Chrome trace, whose host and device events share one clock in
microseconds.  Device work is every kernel, copy and fill; the device is busy
over the union of their intervals, so work overlapping on two streams counts
once.  Imports nothing of the program.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."

Interval = Tuple[float, float, str]


@dataclasses.dataclass
class Profile:
    """One profiled stretch, times in microseconds."""

    start: float
    end: float
    device: List[Interval]  # sorted by start
    spans: List[Interval]  # the harness's spans, sorted by start
    ops: List[Interval]  # host operators of the harness's thread, sorted by start
    k2_launches: List[dict]  # the recorded grouped_piece_sums launches, in order

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals inside the stretch."""
        merged: List[List[float]] = []
        for a, b, _ in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        """The stretches of the window in which no device work ran."""
        out, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def device_ops(self, top: int = 10) -> List[list]:
        """[name, seconds] of the device operations that took most time."""
        total: Dict[str, float] = {}
        for a, b, name in self.device:
            total[name] = total.get(name, 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """[what the host was doing, seconds] of the idle time, summed by
        the innermost harness span and host operator open mid-gap."""
        total: Dict[str, float] = {}
        for a, b in self.gaps():
            mid = (a + b) / 2
            span = _innermost(self.spans, mid) or "between queries"
            op = _innermost(self.ops, mid)
            label = f"{span[len(SPAN_PREFIX):] if span.startswith(SPAN_PREFIX) else span}"
            label += f" / {op}" if op else " / python"
            total[label] = total.get(label, 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def kernels(self, fragment: str) -> List[Interval]:
        return [iv for iv in self.device if fragment in iv[2]]


def _innermost(intervals: List[Interval], t: float, reach: int = 4096) -> Optional[str]:
    """The name of the latest-starting interval that contains ``t`` (on one
    thread, properly nested intervals make it the innermost)."""
    i = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    for j in range(i, max(-1, i - reach), -1):
        a, b, name = intervals[j]
        if a <= t <= b:
            return name
    return None


def load(path: str, k2_launches: List[dict]) -> Optional[Profile]:
    """The stretch recorded in the Chrome trace at ``path``: from the start
    of its first harness span to the end of its last; None without spans."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, spans, ops_by_tid = [], [], {}
    span_tid = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        iv = (a, a + float(e["dur"]), str(e.get("name", ""))[:120])
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            device.append(iv)
        elif cat == "user_annotation" and iv[2].startswith(SPAN_PREFIX):
            spans.append(iv)
            span_tid = e.get("tid")
        elif cat == "cpu_op":
            ops_by_tid.setdefault(e.get("tid"), []).append(iv)
    if not spans:
        return None
    spans.sort()
    return Profile(
        start=min(a for a, _, _ in spans),
        end=max(b for _, b, _ in spans),
        device=sorted(device),
        spans=spans,
        ops=sorted(ops_by_tid.get(span_tid, [])),
        k2_launches=list(k2_launches),
    )
