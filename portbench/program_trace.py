"""Reading the program's own spans in a profiled stretch.

The port marks its work with ``velox.<name>`` spans (``record_function``,
category ``user_annotation``) while a profiler records; some carry counts in
their names (``velox.tile[bytes=N]``).  The Chrome trace holds them on the
same clock as the CUDA runtime calls (``cuda_runtime`` / ``cuda_driver``) and
the device's kernels, copies and fills, which name the runtime call that
launched them by ``args.correlation``.  So a device interval is charged to
the program span open around its launch, a synchronisation to the span open
around it, and an idle gap to the span open in its middle.

``load(path)`` reads one trace into a ``ProgramTrace``: the stretch as
``trace_read.load`` reads it (``base``, which every metric of the accepted
benchmark reads, unchanged), and beside it the program's spans, the runtime
calls and the device intervals with their correlation.  The four readings
``build_side_ms``, ``build_upload_mib``, ``host_syncs_per_query`` and
``aggregation_device_ms`` are per profiled query (``portbench.<kind>.query``
spans); each is None where the trace holds no span it reads, as a trace of
a program without these spans does, and the last two where it holds no
runtime call or device interval, as a CPU rehearsal's does.  Imports nothing
of the program.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from typing import Dict, List, Optional, Tuple

from . import trace_read
from .trace_read import DEVICE_CATEGORIES, SPAN_PREFIX, Interval, _innermost

PROGRAM_PREFIX = "velox."
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
# calls that hold the host until the device has caught up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
_NAME = re.compile(r"^velox\.([A-Za-z0-9_]+)(?:\[(.*)\])?$")


def span_kind(name: str) -> str:
    """``velox.tile[bytes=5]`` -> ``velox.tile``."""
    return name.split("[", 1)[0]


def span_counts(name: str) -> Dict[str, object]:
    """The counts in a span's name: an int, or a list of ints where the
    value holds ``/``."""
    m = _NAME.match(name)
    if m is None or not m.group(2):
        return {}
    out: Dict[str, object] = {}
    for kv in m.group(2).split(","):
        k, v = kv.split("=", 1)
        out[k] = [int(x) for x in v.split("/")] if "/" in v else int(v)
    return out


@dataclasses.dataclass
class Call:
    """A CUDA runtime or driver call on the host."""

    start: float
    end: float
    name: str
    tid: object
    correlation: Optional[int]


@dataclasses.dataclass
class ProgramTrace:
    """One profiled stretch with the program's spans, times in microseconds."""

    base: trace_read.Profile
    spans: Dict[object, List[Interval]]  # the program's spans by thread, sorted by start
    calls: List[Call]  # runtime calls, sorted by start
    device: List[Tuple[float, float, str, Optional[int]]]  # with the launch's correlation
    queries: List[Interval]  # the harness's query spans
    _by_kind: dict = dataclasses.field(default_factory=dict, repr=False)

    # ---- what the spans hold -------------------------------------------
    def program_spans(self, kind: Optional[str] = None) -> List[Tuple[float, float, str, object]]:
        """(start, end, name, thread) of every program span in the stretch,
        or of those of one ``kind`` (``velox.build``), by start."""
        out = [(a, b, n, tid) for tid, ivs in self.spans.items() for a, b, n in ivs
               if self.base.start <= a <= self.base.end and (kind is None or span_kind(n) == kind)]
        return sorted(out)

    def innermost(self, tid, t: float) -> Optional[str]:
        """The name of the innermost program span of thread ``tid`` open at ``t``."""
        ivs = self.spans.get(tid)
        return _innermost(ivs, t) if ivs else None

    def is_open(self, kind: str, tid, t: float) -> bool:
        """Whether a span of ``kind`` of thread ``tid`` is open at ``t`` (a
        call or a span on one thread lies inside a span it starts in)."""
        key = (kind, tid)
        if key not in self._by_kind:
            self._by_kind[key] = [iv for iv in self.spans.get(tid, ()) if span_kind(iv[2]) == kind]
        ivs = self._by_kind[key]
        return bool(ivs) and _innermost(ivs, t) is not None

    def launcher(self) -> Dict[int, Call]:
        return {c.correlation: c for c in self.calls if c.correlation is not None}

    def _query_of(self, t: float) -> Optional[int]:
        i = bisect.bisect_right(self.queries, (t, float("inf"), "")) - 1
        if i >= 0 and self.queries[i][0] <= t <= self.queries[i][1]:
            return i
        return None

    def _per_query(self, values: Dict[int, float]) -> Optional[float]:
        if not self.queries:
            return None
        return sum(values.values()) / len(self.queries)

    # ---- the four readings -----------------------------------------------
    def build_side_ms(self) -> Optional[float]:
        """Mean over the profiled queries of the summed durations of each
        query's outermost ``velox.build`` spans, in ms."""
        builds = self.program_spans("velox.build")
        if not builds:
            return None
        per: Dict[int, float] = {}
        for a, b, _, _ in _outermost(builds):
            q = self._query_of(a)
            if q is not None:
                per[q] = per.get(q, 0.0) + (b - a) * 1e-3
        return self._per_query(per)

    def build_upload_mib(self) -> Optional[float]:
        """Mean over the profiled queries of the bytes of the ``velox.tile``
        spans that lie inside a ``velox.build``, in MiB."""
        builds = self.program_spans("velox.build")
        if not builds:
            return None
        per: Dict[int, float] = {}
        for a, _, name, tid in self.program_spans("velox.tile"):
            q = self._query_of(a)
            if q is not None and self.is_open("velox.build", tid, a):
                per[q] = per.get(q, 0.0) + span_counts(name)["bytes"] / 2**20
        return self._per_query(per)

    def host_syncs_per_query(self) -> Optional[float]:
        """Synchronising CUDA calls whose host interval lies inside a
        ``velox.construct`` or ``velox.run`` span, per profiled query."""
        if not (self.program_spans("velox.construct") or self.program_spans("velox.run")):
            return None
        if not self.calls:
            return None
        per: Dict[int, float] = {}
        for c in self.syncs():
            q = self._query_of(c.start)
            if q is not None and (self.is_open("velox.construct", c.tid, c.start)
                                  or self.is_open("velox.run", c.tid, c.start)):
                per[q] = per.get(q, 0.0) + 1
        return self._per_query(per)

    def aggregation_device_ms(self) -> Optional[float]:
        """Device ms per profiled query of the kernels, copies and fills
        launched from inside a ``velox.aggregate`` span (their union within
        each query)."""
        if not self.program_spans("velox.aggregate") or not self.device:
            return None
        launcher = self.launcher()
        by_query: Dict[int, List[Tuple[float, float]]] = {}
        for a, b, _, corr in self.device:
            c = launcher.get(corr)
            if c is None:
                continue
            q = self._query_of(c.start)
            if q is not None and self.is_open("velox.aggregate", c.tid, c.start):
                by_query.setdefault(q, []).append((a, b))
        return self._per_query({q: _union_us(ivs) * 1e-3 for q, ivs in by_query.items()})

    # ---- tables for PERF.md ----------------------------------------------
    def syncs(self) -> List[Call]:
        return [c for c in self.calls if c.name in SYNCS
                and self.base.start <= c.start <= self.base.end]

    def k2_operands(self) -> List[dict]:
        """Each ``velox.k2`` span's operands, in ``harness.K2Recorder``'s form."""
        out = []
        for _, _, name, _ in self.program_spans("velox.k2"):
            c = span_counts(name)
            widths = c["widths"] if isinstance(c["widths"], list) else [c["widths"]]
            out.append(dict(rows=c["rows"], widths=widths, n_specs=c["specs"],
                            num_groups=c["groups"]))
        return out

    def launched_inside_share(self) -> Optional[float]:
        """Share of the stretch's device time whose launch lies inside a
        program span, in %."""
        launcher = self.launcher()
        total = inside = 0.0
        for a, b, _, corr in self._stretch_device():
            total += b - a
            c = launcher.get(corr)
            if c is not None and self.innermost(c.tid, c.start) is not None:
                inside += b - a
        return 100.0 * inside / total if total > 0 else None

    def by_span(self) -> Dict[str, Dict[str, float]]:
        """For each innermost program span (by kind; "(none)" outside
        them): device ms by the span its launch lies in, idle ms by the
        span open mid-gap on the harness's thread, and synchronisations."""
        launcher = self.launcher()
        table: Dict[str, Dict[str, float]] = {}

        def row(label):
            return table.setdefault(span_kind(label) if label else "(none)",
                                    {"device_ms": 0.0, "idle_ms": 0.0, "syncs": 0})

        for a, b, _, corr in self._stretch_device():
            c = launcher.get(corr)
            row(self.innermost(c.tid, c.start) if c else None)["device_ms"] += (b - a) * 1e-3
        tid = self._harness_tid()
        for a, b in self.base.gaps():
            row(self.innermost(tid, (a + b) / 2))["idle_ms"] += (b - a) * 1e-3
        for c in self.syncs():
            row(self.innermost(c.tid, c.start))["syncs"] += 1
        return dict(sorted(table.items(), key=lambda kv: -kv[1]["device_ms"] - kv[1]["idle_ms"]))

    def sync_sites(self, top: int = 10) -> List[list]:
        """[innermost program span / host operator, count] of the stretch's
        synchronisations: which step waits, and in which operator."""
        total: Dict[str, int] = {}
        for c in self.syncs():
            program = self.innermost(c.tid, c.start)
            op = _innermost(self.base.ops, c.start) if c.tid == self._harness_tid() else None
            label = f"{span_kind(program) if program else '(none)'} / {op or 'python'}"
            total[label] = total.get(label, 0) + 1
        return [[n, k] for n, k in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """[what the host was doing, seconds] of the idle time, as
        ``trace_read.Profile.idle_gaps`` labels it, with the innermost
        program span between the harness's span and the host operator:
        ``q3.construct / velox.tile / aten::copy_``."""
        tid = self._harness_tid()
        total: Dict[str, float] = {}
        for a, b in self.base.gaps():
            mid = (a + b) / 2
            span = _innermost(self.base.spans, mid) or "between queries"
            span = span[len(SPAN_PREFIX):] if span.startswith(SPAN_PREFIX) else span
            program = self.innermost(tid, mid)
            op = _innermost(self.base.ops, mid)
            label = span + (f" / {span_kind(program)}" if program else "") + f" / {op or 'python'}"
            total[label] = total.get(label, 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def _stretch_device(self):
        return [d for d in self.device if d[1] > self.base.start and d[0] < self.base.end]

    def _harness_tid(self):
        """The thread of the program spans that open inside the harness's
        query spans (the thread that runs the queries)."""
        for tid, ivs in self.spans.items():
            if any(self._query_of(a) is not None for a, _, _ in ivs):
                return tid
        return None


def _outermost(spans):
    """The spans no other span of the list (on their thread) holds."""
    out, last_end = [], {}
    for a, b, name, tid in spans:  # sorted by start
        if a >= last_end.get(tid, float("-inf")):
            out.append((a, b, name, tid))
            last_end[tid] = b
        else:
            last_end[tid] = max(last_end[tid], b)
    return out


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def load(path: str) -> Optional[ProgramTrace]:
    """The stretch of the Chrome trace at ``path`` with the program's spans;
    None where ``trace_read.load`` finds no stretch."""
    base = trace_read.load(path, [])
    if base is None:
        return None
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans: Dict[object, List[Interval]] = {}
    calls, device, queries = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        name, cat = str(e.get("name", "")), e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PROGRAM_PREFIX):
            spans.setdefault(e.get("tid"), []).append((a, b, name))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX) and name.endswith(".query"):
            queries.append((a, b, name))
        elif cat in RUNTIME_CATEGORIES:
            calls.append(Call(a, b, name, e.get("tid"), corr))
        elif cat in DEVICE_CATEGORIES:
            device.append((a, b, name[:120], corr))
    for ivs in spans.values():
        ivs.sort()
    calls.sort(key=lambda c: c.start)
    return ProgramTrace(base=base, spans=spans, calls=calls, device=sorted(device, key=lambda d: d[:2]),
                        queries=sorted(queries))
