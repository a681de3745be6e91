"""The benchmark's harness: one cell of ``BENCHMARK.json``, one run.

A run makes the cell's TPC-H columns on the device from the seed, copies them
once into the program's host tables, uploads each query kind's resident tiles
and warms each kind with one query (all of that is set-up), then runs a
closed loop with one client for the window: query after query in the cell's
sequence, each with parameters drawn from the seed, each timed from
``LocalExecutor(...)`` to the result table on the host.  Once the window has
closed and its memory peak is read, the program's state is freed and the
plain reference (``portbench/reference``) works out every answer the window
returned, from the same generated columns.

Everything a configuration, a cell, a query kind or a metric needs is found
by name: ``configs/<name>.json``, ``workloads/<cell>.json``,
``queries/<kind>.py`` with ``reference/<kind>.py``, ``metrics/<metric>.py``.

A configuration with a ``mesh`` runs across ranks, one process a card
(``mesh.py``): each rank runs this same set-up, window and check through a
``mesh.Rank`` in place of ``OneProcess``, which is the program in one process.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import compare, datagen, params, trace_read

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "velox_tpu")
# queries the profiler runs before it records: its own start-up (CUPTI)
# slows the first queries it sees
PROFILER_WARMUP = 4


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_entry(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may load, compared as
    whole names (``velox_tpu_torch`` is not ``velox_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Query:
    kind: str
    params: dict
    rows: int  # base-table rows it scans, before filters
    latency_s: float = 0.0
    construct_s: Optional[float] = None
    pipeline_s: Optional[float] = None
    plan_s: float = 0.0
    profiled: bool = False
    result: object = None  # the program's result Table, read after the window
    answer: Optional[list] = None
    error: Optional[str] = None


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    platform: str
    setup_s: float
    window_s: float
    queries: List[Query]
    window_peak_bytes: Optional[int]
    profile: Optional[trace_read.Profile] = None

    def completed(self) -> List[Query]:
        return [q for q in self.queries if q.error is None]

    def profiled(self) -> List[Query]:
        return [q for q in self.completed() if q.profiled]


class Cell:
    """A workload file with its configuration and query kinds, read from
    ``folder`` (a package under ``portbench/``; tests keep cells of their
    own), whose ``queries/`` and ``reference/`` may hold kinds of its own."""

    def __init__(self, name: str, scale_factor: Optional[float] = None,
                 tile_rows: Optional[int] = None, folder: str = HERE):
        self.folder = folder
        self.spec = load_json(folder, "workloads", name + ".json")
        self.config = load_json(folder, "configs", self.spec["config"] + ".json")
        self.sf = scale_factor if scale_factor is not None else self.config["scale_factor"]
        self.tile_rows = tile_rows if tile_rows is not None else self.config["tile_rows"]
        self.sequence: List[str] = self.spec["sequence"]
        self.rules: Dict[str, dict] = self.spec["parameters"]
        # {"ranks", "backend"[, "timeout_s"]}: one process a rank (mesh.py)
        self.mesh: Optional[dict] = self.config.get("mesh")
        # {table: "replicated" | "chunk"}: what each rank holds (replicated if unnamed)
        self.placement: Dict[str, str] = self.config.get("placement", {})
        self.kinds = {k: self._module("queries", k) for k in dict.fromkeys(self.sequence)}
        self.references = {k: self._module("reference", k) for k in self.kinds}

    def _module(self, part: str, kind: str):
        """``<folder>/<part>/<kind>.py`` where the folder has it, else the benchmark's own."""
        package = "portbench"
        if os.path.exists(os.path.join(self.folder, part, kind + ".py")):
            package = os.path.relpath(self.folder, ROOT).replace(os.sep, ".")
        return importlib.import_module(f"{package}.{part}.{kind}")

    def columns(self) -> Dict[str, List[str]]:
        """Every column any of the cell's kinds reads, by table."""
        out: Dict[str, List[str]] = {}
        for kind in self.kinds.values():
            for table, cols in kind.TABLES.items():
                out.setdefault(table, [])
                out[table] += [c for c in cols if c not in out[table]]
        return out


def program_tables(host: Dict[str, Dict[str, np.ndarray]]):
    """The program's host ``Table``s over the generated columns (no copy),
    their column statistics computed once, as a worker that loads them would."""
    from velox_tpu_torch.testing import table_from_numpy

    tables = {}
    for name, cols in host.items():
        names = list(cols)
        types = {c: datagen.column_type(name, c) for c in names}
        table = table_from_numpy(
            names,
            [types[c][0] for c in names],
            cols,
            {c: [""] + types[c][1] for c in names if types[c][1] is not None},
        )
        for c in names:
            table.column_bounds(c)
        tables[name] = table
    return tables


def answer_of(table) -> list:
    """A result ``Table`` as the columns ``compare.compare`` reads."""
    from velox_tpu_torch.dtypes import TypeKind

    out = []
    for name, dtype in zip(table.schema.names, table.schema.types):
        values = np.asarray(table.columns[name])
        kind, scale = "int", 0
        if dtype.is_string:
            kind, values = "string", table.string_tables[name].decode(values)
        elif dtype.kind == TypeKind.DECIMAL:
            kind, scale = "decimal", dtype.scale
        elif dtype.is_floating:
            kind = "double"
        values = values.tolist()
        valid = table.validities.get(name)
        if valid is not None:
            values = [v if ok else None for v, ok in zip(values, np.asarray(valid).tolist())]
        out.append((name, kind, scale, values))
    return out


def _sync(device):
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class K2Recorder:
    """Records the operands of each grouped piece-sum launch (rows, widths,
    specs, groups) while installed: the count the byte roofline reads.  The
    wrapper takes the function's place in every loaded module that holds it,
    however the program imports it; ``k2_roofline_share`` refuses a trace
    whose launches it did not all record."""

    def __init__(self):
        self.launches: List[dict] = []
        self._original = None
        self._holders: List[object] = []

    def install(self):
        from velox_tpu_torch.ops import group_piece

        original = self._original = group_piece.grouped_piece_sums
        launches = self.launches

        def recording(cols, gid_live, plans, num_groups):
            cols, plans = tuple(cols), tuple(plans)
            if gid_live.device.type == "cuda":
                launches.append(dict(
                    rows=int(gid_live.shape[0]),
                    widths=[t.element_size() for t in (*cols, gid_live)],
                    n_specs=len(plans), num_groups=int(num_groups),
                ))
            return original(cols, gid_live, plans, num_groups)

        recording.launches = original.launches
        recording.last_geometry = original.last_geometry
        # read each module's own names: no module's __getattr__ runs
        self._holders = [m for m in list(sys.modules.values())
                         if getattr(m, "__dict__", {}).get("grouped_piece_sums") is original]
        for m in self._holders:
            m.grouped_piece_sums = recording

    def remove(self):
        if self._original is not None:
            for m in self._holders:
                m.grouped_piece_sums = self._original
            self._original, self._holders = None, []


def run_query(kind: str, plan, tiles, executor, device, spans: bool, q: Query):
    """One query, timed from executor construction (``executor(plan)``) to
    the result on the host; with ``spans``, construction and run are each a
    ``record_function`` span closed by a synchronisation."""
    from torch.profiler import record_function

    _sync(device)
    try:
        t0 = time.perf_counter()
        if spans:
            with record_function(f"portbench.{kind}.query"):
                with record_function(f"portbench.{kind}.construct"):
                    ex = executor(plan)
                    _sync(device)
                t1 = time.perf_counter()
                with record_function(f"portbench.{kind}.pipeline"):
                    result = ex.run(prefetched_tiles=tiles)
                    _sync(device)
            t2 = time.perf_counter()
            q.construct_s, q.pipeline_s = t1 - t0, t2 - t1
        else:
            ex = executor(plan)
            result = ex.run(prefetched_tiles=tiles)
            t2 = time.perf_counter()
        q.latency_s = t2 - t0
    except Exception as e:  # the loop goes on; the run reports the query as failed
        q.error = f"{type(e).__name__}: {e}"
        return
    q.result = result


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


class OneProcess:
    """Where the program runs when the configuration has no ``mesh``: in this
    process alone, ``LocalExecutor`` over whole tables.  ``mesh.Rank`` runs
    the same set-up, window and check as one rank of several."""

    ranks = 1

    def __init__(self, cell: Cell, seconds: float, device):
        self.cell, self.seconds, self.device = cell, seconds, device

    def executor(self, plan):
        from velox_tpu_torch.exec.runner import LocalExecutor

        return LocalExecutor(plan, tile_rows=self.cell.tile_rows, device=self.device)

    def host(self, seed: int, data_device):
        """The columns this process holds, made from the seed."""
        return datagen.generate_host(self.cell.sf, seed, self.cell.columns(), data_device)

    def whole(self, host, seed: int, data_device):
        """Every row of every table, for the reference."""
        return host

    def window_opens(self) -> float:
        """The set-up's seconds, read as the window opens."""
        return process_age_s()

    def rows(self, tables) -> Dict[str, int]:
        """Base-table rows a query of each kind scans."""
        return {k: sum(tables[k][t].num_rows for t in mod.TABLES)
                for k, mod in self.cell.kinds.items()}

    def go(self, elapsed_s: float, queries: List[Query]) -> bool:
        """Whether the window sends another query."""
        return elapsed_s < self.seconds

    def gather(self, setup_peak, window_peak, queries: List[Query], profile) -> Optional[dict]:
        """What the result reports of every rank: the window's and the whole
        run's memory peak (the fullest rank's), each rank's peak and
        queries, the answers that differ from rank 0's, the device's busy
        seconds (their mean); None on a rank that reports nothing."""
        peak = None if window_peak is None else max(setup_peak, window_peak)
        return {"window_peak": window_peak, "memory_peak": peak, "by_rank": [peak],
                "attempted": [len(queries)], "mismatched": 0,
                "busy_s": profile.busy_s() if profile is not None else None}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             scale_factor: Optional[float] = None, tile_rows: Optional[int] = None,
             folder: str = HERE, place=OneProcess) -> Optional[dict]:
    """One run of cell ``name``; returns the result line's object.  ``device``
    None is the CUDA device (the program raises without one); the CPU, with
    a smaller ``scale_factor`` and ``tile_rows``, is for rehearsals and
    tests only.  ``place(cell, seconds, device)`` says where the program
    runs (``OneProcess``, or a rank of ``mesh.py``, where only rank 0
    returns the result and the others None)."""
    cell = Cell(name, scale_factor, tile_rows, folder)
    on_gpu = device is None or torch.device(device).type == "cuda"
    data_device = "cuda" if on_gpu else device
    place = place(cell, seconds, device)
    host, tables, tiles, phases = set_up(cell, seed, device, data_device, place)
    setup_peak = None
    if on_gpu:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = place.window_opens()

    rows = place.rows(tables)
    stretch = cell.spec["profiled_queries"] if trace else 0
    queries, window_s, profile, pauses = window(
        cell, seed, place, stretch, tables, tiles, rows, device, on_gpu)
    window_peak = None
    if on_gpu:
        torch.cuda.synchronize()
        window_peak = torch.cuda.max_memory_allocated()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    # the program's state goes before the reference runs
    del tiles, tables
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    for q in queries:
        if q.result is not None:
            q.answer, q.result = answer_of(q.result), None
    ranks = place.gather(setup_peak, window_peak, queries, profile)
    if ranks is None:
        return None
    checks = check_answers(cell, place.whole(host, seed, data_device), queries, data_device)
    checks["mismatched_cells"]["value"] += ranks["mismatched"]
    check_s = time.perf_counter() - t_check

    run = Run("gpu" if on_gpu else "cpu", setup_s, window_s, queries, ranks["window_peak"],
              profile)
    metrics = {}
    for m in benchmark()["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        value = importlib.import_module(f"portbench.metrics.{m['name']}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": run.platform, "count": place.ranks}
    if on_gpu:
        dev.update(kind=torch.cuda.get_device_name(), memory_peak_bytes=ranks["memory_peak"],
                   power_limit_w=power_limit_w())
    else:
        dev.update(kind="cpu", memory_peak_bytes=0)
    out = {"correct": bool(queries) and all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": len(queries), "failed": sum(q.error is not None for q in queries),
           "metrics": metrics, "device": dev}
    if place.ranks > 1:
        dev["memory_peak_bytes_by_rank"] = ranks["by_rank"] if on_gpu else [0] * place.ranks
        out["attempted_by_rank"] = ranks["attempted"]
    if profile is not None and on_gpu:
        dev.update(busy_s=ranks["busy_s"], window_s=profile.window_s)
        out["breakdown"] = {"device_ops": profile.device_ops(), "idle_gaps": profile.idle_gaps()}
    out["checks"] = checks
    phases.update(window=window_s, check=check_s)
    print_summary(cell, phases, pauses, queries)
    return out


def set_up(cell: Cell, seed: int, device, data_device, place: OneProcess):
    """The cell's columns made from the seed and copied to the program's host
    tables, each query kind's resident tiles uploaded and one query of each
    kind run; returns (host columns, tables by kind, tiles by kind, the
    seconds of each phase)."""
    phases = {"start": process_age_s()}
    clock = time.perf_counter()

    def phase(name):
        nonlocal clock
        _sync(device)
        phases[name], clock = time.perf_counter() - clock, time.perf_counter()

    host = place.host(seed, data_device)
    phase("data")
    base = program_tables(host)
    tables = {k: {t: base[t].select(cols) for t, cols in mod.TABLES.items()}
              for k, mod in cell.kinds.items()}
    phase("tables")
    warm_rng = np.random.default_rng([int(seed), 1])
    tiles = {}
    for k, mod in cell.kinds.items():
        ex = place.executor(mod.build(tables[k], params.draw(cell.rules[k], warm_rng)))
        tiles[k] = ex.device_tiles()
        phase(f"tiles.{k}")
        ex.run(prefetched_tiles=tiles[k])
        del ex
        phase(f"warm.{k}")
    gc.collect()
    return host, tables, tiles, phases


def draws(cell: Cell, seed: int) -> Iterator[Tuple[str, dict]]:
    """The window's queries, endless: (kind, parameters) in the cell's
    sequence, the parameters drawn from the seed.  The control answers the
    same draws."""
    rng = np.random.default_rng(int(seed))
    for i in itertools.count():
        kind = cell.sequence[i % len(cell.sequence)]
        yield kind, params.draw(cell.rules[kind], rng)


def window(cell: Cell, seed: int, place: OneProcess, stretch: int, tables, tiles, rows, device,
           on_gpu: bool):
    """The closed loop: query after query while ``place.go`` says so (in one
    process, until the run's seconds have passed).
    With ``stretch``, every query has spans, and the profiler records
    ``stretch`` queries after its first ``PROFILER_WARMUP``.  Returns
    (queries, seconds it took, the profiled stretch or None, the
    collector's pauses)."""
    todo = draws(cell, seed)
    recorder, traced = K2Recorder(), []
    first, last = PROFILER_WARMUP, PROFILER_WARMUP + stretch
    prof = _start_profiler(on_gpu, stretch, lambda p: traced.append(
        _read_profile(p, recorder.launches))) if stretch else None
    queries: List[Query] = []
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    t_start = time.perf_counter()
    while place.go(time.perf_counter() - t_start, queries):
        i = len(queries)
        if prof is not None and i == first:
            recorder.install()
        kind, drawn = next(todo)
        q = Query(kind, drawn, rows[kind], profiled=prof is not None and first <= i < last)
        t_plan = time.perf_counter()
        plan = cell.kinds[kind].build(tables[kind], q.params)
        q.plan_s = time.perf_counter() - t_plan
        run_query(kind, plan, tiles[kind], place.executor, device, bool(stretch), q)
        queries.append(q)
        if prof is not None:
            if i + 1 == last:
                recorder.remove()
                _sync(device)
            prof.step()  # hands the trace over once the stretch is recorded
            if i + 1 == last:
                prof.stop()
                prof = None
    window_s = time.perf_counter() - t_start
    gc.callbacks.remove(pauses)
    recorder.remove()
    if prof is not None:
        _sync(device)
        prof.stop()
    return queries, window_s, (traced[0] if traced else None), pauses


def print_summary(cell: Cell, phases: dict, pauses, queries: List[Query]) -> None:
    """The seconds of each phase and each kind's latencies, on stderr."""
    print("portbench: s " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()) + f"; {pauses}",
          file=sys.stderr)
    for k in cell.kinds:
        done = [q for q in queries if q.kind == k and q.error is None]
        if done:
            lat = sorted(q.latency_s * 1e3 for q in done)
            plan_ms = sorted(q.plan_s * 1e3 for q in done)[len(done) // 2]
            first = " ".join(f"{q.latency_s * 1e3:.3f}" for q in done[:3])
            print(f"portbench: {k} {len(lat)} queries, ms min {lat[0]:.3f} median "
                  f"{lat[len(lat) // 2]:.3f} max {lat[-1]:.3f}, first {first}; "
                  f"plan built in {plan_ms:.3f}", file=sys.stderr)
    for q in queries:
        if q.error is not None:
            print(f"portbench: query {q.kind} {q.params} failed: {q.error}", file=sys.stderr)
            break


class GcPauses:
    """The collector's full (generation 2) collections during the window:
    how many, and their longest and total pause."""

    def __init__(self):
        self.count, self.longest, self.total, self._t0 = 0, 0.0, 0.0, 0.0

    def __call__(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            pause = time.perf_counter() - self._t0
            self.count, self.total = self.count + 1, self.total + pause
            self.longest = max(self.longest, pause)

    def __str__(self):
        return (f"gc gen2 {self.count} collections, longest {self.longest * 1e3:.1f} ms, "
                f"total {self.total * 1e3:.1f} ms")


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__(f"modules a run may not load were loaded: {', '.join(found)}")
        self.found = found


def check_answers(cell: Cell, host, queries: List[Query], device):
    """Every answer the window returned against the reference's answer to
    the same query over the same columns, each parameter set worked out once
    in the precision the configuration states; returns each number
    compared with its limit, as the configuration states them."""
    data = {t: {c: torch.from_numpy(a).to(device) for c, a in cols.items()} for t, cols in host.items()}
    memo: dict = {}
    want: Dict[str, list] = {}
    mismatched, gap, has_double = 0, 0.0, False
    for q in queries:
        if q.answer is None:
            continue
        key = q.kind + params.key(q.params)
        if key not in want:
            want[key] = cell.references[q.kind].answer(data, q.params, "exact", memo)
        m, g = compare.compare(q.answer, want[key])
        mismatched += m
        gap = max(gap, g)
        has_double |= any(c[1] == "double" for c in want[key])
    del data, memo
    limits = cell.config["limits"]
    checks = {"mismatched_cells": {"value": mismatched, "limit": limits["mismatched_cells"]}}
    if has_double:
        checks["double_rel_gap"] = {"value": gap, "limit": limits["double_rel_gap"]}
    checks["unanswered"] = {"value": sum(q.answer is None for q in queries),
                            "limit": limits["unanswered"]}
    return checks


def _start_profiler(on_gpu: bool, stretch: int, on_trace_ready):
    """A profiler that lets ``PROFILER_WARMUP`` queries pass, records the
    next ``stretch`` and hands them to ``on_trace_ready``; one ``step()`` a
    query."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu else [])
    prof = profile(activities=activities, on_trace_ready=on_trace_ready,
                   schedule=schedule(wait=0, warmup=PROFILER_WARMUP, active=stretch, repeat=1))
    prof.start()
    return prof


def _read_profile(prof, k2_launches) -> Optional[trace_read.Profile]:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_read.load(path, k2_launches)
    finally:
        os.unlink(path)


def power_limit_w() -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it (None without it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
