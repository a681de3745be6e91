"""A world of ranks on one host: the launcher the distributed tests and
``chip_smoke.py`` share.

``World(size, backend, device)`` starts ``size`` processes with the ``spawn``
start method; each joins one ``torch.distributed`` process group
(``init_method="file://..."`` in a temporary directory, a 60 s timeout on
every collective), makes its ``Mesh`` and waits for tasks.  ``run(target,
*args)`` sends the same task to every rank and returns rank 0's result.  A
task is a function named by its module path inside this package
(``"velox_tpu_torch.testing.dist_tasks:run_case"``), called as
``fn(mesh, *args, **kwargs)`` on every rank; arguments and results cross as
pickles, so a plan crosses as a description (a case name, a query number and
a table handle), never as data.

Every wait has a timeout.  When a rank fails, dies or does not answer in
time, the whole world is killed and ``run`` raises, so that a hung collective
fails its caller instead of blocking it; the next ``run`` starts a new world.

Tables cross once, as files: ``share_tables`` writes each column as ``.npy``
(and each string dictionary as UTF-8 bytes and offsets) under the world's
temporary directory, and ``load_shared_tables`` in a rank maps the columns
(``mmap_mode="r"``), so four ranks do not generate four copies.
"""

from __future__ import annotations

import importlib
import json
import multiprocessing
import multiprocessing.connection
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Dict, Optional, Sequence

import numpy as np

from ..io.table import Table

# seconds every collective of a rank's process group may wait
COLLECTIVE_TIMEOUT_S = 60.0
# seconds a world may take to start (every rank imported, the group joined)
START_TIMEOUT_S = 120.0


class WorldError(RuntimeError):
    """A rank failed, died or did not answer in time; the world was killed."""


class World:
    """``size`` rank processes of one process group on this host.

    ``backend`` is the group's backend ("gloo" or "nccl", always explicit);
    ``device`` the device of every rank ("cpu", or "cuda" for the card the
    ranks share).  ``threads`` is each rank's ``torch.set_num_threads``."""

    def __init__(self, size: int, backend: str, device: str, threads: int = 1,
                 task_timeout_s: float = 300.0):
        self.size = size
        self.backend = backend
        self.device = device
        self.threads = threads
        self.task_timeout_s = task_timeout_s
        self._dir = tempfile.mkdtemp(prefix="velox_world_")
        self._procs = []
        self._conns = []
        self._generation = 0
        self._shared = 0
        self._ready = False

    # ---- lifetime -------------------------------------------------------
    def start(self) -> None:
        """Start the ranks and wait until every one has joined the group."""
        self.launch()
        self._wait_ready()

    def _wait_ready(self) -> None:
        if not self._ready:
            self._collect(START_TIMEOUT_S, "start")
            self._ready = True

    def launch(self) -> None:
        """Start the ranks without waiting for them (the first ``run``
        waits), so that the caller's own work overlaps their start."""
        if self._procs:
            return
        self._ready = False
        ctx = multiprocessing.get_context("spawn")
        self._generation += 1
        init_file = os.path.join(self._dir, f"init_{self._generation}")
        for rank in range(self.size):
            parent, child = ctx.Pipe()
            p = ctx.Process(
                target=_rank_main,
                args=(rank, self.size, init_file, self.backend, self.device, self.threads, child),
                daemon=True,
            )
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)

    def kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        for c in self._conns:
            c.close()
        self._procs, self._conns = [], []

    def close(self) -> None:
        """Stop every rank (politely, then by force) and remove the
        temporary directory."""
        for c in self._conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
        deadline = time.monotonic() + 20
        for p in self._procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
        self.kill()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "World":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- tasks ----------------------------------------------------------
    def run(self, target: str, *args, timeout: Optional[float] = None, **kwargs):
        """Run ``target`` on every rank; rank 0's result.  Raises WorldError
        (after killing the world) when a rank fails or the timeout passes."""
        return self.submit(target, *args, **kwargs).result(timeout)

    def submit(self, target: str, *args, **kwargs) -> "_Task":
        """Send ``target`` to every rank without waiting: ``.result()`` on
        the returned handle waits (the caller works meanwhile)."""
        if not target.startswith("velox_tpu_torch."):
            raise ValueError(f"a rank's task lives in velox_tpu_torch, not {target!r}")
        self.launch()  # a rank reads the task once it has joined the group
        for c in self._conns:
            c.send((target, args, kwargs))
        return _Task(self, target)

    def _collect(self, timeout: float, what: str):
        deadline = time.monotonic() + timeout
        results = [None] * self.size
        waiting = dict(enumerate(self._conns))
        while waiting:
            left = deadline - time.monotonic()
            ready = multiprocessing.connection.wait(list(waiting.values()), timeout=max(left, 0))
            if not ready:
                self.kill()
                raise WorldError(
                    f"{what}: ranks {sorted(waiting)} did not answer within {timeout:.0f} s; "
                    "the world was killed"
                )
            for rank in [r for r, c in waiting.items() if c in ready]:
                try:
                    status, payload = waiting.pop(rank).recv()
                except EOFError:
                    self.kill()
                    raise WorldError(f"{what}: rank {rank} died; the world was killed") from None
                if status != "ok":
                    self.kill()
                    raise WorldError(f"{what}: rank {rank} failed; the world was killed\n{payload}")
                results[rank] = payload
        return results

    # ---- tables ---------------------------------------------------------
    def share_tables(self, tables: Dict[str, Table]) -> str:
        """Write ``tables`` once under the world's directory; the handle to
        pass to a task (``load_shared_tables``)."""
        self._shared += 1
        root = os.path.join(self._dir, f"tables_{self._shared}")
        write_tables(tables, root)
        return root


class _Task:
    def __init__(self, world: World, target: str):
        self._world, self._target = world, target

    def result(self, timeout: Optional[float] = None):
        world = self._world
        world._wait_ready()
        return world._collect(timeout or world.task_timeout_s, self._target)[0]


def write_tables(tables: Dict[str, Table], root: str) -> None:
    """Each column as ``.npy``, each string dictionary as UTF-8 bytes and
    character offsets, and a JSON manifest of the schemas."""
    os.makedirs(root, exist_ok=True)
    manifest = {}
    for tname, t in tables.items():
        d = os.path.join(root, tname)
        os.makedirs(d, exist_ok=True)
        cols = []
        for i, (name, dtype) in enumerate(zip(t.schema.names, t.schema.types)):
            if dtype.is_complex:
                raise NotImplementedError(f"sharing the complex-typed column {tname}.{name}")
            np.save(os.path.join(d, f"c{i}.npy"), np.asarray(t.columns[name]))
            if name in t.validities:
                np.save(os.path.join(d, f"v{i}.npy"), np.asarray(t.validities[name], bool))
            if name in t.string_tables:
                values = t.string_tables[name].values()
                text = "".join(values)
                offsets = np.cumsum([0] + [len(v) for v in values], dtype=np.int64)
                np.save(os.path.join(d, f"s{i}.npy"), np.frombuffer(text.encode("utf-8"), np.uint8))
                np.save(os.path.join(d, f"o{i}.npy"), offsets)
            cols.append(dict(name=name, type=str(dtype), validity=name in t.validities,
                             strings=name in t.string_tables))
        manifest[tname] = cols
    with open(os.path.join(root, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)


def load_shared_tables(root: str, columns: Optional[Dict[str, Sequence[str]]] = None
                       ) -> Dict[str, Table]:
    """The tables ``share_tables`` wrote, their columns memory-mapped; only
    ``columns`` ({table: column names}) when given, so that a query reads
    only its own string dictionaries (``o_comment`` is 15 M strings at SF 10)."""
    from ..dtypes import RowType
    from ..vector.string_table import StringTable
    from . import parse_type

    with open(os.path.join(root, "manifest.json")) as fh:
        manifest = json.load(fh)
    out = {}
    for tname, all_cols in manifest.items():
        if columns is not None and tname not in columns:
            continue
        d = os.path.join(root, tname)
        keep = None if columns is None else set(columns[tname])
        cols = [(i, c) for i, c in enumerate(all_cols) if keep is None or c["name"] in keep]
        columns_, validities, strings = {}, {}, {}
        for i, c in cols:
            columns_[c["name"]] = np.load(os.path.join(d, f"c{i}.npy"), mmap_mode="r")
            if c["validity"]:
                validities[c["name"]] = np.load(os.path.join(d, f"v{i}.npy"), mmap_mode="r")
            if c["strings"]:
                text = np.load(os.path.join(d, f"s{i}.npy")).tobytes().decode("utf-8")
                off = np.load(os.path.join(d, f"o{i}.npy")).tolist()
                strings[c["name"]] = StringTable.from_values(
                    [text[a:b] for a, b in zip(off[:-1], off[1:])]
                )
        schema = RowType([c["name"] for _, c in cols], [parse_type(c["type"]) for _, c in cols])
        out[tname] = Table(schema, columns_, strings, validities)
    return out


def _rank_main(rank, size, init_file, backend, device, threads, conn) -> None:
    """A rank: join the group, make the Mesh, run tasks until told to stop."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank, world_size=size,
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S),
        )
        from ..parallel.distributed import make_mesh

        mesh = make_mesh(size, backend=backend, device=device)
        _check_no_jax()
        conn.send(("ok", None))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            target, args, kwargs = msg
            try:
                module, name = target.split(":")
                fn = getattr(importlib.import_module(module), name)
                result = fn(mesh, *args, **kwargs)
                _check_no_jax()
                conn.send(("ok", result if rank == 0 else None))
            except Exception:
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _check_no_jax() -> None:
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "velox_tpu" or m.startswith("velox_tpu."))
    if bad:
        raise RuntimeError(f"a rank imported the JAX package or jax: {bad[:5]}")
