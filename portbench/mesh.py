"""One cell across the cards of a host: one process a rank, one rank a card.

A configuration with ``"mesh": {"ranks": N, "backend": "nccl" | "gloo"}``
(``"timeout_s"`` beside them bounds every collective; 300 s if unstated) runs
here; one without runs in ``run.py``'s process alone, and never reaches this
module.  ``launch`` builds the kernels once, then starts N processes of this
file on a free local TCP port.  Rank r takes card r (gloo ranks on a host with
fewer cards share them, as a rehearsal) before it touches CUDA, joins one
``torch.distributed`` process group with the stated backend, and runs
``harness.run_cell`` through a ``Rank``: the program's ``DistributedExecutor``
over the rank's tables (``placement``: each table replicated, or the rank's
dbgen chunk), each tile's shard of ``tile_rows`` rows on the rank's card.

Every rank draws the same queries from the seed.  Before each query the
ranks agree, over a gloo group of the harness's own, whether to go on (rank
0 decides by its clock) and whether the last query failed: a query that
raised on every rank alike counts as failed and the window goes on; one that
raised on some ranks only, or differently, ends the run.  Rank 0's clock
times each query, and the set-up from the launcher's start to the barrier
that opens the window.  After the window every rank sends rank 0 a digest of
each answer, its memory peaks and its device's busy seconds; rank 0 frees the
program's state, makes the whole data from the seed, runs the reference and
prints the result, which the launcher prints again as its own last line.
If a rank fails, the launcher stops the others, prints no result, names the
rank and its last words on standard error, and exits non-zero.

    python3 portbench/mesh.py '<job JSON>'    # one rank; ``launch`` starts these
"""

from __future__ import annotations

import collections
import ctypes
import datetime
import functools
import hashlib
import itertools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":  # the repo root, not this folder, heads the path
    sys.path[0] = ROOT

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from portbench import datagen, harness  # noqa: E402

DEFAULT_TIMEOUT_S = 300.0
STOP_GRACE_S = 10.0  # a rank stopped by the launcher is killed after this
SETTLE_S = 5.0  # after a rank fails, the others may end by themselves this long


def boottime() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


class RanksDisagree(RuntimeError):
    """A query raised on some ranks only, or not alike on all."""


# ---------------------------------------------------------------------------
# The launcher


def launch(workload: str, seed: int, seconds: float, trace: bool, mesh: dict,
           device: str = "cuda", scale_factor: Optional[float] = None,
           tile_rows: Optional[int] = None, folder: str = HERE) -> int:
    """Run one cell across ``mesh["ranks"]`` processes of this host and
    return the exit code; on success the result is the last line of
    standard output and the checks the last lines of standard error."""
    from portbench.run import report

    ranks, backend = int(mesh["ranks"]), mesh["backend"]
    if device == "cuda" and backend == "nccl" and torch.cuda.device_count() < ranks:
        print(f"portbench: {ranks} NCCL ranks need {ranks} CUDA devices, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    job = dict(workload=workload, seed=seed, seconds=seconds, trace=trace, ranks=ranks,
               backend=backend, timeout_s=float(mesh.get("timeout_s", DEFAULT_TIMEOUT_S)),
               device=device, scale_factor=scale_factor, tile_rows=tile_rows, folder=folder,
               port=free_port(), launcher_pid=os.getpid(),
               launched_at=boottime() - harness.process_age_s())
    build_kernels(device)
    procs, tails, readers = [], [], []
    try:
        for rank in range(ranks):
            p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                  json.dumps(dict(job, rank=rank))],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 cwd=ROOT)
            procs.append(p)
            tails.append((collections.deque(maxlen=1), collections.deque(maxlen=1)))
            for stream, tail in ((p.stderr, tails[rank][0]), (p.stdout, tails[rank][1])):
                t = threading.Thread(target=relay, args=(stream, rank, tail), daemon=True)
                t.start()
                readers.append(t)
        failed = watch(procs, min(SETTLE_S, job["timeout_s"]))
    finally:
        stopped = stop(procs)
        for t in readers:
            t.join(timeout=STOP_GRACE_S)
    if failed:
        for rank, p in enumerate(procs):
            if rank in stopped or p.returncode == 0:
                continue
            how = f"signal {-p.returncode}" if p.returncode < 0 else f"exit code {p.returncode}"
            why = tails[rank][0][-1] if tails[rank][0] else "nothing on standard error"
            print(f"portbench: rank {rank} of {ranks} failed ({how}): {why}", file=sys.stderr)
        print(f"portbench: no result; the launcher stopped rank(s) {sorted(stopped)}",
              file=sys.stderr)
        return 1
    line = tails[0][1][-1] if tails[0][1] else ""
    try:
        out = json.loads(line)
    except json.JSONDecodeError:
        print(f"portbench: rank 0 printed no result (its last line: {line[:200]!r})",
              file=sys.stderr)
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: {harness.ForbiddenModules(found)}", file=sys.stderr)
        return 3
    report(out)
    return 0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_kernels(device: str) -> None:
    """Build the program's libraries here, once, so that every rank only
    loads them from the checkout's build directory."""
    from velox_tpu_torch import native

    native.available()
    if device == "cuda":
        from velox_tpu_torch.ops import cuda_build

        cuda_build.build()


def relay(stream, rank: int, tail) -> None:
    """Copy a rank's lines to standard error, marked with the rank, keeping
    the last few."""
    for line in stream:
        line = line.rstrip("\n")
        tail.append(line)
        print(f"[rank {rank}] {line}", file=sys.stderr, flush=True)
    stream.close()


def watch(procs, settle_s: float) -> bool:
    """Wait until every rank has ended, or one has failed; after a failure,
    wait ``settle_s`` more for the others to end and say why by themselves.
    Returns whether a rank failed."""
    failed_at = None
    while True:
        codes = [p.poll() for p in procs]
        if failed_at is None and any(code not in (None, 0) for code in codes):
            failed_at = time.monotonic()
        if None not in codes or (failed_at is not None
                                 and time.monotonic() - failed_at > settle_s):
            return failed_at is not None
        time.sleep(0.05)


def stop(procs) -> List[int]:
    """End every rank still running, wait for each, and return those it
    ended."""
    stopped = [rank for rank, p in enumerate(procs) if p.poll() is None]
    for rank in stopped:
        procs[rank].terminate()
    deadline = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    return stopped


# ---------------------------------------------------------------------------
# A rank


def digest(answer) -> Optional[str]:
    return None if answer is None else hashlib.sha256(repr(answer).encode()).hexdigest()


class Rank:
    """One rank of a multi-rank run, in the place of ``harness.OneProcess``:
    the same questions, answered across the ranks over ``ctrl``, a gloo
    group beside the program's."""

    def __init__(self, cell, seconds: float, device, *, mesh, ctrl, launched_at: float):
        self.cell, self.seconds, self.device = cell, seconds, device
        self.mesh, self.ctrl, self.launched_at = mesh, ctrl, launched_at
        self.rank, self.ranks = mesh.rank, mesh.size
        unknown = set(cell.placement.values()) - {"replicated", "chunk"}
        if unknown:
            raise ValueError(f"placement {sorted(unknown)}: a table is 'replicated' or 'chunk'")
        self.chunked = sorted(t for t, how in cell.placement.items() if how == "chunk")

    def executor(self, plan):
        from velox_tpu_torch.parallel.runner import DistributedExecutor

        return DistributedExecutor(plan, self.mesh, per_device_rows=self.cell.tile_rows)

    def host(self, seed: int, data_device):
        return datagen.generate_host(self.cell.sf, seed, self.cell.columns(), data_device,
                                     (self.rank, self.ranks, self.chunked))

    def whole(self, host, seed: int, data_device):
        if not self.chunked:
            return host
        return datagen.generate_host(self.cell.sf, seed, self.cell.columns(), data_device)

    def window_opens(self) -> float:
        dist.barrier(group=self.ctrl)
        return boottime() - self.launched_at

    def rows(self, tables):
        """Each base row once: a replicated table's on rank 0, a chunked
        table's on the rank that holds it."""
        kinds = list(self.cell.kinds)
        own = torch.tensor(
            [sum(tables[k][t].num_rows for t in self.cell.kinds[k].TABLES
                 if t in self.chunked or self.rank == 0) for k in kinds], dtype=torch.int64)
        dist.all_reduce(own, group=self.ctrl)
        return dict(zip(kinds, own.tolist()))

    def go(self, elapsed_s: float, queries) -> bool:
        error = queries[-1].error if queries else None
        flags = torch.tensor([int(self.rank == 0 and elapsed_s < self.seconds),
                              int(error is not None)], dtype=torch.int64)
        try:
            dist.all_reduce(flags, group=self.ctrl)
        except RuntimeError as e:
            if error is None:
                raise
            raise RanksDisagree(f"query {len(queries) - 1} ({queries[-1].kind}) raised here "
                                f"({error}), and the ranks did not agree in time: {e}") from e
        if flags[1]:
            errors: List[Optional[str]] = [None] * self.ranks
            dist.all_gather_object(errors, error, group=self.ctrl)
            if len(set(errors)) > 1:
                raise RanksDisagree(
                    f"query {len(queries) - 1} ({queries[-1].kind}) did not fail alike on every "
                    f"rank: " + "; ".join(f"rank {r}: {e}" for r, e in enumerate(errors)))
        return bool(flags[0])

    def gather(self, setup_peak, window_peak, queries, profile) -> Optional[dict]:
        mine = {"peaks": (setup_peak, window_peak), "digests": [digest(q.answer) for q in queries],
                "busy_s": profile.busy_s() if profile is not None else None}
        got = [None] * self.ranks if self.rank == 0 else None
        dist.gather_object(mine, got, dst=0, group=self.ctrl)
        if self.rank != 0:
            return None
        first = got[0]["digests"]
        mismatched = sum(a != b for r in got[1:]
                         for a, b in itertools.zip_longest(first, r["digests"], fillvalue="none"))
        window = [r["peaks"][1] for r in got]
        by_rank = [None if w is None else max(r["peaks"]) for r, w in zip(got, window)]
        busy = [r["busy_s"] for r in got if r["busy_s"] is not None]
        return {"window_peak": None if None in window else max(window),
                "memory_peak": None if None in by_rank else max(by_rank), "by_rank": by_rank,
                "attempted": [len(r["digests"]) for r in got], "mismatched": mismatched,
                "busy_s": sum(busy) / len(busy) if busy else None}


def die_with_launcher(launcher_pid: int) -> None:
    """Have the kernel kill this rank when the launcher ends (Linux
    ``PR_SET_PDEATHSIG``), so that no rank outlives a launcher that was
    killed."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != launcher_pid:
        os._exit(1)


def rank_main(job: dict) -> int:
    die_with_launcher(job["launcher_pid"])
    rank, ranks, backend = job["rank"], job["ranks"], job["backend"]
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    on_gpu = job["device"] == "cuda"
    if on_gpu:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    from velox_tpu_torch.parallel.distributed import make_mesh

    timeout = datetime.timedelta(seconds=job["timeout_s"])
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{job['port']}", rank=rank,
                            world_size=ranks, timeout=timeout)
    ctrl = dist.new_group(backend="gloo", timeout=timeout)
    mesh = make_mesh(ranks, backend=backend, device=None if on_gpu else job["device"])
    place = functools.partial(Rank, mesh=mesh, ctrl=ctrl, launched_at=job["launched_at"])
    out = harness.run_cell(job["workload"], job["seed"], job["seconds"], job["trace"],
                           device=None if on_gpu else job["device"],
                           scale_factor=job["scale_factor"], tile_rows=job["tile_rows"],
                           folder=job["folder"], place=place)
    if out is not None:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    job = json.loads(sys.argv[1])
    try:
        code = rank_main(job)
    except Exception as e:  # the launcher reads the last line and stops every rank
        import traceback

        traceback.print_exc()
        code = 3 if isinstance(e, harness.ForbiddenModules) else 1
        said = " ".join(str(e).split())[:1000]
        print(f"portbench: rank {job['rank']} failed: {type(e).__name__}: {said}",
              file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(code)  # no process group teardown: the other ranks may be gone
    sys.exit(code)
