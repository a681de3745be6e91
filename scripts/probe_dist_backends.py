#!/usr/bin/env python3
"""Which torch.distributed routes move CUDA tensors between ranks that share
one card.

    python3 scripts/probe_dist_backends.py

For each route (NCCL with 2 ranks on cuda:0, gloo with 2 ranks on cuda:0,
NCCL with 1 rank) it starts the ranks (spawn), joins them in a process group
with an explicit backend and a 30 s timeout, and runs one
``all_to_all_single`` and one ``all_reduce`` on CUDA tensors.  It prints one
JSON line a route: what each rank reported (``ok`` with the exchanged
values, or the exception).  A rank that does not answer in 90 s is killed
and reported as ``timeout``.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import queue
import sys
import tempfile


def _rank(rank: int, size: int, backend: str, init_file: str, out) -> None:
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=size, timeout=timedelta(seconds=30))
        send = torch.arange(size * 2, dtype=torch.int64, device="cuda") + 100 * rank
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        total = torch.ones(1, device="cuda") * (rank + 1)
        dist.all_reduce(total)
        torch.cuda.synchronize()
        out.put((rank, "ok", dict(all_to_all=recv.tolist(), all_reduce=float(total))))
        dist.destroy_process_group()
    except Exception as exc:  # the outcome is what this probe reports
        out.put((rank, "error", f"{type(exc).__name__}: {exc}"[:600]))


def probe(backend: str, size: int) -> dict:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init_file = os.path.join(tempfile.mkdtemp(prefix="probe_dist_"), "init")
    procs = [ctx.Process(target=_rank, args=(r, size, backend, init_file, out), daemon=True)
             for r in range(size)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < size:
            rank, status, detail = out.get(timeout=90)
            got[rank] = dict(status=status, detail=detail)
    except queue.Empty:
        pass
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join()
    ranks = [got.get(r, dict(status="timeout", detail=None)) for r in range(size)]
    return dict(backend=backend, ranks_on_one_card=size, tensors="cuda", ranks=ranks)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_dist_backends: no CUDA device", file=sys.stderr)
        return 2
    for backend, size in (("nccl", 2), ("gloo", 2), ("nccl", 1)):
        print(json.dumps(probe(backend, size)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
