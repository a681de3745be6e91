"""The multi-rank path (``portbench/mesh.py``) on the CPU: a Q3 cell over 4
gloo ranks reads correct with every rank in step; a query that raises on
rank 1 alone ends the run with no result inside the process group's 30 s
timeout; the dbgen chunks of every generated table are disjoint and make up
the whole; and a configuration without a ``mesh`` never reaches the
launcher, starts no process and joins no process group.  On the card
(``gpu``): the Q3 cell at SF 1 with 4 gloo ranks sharing the card, and over
NCCL, one rank a card, where the host has 4 cards.

The cells of these tests are in ``portbench/tests/cells`` (``q3-mesh4`` and
``q3-rank1-raises``, configuration ``tpch-mesh4-test``: SF 0.01, 2^12-row
shards, 4 gloo ranks, every table replicated), not in ``BENCHMARK.json``."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from portbench_testing import SF

from portbench import datagen, harness
from portbench.columns.orders_text import o_comment

ROOT = harness.ROOT
CELLS = os.path.join(ROOT, "portbench", "tests", "cells")
RANKS = 4
TIMEOUT_S = 30  # the test configuration's ``mesh.timeout_s``


def rehearse(cell, seed, seconds, timeout, *more):
    t0 = time.monotonic()
    done = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "rehearse.py"), "--folder", CELLS,
         "--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
         "--scale-factor", str(SF), "--tile-rows", str(1 << 12), *more],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
    )
    return done, time.monotonic() - t0


def ranks_alive(seed):
    """Rank processes of the run with ``seed`` that are still there."""
    mark = f'"seed": {seed},'
    alive = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except OSError:
            continue
        if "mesh.py" in cmd and mark in cmd:
            alive.append(int(pid))
    return alive


def test_q3_over_four_gloo_ranks():
    seed = 2**31 + 4101
    done, _ = rehearse("q3-mesh4", seed, 3, 55)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 2
    assert line["attempted_by_rank"] == [line["attempted"]] * RANKS
    assert line["device"]["count"] == RANKS
    assert len(line["device"]["memory_peak_bytes_by_rank"]) == RANKS
    assert set(line["metrics"]) == {"query_ms_geomean", "query_ms_p95", "rows_per_s", "setup_s"}
    checks = done.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [c.split()[1] for c in checks] == list(line["checks"])
    assert not ranks_alive(seed)


def test_a_query_that_raises_on_rank_1_alone_ends_the_run():
    seed = 2**31 + 4102
    done, took = rehearse("q3-rank1-raises", seed, 3, 58)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    said = [line for line in done.stderr.splitlines() if line.startswith("portbench:")]
    assert said and "no result" in said[-1], done.stderr[-3000:]
    failed = "\n".join(said)
    assert "rank 1" in failed and "AttributeError" in failed, failed
    assert took < TIMEOUT_S + 25, took
    assert not ranks_alive(seed)


@pytest.fixture
def small_pool(monkeypatch):
    monkeypatch.setattr(o_comment, "N_COMMENTS", 20_000)  # more than SF 0.01's 15 000 orders
    monkeypatch.setattr(o_comment, "_MADE", {})


def test_chunks_are_disjoint_and_make_up_the_whole(small_pool):
    tables = ("lineitem", "orders", "orders_text", "customer")
    wanted = {t: datagen.table_columns(t) for t in tables}
    whole = datagen.generate_host(SF, 2**33 + 5, wanted, "cpu")
    chunks = [datagen.generate_host(SF, 2**33 + 5, wanted, "cpu", (r, RANKS, tables))
              for r in range(RANKS)]
    for t in tables:
        n = len(next(iter(whole[t].values())))
        for c, v in whole[t].items():
            assert np.array_equal(np.concatenate([ch[t][c] for ch in chunks]), v), (t, c)
        if t != "lineitem":  # dbgen's chunks: n // ranks rows, the last also the rest
            sizes = [len(ch[t][wanted[t][0]]) for ch in chunks]
            assert sizes == [n // RANKS] * (RANKS - 1) + [n - (RANKS - 1) * (n // RANKS)], sizes
    for ch in chunks:
        keys = ch["orders"]["o_orderkey"]
        assert np.array_equal(np.unique(ch["lineitem"]["l_orderkey"]), keys)
        assert np.array_equal(ch["orders_text"]["o_custkey"], ch["orders"]["o_custkey"])


NO_MESH = """
import json, multiprocessing.process, subprocess, sys
sys.path[0] = {root!r}
import torch.distributed as dist

def refuse(*args, **kwargs):
    raise AssertionError("a configuration without a mesh started a rank or a group")

started, popen = [], subprocess.Popen.__init__

def recording(self, args, *rest, **kwargs):
    started.append(str(args))  # the program may build its libraries (g++, nvcc)
    popen(self, args, *rest, **kwargs)

subprocess.Popen.__init__ = recording
multiprocessing.process.BaseProcess.start = refuse
dist.init_process_group = refuse
dist.new_group = refuse
from portbench import harness
out = harness.run_cell("sf1-q1-q6", 5, 0.5, False, device="cpu", scale_factor={sf},
                       tile_rows=1 << 14)
print(json.dumps({{"correct": out["correct"], "count": out["device"]["count"],
                   "mesh": "portbench.mesh" in sys.modules,
                   "initialized": dist.is_initialized(),
                   "pythons": [a for a in started if sys.executable in a or "mesh.py" in a]}}))
"""


def test_a_configuration_without_mesh_stays_in_one_process():
    assert harness.Cell("sf1-q1-q6").mesh is None
    done = subprocess.run([sys.executable, "-c", NO_MESH.format(root=ROOT, sf=SF)],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "count": 1, "mesh": False, "initialized": False,
                   "pythons": []}


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_q3_at_sf1_across_ranks_on_the_card(backend):
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < (RANKS if backend == "nccl" else 1):
        pytest.skip(f"{backend} over {RANKS} ranks needs more CUDA devices than {cards}")
    # the later arguments win: SF 1, 2^21-row shards (one tile), 4 ranks of the backend
    done, _ = rehearse("q3-mesh4", 2**31 + 4103, 5, 600, "--device", "cuda", "--ranks",
                       str(RANKS), "--backend", backend, "--scale-factor", "1",
                       "--tile-rows", str(1 << 21))
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu", line["checks"]
    assert line["device"]["count"] == RANKS
    assert line["attempted_by_rank"] == [line["attempted"]] * RANKS
    peaks = line["device"]["memory_peak_bytes_by_rank"]
    assert len(peaks) == RANKS and min(peaks) > 0
    assert line["device"]["memory_peak_bytes"] == max(peaks)
