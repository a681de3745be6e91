#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (velox_tpu_torch).

    python3 chip_smoke.py [--sf 10] [--tile-rows 16777216] [--runs 5] [--ptxas]

Needs one CUDA device and nvcc; exits non-zero without them.  The TPC-H
generator seeds every column from its table, name and scale factor, so the
data is the same in every run.  The script

1. prints the device (``torch.cuda`` name, ``nvidia-smi`` name and power limit);
2. builds the CUDA kernels from ``velox_tpu_torch/csrc`` (seconds printed);
3. holds each kernel against its plain PyTorch version at the shapes the
   queries give it (one tile of SF-``sf`` ``lineitem``), by exact equality
   (the sums are integer; addition wraps and is associative), and times
   kernel, plain version and, where one PyTorch call computes the same, that
   call, with CUDA events (median of ``--runs`` after a warm-up, the launches
   queued behind a short device-side sleep so that no host time is counted);
   then runs the edge cases of the two grouped sums (ragged lengths, unaligned
   slices, all rows dead, 1 and 64 groups, the table limit, every number of
   table copies) against the plain versions, and times both kernels on one
   tile with 1, 4, 12 and 64 live groups;
4. sets every kernel's launch count to 0 and drives the main path once:
   TPC-H Q6 and Q1 at SF ``sf`` through ``LocalExecutor`` over device-resident
   tiles, row-exact against the numpy oracle, and the two ops the executor
   does not call (``selective_sum``, ``grouped_int64_sums``) through their own
   entry points over the same tiles, checked against the same answers; then
   reads the counts and fails if any kernel was not launched;
5. times Q6 and Q1 (median of ``--runs``), with the device-busy share from
   ``torch.profiler``;
6. times the primitives the sort-mode paths are made of (``torch.sort``,
   ``index_select`` through its permutation, ``cumsum``, ``cummax`` of 2^24
   int64), each beside its byte bound;
   ``ops/segmented.py last_flagged``, which computes on the sort-mode paths
   what the JAX package computes with ``cummax`` / ``cummin``, is timed
   beside ``cummax`` on the same input;
7. runs TPC-H Q3 and Q13 at SF ``sf`` through
   ``LocalExecutor``: joins with a unique build side, sort-mode grouping with
   the device-resident carry, the device TopN; row-exact against the numpy
   oracle, then timed like Q6 and Q1.  ``engine_ms`` is one run of the probe
   pipeline over device-resident tiles; the build sides run when the executor
   is constructed and their time is printed as ``build_s``.  Q13 runs once
   more with tiles of 2^22 rows, for its rows only, so that its build side's
   carry merge is held against the oracle too.  These paths launch none of
   the hand-written kernels (the JAX package has no Pallas kernel on them);
8. runs the other eighteen TPC-H plans (``tpch_plans``: one line each) and
   all 22 SQL texts through the SQL front end (``tpch_sql``: one line each;
   expansion joins, scalar subqueries, filtered LEFT and semi / anti joins,
   distinct counts; the texts of ``SQL_AT_SF1`` at SF 1 when ``--sf`` is
   larger), each row-exact against the oracle, with the build time,
   every expansion's output bucket and the device's peak memory, and timed:
   ``query_ms`` is the whole query from host tables (executor construction,
   which runs every build side and barrier, and the run; what ``run_sql``
   costs), median of 3 (one run past ``LONG_QUERY_S``), with its device
   time from ``torch.profiler``; a plan's line also has ``engine_ms`` of its
   last pipeline over
   device-resident tiles, median of ``--runs``, as for Q3.  The tables are
   generated once, with every column any query reads.  A plan whose
   aggregation takes the piece path launches ``grouped_piece_sums`` as Q1
   does (``k2_launches``);
9. prints a ``summary`` line (every query's time in one place), the
   ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.

Every phase prints one JSON line; any failure ends the run with a traceback
and a non-zero exit code.  ``bound_ms`` is bytes moved (each input read once,
each output written once; of selective_sum's value column only the 32-byte
sectors that hold a passing row, since the others are never asked for) over
the published device-memory rate of the H100 SXM, 3.35 TB/s, or integer
operations over 67 Tops/s (the published non-tensor-core float32 rate, taken
as the integer ALU rate), whichever is larger.  ``kernel_study.py`` beside this
script holds the longer measurements (design variants, cost split, SASS).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
DEVICE = "cuda"  # where the script itself allocates; the port's entry points default to it
WHOLE_RUNS = 3  # whole-query runs from host tables a median is taken of
# a query whose first whole run takes longer is timed by that run alone (no
# more runs, no profiled run): TPC-H Q21's plan at SF 10 took 47 s with an
# H100 (its build side's host merge of about 60 M partial groups), and three
# more runs would be a fifth of the script's time
LONG_QUERY_S = 10.0
# SQL texts whose planner keeps FROM order, so that a join's build side
# repeats its keys and is sorted on the host (an expansion join over up to
# 60 M lineitem rows).  Their hand-built plans run at ``--sf``; the texts run
# at SF 1 when ``--sf`` is larger, to keep the script inside its time.
SQL_AT_SF1 = (3, 5, 7, 8, 10, 13, 18, 21)


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def median_ms(fn, runs: int) -> float:
    """Median CUDA-event time of ``fn`` in ms over ``runs``, after one warm-up.
    Each run is queued behind a device-side sleep of about half a millisecond,
    so the host is ahead of the device and only device time lies between the
    two events.  The sleep is ``torch.cuda._sleep``, a private call that counts
    clock cycles (so its length follows the clock; only that it outlasts the
    host's enqueueing matters); a torch without it raises here."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def measured_bandwidth(runs: int) -> float:
    """Device-memory bytes/s of a large int64 ``sum`` (read once)."""
    import torch

    x = torch.ones((1 << 27,), dtype=torch.int64, device=DEVICE)  # 1 GiB
    ms = median_ms(lambda: x.sum(), runs)
    return x.numel() * 8 / (ms * 1e-3)


def device_busy_ms(fn, top: int = 6):
    """(sum of device kernel time of one ``fn()`` in ms, the ``top`` kernels
    as [name, ms, launches]) from torch.profiler; (None, []) when the
    profiler reports no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side rows only: a CPU operator's row repeats its kernels' time
    kernels = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0
            )
            kernels.append([e.key[:80], us / 1e3, e.count])
    total = sum(k[1] for k in kernels)
    if total <= 0:
        return None, []
    kernels.sort(key=lambda k: -k[1])
    return total, kernels[:top]


def bound(bytes_moved: int, ops: int):
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# the kernels' inputs, taken from the executors' own tiles


def q1_piece_inputs(ex, tile):
    """(cols, gid_live, plans, num_groups, mask, gids) as the executor's tile
    step hands them to grouped_piece_sums (AggExecutor.piece_inputs)."""
    import torch

    from velox_tpu_torch.exec.runner import apply_streaming

    agg = ex.agg_exec
    batch2, _ = apply_streaming(tile, ex.lin.steps)
    mask = batch2.active_mask()
    gids = agg.grouping.group_ids(batch2)
    cols, gid_live = agg.piece_inputs(tile, mask, gids)
    return cols, gid_live, agg._piece_plan[1], agg.num_groups, mask, gids.to(torch.int32)


def q6_selective_inputs(tile):
    """Q6 as selective_sum sees it: int64 copies of the product and the three
    filter columns of one tile, and Q6's bands in the device representation."""
    import torch

    from velox_tpu_torch.connectors.tpch.gen import _days

    def wide(name):
        return tile.column(name).data.to(torch.int64)

    values = wide("l_extendedprice") * wide("l_discount")
    filters = [wide("l_shipdate"), wide("l_discount"), wide("l_quantity")]
    lo = _days("1994-01-01")
    bounds = [(lo, lo + 364), (5, 7), (-(1 << 62), 2399)]
    return values, filters, bounds


Q1_MEASURES = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")


def q1_group_sum_inputs(tile):
    import torch

    return [tile.column(n).data.to(torch.int64) for n in Q1_MEASURES]


# ---------------------------------------------------------------------------


def check_kernels(ex1, tile1, tile6, runs: int):
    """Phase 3: each kernel vs its plain version on one tile; returns the
    per-kernel records (without the main path's launch counts)."""
    import torch

    from velox_tpu_torch.ops.group_piece import (
        grouped_piece_sums,
        grouped_piece_sums_plain,
    )
    from velox_tpu_torch.ops.group_sum import (
        grouped_int64_sums,
        grouped_int64_sums_plain,
    )
    from velox_tpu_torch.ops.selective_sum import selective_sum, selective_sum_plain

    records = []

    def max_abs_err(got, want) -> int:
        err = 0
        for g, w in zip(got, want):
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        return err

    # K1 selective_sum at Q6's shape
    values, filters, bounds = q6_selective_inputs(tile6)
    got = selective_sum(values, filters, bounds)
    want = selective_sum_plain(values, filters, bounds)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    assert err == 0 and int(want[2]) > 0, ("selective_sum disagrees", got, want)
    n = values.shape[0]
    # the kernel reads a value only where the row passes, so of the value
    # column this run's data needs the 32-byte sectors that hold a passing row
    passing = torch.ones((n,), dtype=torch.bool, device=DEVICE)
    for f, (lo, hi) in zip(filters, bounds):
        passing &= (f >= lo) & (f <= hi)
    whole = n - n % 4
    value_bytes = 32 * (int(passing[:whole].view(-1, 4).any(dim=1).sum())
                        + int(passing[whole:].any()))
    k1_bytes = tensor_bytes(*filters) + value_bytes + 24
    b_ms, b_by = bound(k1_bytes, 9 * n)
    records.append(
        dict(
            name="selective_sum", route="cuda",
            source="velox_tpu_torch/csrc/kernels.cu",
            replaces="velox_tpu/ops/pallas_kernels.py:107",
            max_abs_err=err,
            ms=median_ms(lambda: selective_sum(values, filters, bounds), runs),
            plain_ms=median_ms(lambda: selective_sum_plain(values, filters, bounds), runs),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            rows=n, bytes=k1_bytes, value_bytes_needed=value_bytes,
            geometry=None,  # grid-stride, no staged geometry
        )
    )
    del values, filters, passing

    # K2 grouped_piece_sums at Q1's shape
    cols, gid_live, plans, groups, mask, gids = q1_piece_inputs(ex1, tile1)
    got = grouped_piece_sums(cols, gid_live, plans, groups)
    want = grouped_piece_sums_plain(cols, gid_live, plans, groups)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    assert err == 0 and int(want[0].sum()) > 0, ("grouped_piece_sums disagrees", got, want)
    n = gid_live.shape[0]
    live = int((gid_live >= 0).sum())
    ops = live * sum(2 * len(p.factors) + 1 for p in plans)
    moved = tensor_bytes(*cols, gid_live) + 8 * groups * len(plans)
    b_ms, b_by = bound(moved, ops)
    records.append(
        dict(
            name="grouped_piece_sums", route="cuda",
            source="velox_tpu_torch/csrc/grouped_piece_sums.cu",
            replaces="velox_tpu/ops/pallas_group_piece.py:235",
            max_abs_err=err,
            ms=median_ms(lambda: grouped_piece_sums(cols, gid_live, plans, groups), runs),
            plain_ms=median_ms(
                lambda: grouped_piece_sums_plain(cols, gid_live, plans, groups), runs
            ),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            rows=n, bytes=moved, specs=len(plans), groups=groups,
            column_dtypes=[str(c.dtype) for c in cols],
            geometry=grouped_piece_sums.last_geometry.summary(),
        )
    )

    # K3 grouped_int64_sums: G = 12 over int64 copies of Q1's measure columns
    wide = q1_group_sum_inputs(tile1)
    got = grouped_int64_sums(wide, gids, mask, groups)
    want = grouped_int64_sums_plain(wide, gids, mask, groups)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    assert err == 0 and int(want[0].sum()) > 0, ("grouped_int64_sums disagrees", got, want)
    moved = tensor_bytes(*wide, gids, mask) + 8 * groups * len(wide)
    b_ms, b_by = bound(moved, live * len(wide))
    # the yardstick: ONE index_add_ over the pre-stacked (N, 4) matrix, with
    # masked rows pointed at a spare slot; stacking and folding are not timed
    stacked = torch.stack(wide, dim=1)
    index = torch.where(mask, gids.to(torch.int64), torch.full_like(gids, groups, dtype=torch.int64))
    lib = lambda: torch.zeros(  # noqa: E731
        (groups + 1, len(wide)), dtype=torch.int64, device=DEVICE
    ).index_add_(0, index, stacked)
    assert torch.equal(lib()[:groups].t().contiguous(), torch.stack(list(want)))
    records.append(
        dict(
            name="grouped_int64_sums", route="cuda",
            source="velox_tpu_torch/csrc/grouped_int64_sums.cu",
            replaces="velox_tpu/ops/pallas_group_sum.py:139",
            max_abs_err=err,
            ms=median_ms(lambda: grouped_int64_sums(wide, gids, mask, groups), runs),
            plain_ms=median_ms(
                lambda: grouped_int64_sums_plain(wide, gids, mask, groups), runs
            ),
            bound_ms=b_ms, bound_by=b_by, library_ms=median_ms(lib, runs),
            rows=n, bytes=moved, columns=len(wide), groups=groups,
            geometry=grouped_int64_sums.last_geometry.summary(),
        )
    )
    for r in records:
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    return records


def equal_bits(got, want) -> bool:
    import torch

    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def check_edges():
    """The edge cases of the two grouped sums, kernel against plain version by
    exact equality; returns per case what geometry it ran with."""
    import torch

    from velox_tpu_torch.ops.group_piece import grouped_piece_sums, grouped_piece_sums_plain
    from velox_tpu_torch.ops.group_sum import grouped_int64_sums, grouped_int64_sums_plain
    from velox_tpu_torch.testing import kernel_cases

    report = {}
    suites = (
        ("grouped_piece_sums", kernel_cases.piece_cases, kernel_cases.piece_inputs,
         grouped_piece_sums, grouped_piece_sums_plain),
        ("grouped_int64_sums", kernel_cases.group_sum_cases, kernel_cases.group_sum_inputs,
         grouped_int64_sums, grouped_int64_sums_plain),
    )
    for kernel, cases, inputs, fn, plain in suites:
        ran = []
        for case in cases():
            args = inputs(case, DEVICE)
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            assert equal_bits(got, want), (kernel, case["name"], got, want)
            g = fn.last_geometry
            assert case["copies"] in (None, g.lane_copies), (kernel, case["name"], g)
            ran.append([case["name"], g.lane_copies, g.stages, g.chunk_rows,
                        g.head, g.body_rows, g.tail, g.smem_bytes])
        report[kernel] = ran
    return report


def live_group_inputs(n, live_groups: int, dtype):
    """Synthetic group ids: ``live_groups`` groups, uniform, every row live."""
    import numpy as np
    import torch

    rng = np.random.default_rng(live_groups)
    return torch.from_numpy(rng.integers(0, live_groups, n).astype(dtype)).to(DEVICE)


def contention_sweep(ex1, tile1, runs: int):
    """Kernel ms of the two grouped sums on one tile against the number of
    live groups (1, 4, 12, 64; uniform synthetic group ids)."""
    import numpy as np
    import torch

    from velox_tpu_torch.ops.group_piece import grouped_piece_sums, grouped_piece_sums_plain
    from velox_tpu_torch.ops.group_sum import grouped_int64_sums, grouped_int64_sums_plain

    cols, gid_live, plans, _, _, _ = q1_piece_inputs(ex1, tile1)
    wide = q1_group_sum_inputs(tile1)
    n = gid_live.shape[0]
    mask = torch.ones((n,), dtype=torch.bool, device=DEVICE)
    out = {"rows": n, "grouped_piece_sums": {}, "grouped_int64_sums": {}}
    for live in (1, 4, 12, 64):
        groups = max(live, 12)
        gid8 = live_group_inputs(n, live, np.int8)
        assert equal_bits(grouped_piece_sums(cols, gid8, plans, groups),
                          grouped_piece_sums_plain(cols, gid8, plans, groups))
        out["grouped_piece_sums"][str(live)] = median_ms(
            lambda: grouped_piece_sums(cols, gid8, plans, groups), runs)
        gid32 = gid8.to(torch.int32)
        assert equal_bits(grouped_int64_sums(wide, gid32, mask, groups),
                          grouped_int64_sums_plain(wide, gid32, mask, groups))
        out["grouped_int64_sums"][str(live)] = median_ms(
            lambda: grouped_int64_sums(wide, gid32, mask, groups), runs)
    return out


def drive_ops(tiles6, ex1, tiles1, q1_result, q6_exact: int):
    """The two ops the executor does not call, through their own entry points
    over all tiles, held against the queries' answers."""
    import numpy as np
    import torch

    from velox_tpu_torch.ops.group_sum import grouped_int64_sums
    from velox_tpu_torch.ops.selective_sum import selective_sum

    hi = lo = count = 0
    for tile in tiles6:
        h, l, c = selective_sum(*q6_selective_inputs(tile))
        hi, lo, count = hi + int(h), lo + int(l), count + int(c)
    assert hi * (1 << 32) + lo == q6_exact, ("selective_sum vs Q6", hi, lo, q6_exact)

    groups = ex1.agg_exec.num_groups
    sums = torch.zeros((len(Q1_MEASURES), groups), dtype=torch.int64, device=DEVICE)
    for tile in tiles1:
        _, _, _, _, mask, gids = q1_piece_inputs(ex1, tile)
        sums += torch.stack(
            list(grouped_int64_sums(q1_group_sum_inputs(tile), gids, mask, groups))
        )
    sums = sums.cpu().numpy()
    for row, name in ((0, "sum_qty"), (1, "sum_base_price")):
        got = sums[row][sums[row] != 0]
        want = np.sort(np.asarray(q1_result.columns[name], dtype=np.int64))
        assert np.array_equal(np.sort(got), want), (name, got, want)
    return count


class TpchTables:
    """The TPC-H tables at one scale factor, each generated once, on first
    use, with every column any of the 22 queries reads (the generator seeds
    each column from its table, name and scale factor, so a column does not
    depend on which others are generated); a query gets views of its own
    columns."""

    def __init__(self, sf: float):
        from velox_tpu_torch.connectors.tpch.queries import QUERY_COLUMNS

        self.sf = sf
        self.columns = {}
        for cols in QUERY_COLUMNS.values():
            for name, names in cols.items():
                self.columns.setdefault(name, set()).update(names)
        self._tables = {}
        self.generate_s = {}

    def table(self, name: str):
        from velox_tpu_torch.connectors.tpch import SCHEMAS, load_table

        if name not in self._tables:
            t0 = time.perf_counter()
            cols = [c for c in SCHEMAS[name].names if c in self.columns[name]]
            self._tables[name] = load_table(name, self.sf, cols)
            self.generate_s[name] = time.perf_counter() - t0
        return self._tables[name]

    def for_query(self, num: int):
        from velox_tpu_torch.connectors.tpch.queries import QUERY_COLUMNS

        return {name: self.table(name).select(cols) for name, cols in QUERY_COLUMNS[num].items()}


def plan_query(num: int, tables, tile_rows: int, plan=None):
    """Plan the query (or take ``plan``), construct its executor (which runs
    the build sides) and upload the probe side's tiles; returns (executor,
    tiles, plan, report dict)."""
    import torch

    from velox_tpu_torch.connectors.tpch.plans import build_query
    from velox_tpu_torch.exec.runner import LocalExecutor

    t0 = time.perf_counter()
    if plan is None:
        plan = build_query(num, tables, device=DEVICE)  # fragments run on the card
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = LocalExecutor(plan, tile_rows=tile_rows, device=DEVICE)
    torch.cuda.synchronize()
    executor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiles = ex.device_tiles()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    rep = dict(
        rows=ex.source_table.num_rows,
        rows_in={name: t.num_rows for name, t in tables.items()},
        tiles=len(tiles), capacity=ex.capacity, plan_s=plan_s, executor_s=executor_s,
        build_s=ex.build_seconds, upload_s=upload_s, kind=ex.kind,
        pool_reserved_bytes=ex.pool.reserved,
    )
    agg = ex.agg_exec
    if agg is not None:
        rep.update(
            mode=agg.mode, num_groups=agg.num_groups, piece_path=ex.use_piece,
            presorted=bool(getattr(agg.grouping, "presorted", False)),
            keys=[k.name for k in agg.key_infos],
            accumulators=[len(a.acc_ops) for a in agg.aggs],
        )
    return ex, tiles, plan, rep


def prepare_query(num: int, sf: float, tile_rows: int, tables=None):
    """Generate the tables (or take them from a ``TpchTables``), plan the
    query and upload its tiles; returns (executor, tiles, tables, report)."""
    cache = tables if tables is not None else TpchTables(sf)
    before = dict(cache.generate_s)
    query_tables = cache.for_query(num)
    gen = {k: v for k, v in cache.generate_s.items() if k not in before}
    ex, tiles, _, rep = plan_query(num, query_tables, tile_rows)
    return ex, tiles, query_tables, dict(generate_s=gen, **rep)


def check_result(num: int, ex, tiles, tables, want=None):
    """One run held against the numpy oracle (``check_frame``); returns
    (result Table, engine frame, oracle frame)."""
    result = ex.run(prefetched_tiles=tiles)
    got, want = check_frame(num, result, tables, want)
    return result, got, want


def check_frame(num: int, result, tables, want=None, sql=False):
    """A result Table held against the numpy oracle (or ``want``): integers,
    dates and strings exactly, DOUBLE to rtol 1e-9.  A SQL text's result is
    held in the oracle's column order (its names are the spec's).  Returns
    (engine frame, oracle frame)."""
    import pandas as pd

    from velox_tpu_torch.connectors.tpch.plans import ENGINE_OUTPUT_ORDER, oracle_result

    got = result.to_pandas().reset_index(drop=True)
    if want is None:
        want = oracle_result(num, tables).reset_index(drop=True)
    if sql:
        assert set(got.columns) >= set(want.columns), (list(got.columns), list(want.columns))
        got = got[list(want.columns)]
    elif num in ENGINE_OUTPUT_ORDER:
        got = got[ENGINE_OUTPUT_ORDER[num]]
    pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=1e-9)
    return got, want


def join_steps(ex):
    return [s[1] for s in ex.lin.steps if s[0] == "join"]


def sort_mode_report(ex):
    """What the last run of a sort-mode executor did."""
    joins = join_steps(ex)
    return dict(
        carry_groups=ex.carry_groups, carry_overflowed=ex.carry_overflowed,
        groups_out=ex.groups_out, pool_reserved_bytes=ex.pool.reserved,
        pool_peak_bytes=ex.pool.peak,
        joins=[dict(type=j.node.join_type.value, build_size=j.build_size,
                    build_keys=j.n_valid_build_keys, key_range=j.key_range,
                    packed_payload=j.bp_plan is not None,
                    fused=j._fused_static(ex.capacity) is not None,
                    device_build=j.build_valid is not None,
                    state_bytes=j.state_bytes()) for j in joins],
    )


def time_primitives(runs: int, n: int = 1 << 24):
    """Median CUDA-event ms of the torch calls the sort-mode paths are made
    of, on ``n`` int64 values, each beside its byte bound (bytes read +
    written over the published memory rate)."""
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(24)
    # packed words as the grouping sort sees them: 40 random key bits above
    # the row id
    bits = max(1, (n - 1).bit_length())
    keys = (torch.randint(0, 1 << 40, (n,), generator=gen, device=DEVICE) << bits) | torch.arange(
        n, dtype=torch.int64, device=DEVICE
    )
    operand = torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen, device=DEVICE)
    perm = torch.sort(keys, stable=True).indices
    word = 8 * n
    # "the value at the last flagged row" as the join probes and the run
    # structure ask it: 1 row in 8 flagged, non-decreasing values
    from velox_tpu_torch.ops.segmented import last_flagged

    flags = torch.randint(0, 8, (n,), generator=gen, device=DEVICE) == 0
    iota = torch.arange(n, dtype=torch.int64, device=DEVICE)
    marked = torch.where(flags, iota, torch.full_like(iota, -1))
    assert torch.equal(last_flagged(flags, iota, -1), torch.cummax(marked, 0).values)
    cases = {
        # keys in, keys and int64 positions out
        "sort_stable_int64": (lambda: torch.sort(keys, stable=True), 3 * word),
        # positions and operand in (the operand's rows in random order), one out
        "index_select_int64": (lambda: operand.index_select(0, perm), 3 * word),
        "cumsum_int64": (lambda: torch.cumsum(operand, 0), 2 * word),
        "cummax_int64": (lambda: torch.cummax(operand, 0), 3 * word),
        # the same function both ways: the running maximum of the flagged
        # values (values + indices out) and the engine's helper (flags and
        # values in, values out)
        "last_flagged_by_cummax": (lambda: torch.cummax(marked, 0), 3 * word),
        "last_flagged_int64": (lambda: last_flagged(flags, iota, -1), 2 * word + n),
    }
    out = {"rows": n}
    for name, (fn, moved) in cases.items():
        out[name] = dict(ms=median_ms(fn, runs), bound_ms=moved / PEAK_BYTES_PER_S * 1e3,
                         bytes=moved)
    return out


def time_query(ex, tiles, runs: int):
    import torch

    def once():
        ex.run(prefetched_tiles=tiles)

    once()
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        once()  # ends in the result fetch, which waits for the device
        walls.append((time.perf_counter() - t0) * 1e3)
    engine_ms = statistics.median(walls)
    busy, top = device_busy_ms(once)
    return dict(
        engine_ms=engine_ms, runs_ms=walls, device_busy_ms=busy,
        host_share=None if busy is None else max(0.0, 1.0 - busy / engine_ms),
        top_kernels=top,
    )


def expansion_report(ex):
    """The expansion joins of a query's first run (the build sides' and
    barriers' ones, run while the executor was constructed, then the last
    pipeline's): how many tiles were expanded, the largest output bucket, the
    rows they held, and how many expansions had each bucket."""
    done = ex.build_expansions + ex.expansions
    buckets = {}
    for b, _ in done:
        buckets[str(b)] = buckets.get(str(b), 0) + 1
    return dict(
        expansions=len(done), max_bucket=max((b for b, _ in done), default=0),
        expanded_rows=sum(r for _, r in done), buckets=buckets,
    )


def run_tpch(num: int, tables, tile_rows: int, runs: int, want=None, sql=False):
    """One query (its hand-built plan, or its SQL text when ``sql``) from host
    tables as a caller of ``run_plan`` / ``run_sql`` waits for it: executor
    construction (every build side and barrier pipeline, the uploads) and the
    run, ending in the result fetch.  The first run is held against the
    oracle (or ``want``); ``query_ms`` is the median of it and ``WHOLE_RUNS``
    - 1 more, and one more run under ``torch.profiler`` gives the device
    time (a first run longer than ``LONG_QUERY_S`` is the only one).  A
    plan's line also has ``engine_ms``: its last pipeline over
    device-resident tiles, median of ``runs``, as the Q1 / Q3 lines time it.
    Returns (the line's fields, the oracle frame)."""
    import torch

    from velox_tpu_torch.connectors.tpch.queries import SQL
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.ops.group_piece import grouped_piece_sums
    from velox_tpu_torch.sql import plan_sql

    k2_before = grouped_piece_sums.launches
    plan = None
    t0 = time.perf_counter()
    if sql:
        plan = plan_sql(SQL[num], tables)
    plan_sql_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex, tiles, plan, rep = plan_query(num, tables, tile_rows, plan=plan)
    result = ex.run(prefetched_tiles=tiles)
    # the first whole run: construction, upload and run (not the planning)
    walls = [(time.perf_counter() - t0 - rep["plan_s"]) * 1e3]
    rep["plan_s"] += plan_sql_s
    t0 = time.perf_counter()
    got, want = check_frame(num, result, tables, want=want, sql=sql)
    oracle_s = time.perf_counter() - t0
    first = dict(
        device_peak_bytes_first_run=torch.cuda.max_memory_allocated(), **expansion_report(ex),
        carry_groups=ex.carry_groups, carry_overflowed=ex.carry_overflowed,
        groups_out=ex.groups_out, pool_peak_bytes=ex.pool.peak,
    )
    fields = dict(num=num, **rep, **first, oracle_s=oracle_s, result_rows=int(len(got)),
                  correct=True)
    if not sql:
        timing = time_query(ex, tiles, runs)
        timing["top_kernels"] = timing["top_kernels"][:4]
        fields.update(timing)
    del ex, tiles, result
    torch.cuda.empty_cache()

    def once():
        LocalExecutor(plan, tile_rows=tile_rows, device=DEVICE).run()

    busy, top = None, []
    if walls[0] < LONG_QUERY_S * 1e3:
        for _ in range(WHOLE_RUNS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            once()
            walls.append((time.perf_counter() - t0) * 1e3)
        busy, top = device_busy_ms(once, top=4)
    query_ms = statistics.median(walls)
    fields.update(
        query_ms=query_ms, query_runs_ms=walls, query_device_busy_ms=busy,
        query_host_share=None if busy is None else max(0.0, 1.0 - busy / query_ms),
        query_top_kernels=top, k2_launches=grouped_piece_sums.launches - k2_before,
    )
    return fields, want


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--tile-rows", type=int, default=1 << 24)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--ptxas", action="store_true", help="print ptxas -v of the build")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from velox_tpu_torch.ops import cuda_build
    from velox_tpu_torch.ops.group_piece import grouped_piece_sums
    from velox_tpu_torch.ops.group_sum import grouped_int64_sums
    from velox_tpu_torch.ops.selective_sum import selective_sum

    wrappers = {
        "selective_sum": selective_sum,
        "grouped_piece_sums": grouped_piece_sums,
        "grouped_int64_sums": grouped_int64_sums,
    }
    t_begin = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    path = cuda_build.build(verbose=args.ptxas)
    cuda_build.library()
    say("build", seconds=time.perf_counter() - t0, nvcc_seconds=cuda_build.build_seconds,
        library=path.rsplit("/", 1)[-1], flags=" ".join(cuda_build.NVCC_FLAGS))

    bw = measured_bandwidth(args.runs)
    say("bandwidth", measured_bytes_per_s=bw, published_bytes_per_s=PEAK_BYTES_PER_S)

    cache = TpchTables(args.sf)
    ex6, tiles6, tables6, rep6 = prepare_query(6, args.sf, args.tile_rows, cache)
    ex1, tiles1, tables1, rep1 = prepare_query(1, args.sf, args.tile_rows, cache)
    assert rep1["piece_path"] is True and rep6["piece_path"] is False, (rep1, rep6)

    records = check_kernels(ex1, tiles1[0], tiles6[0], args.runs)
    for r in records:
        r["bound_ms_at_measured_bandwidth"] = r["bytes"] / bw * 1e3
    say("kernels", kernel_names=[r["name"] for r in records], records=records)
    say("edges", cases="[name, R, stages, chunk_rows, head, body_rows, tail, smem_bytes]",
        **check_edges())
    say("live_groups", **contention_sweep(ex1, tiles1[0], args.runs))

    # ---- the main path, with the counts set to 0 just before it
    for w in wrappers.values():
        w.launches = 0
    result6, got6, want6 = check_result(6, ex6, tiles6, tables6)
    result1, got1, want1 = check_result(1, ex1, tiles1, tables1)
    oracles = {6: want6, 1: want1}  # the SQL texts are held against these too
    q6_exact = int(result6.columns["revenue"][0])  # unscaled DECIMAL(18,4)
    passing = drive_ops(tiles6, ex1, tiles1, result1, q6_exact)
    launches = {name: w.launches for name, w in wrappers.items()}
    assert launches["grouped_piece_sums"] == len(tiles1), launches
    assert launches["selective_sum"] == len(tiles6), launches
    assert launches["grouped_int64_sums"] == len(tiles1), launches
    assert all(n > 0 for n in launches.values()), launches
    say("main_path", launches=launches, q6_rows_passing=passing,
        q6_revenue=float(got6["revenue"][0]), q1_groups=int(len(got1)),
        q1_count_order=[int(x) for x in got1["count_order"]])

    # ---- timings
    summary = {}
    for num, ex, tiles, rep in ((6, ex6, tiles6, rep6), (1, ex1, tiles1, rep1)):
        before = grouped_piece_sums.launches
        timing = time_query(ex, tiles, args.runs)
        k2 = grouped_piece_sums.launches - before
        if num == 1:
            # warm-up + timed runs + the profiled run, one launch per tile each
            assert k2 == len(tiles) * (args.runs + 2), (k2, len(tiles), args.runs)
        else:
            assert k2 == 0, k2
        rows_per_s = rep["rows"] / (timing["engine_ms"] * 1e-3)
        say(f"q{num}", sf=args.sf, **rep, **timing, rows_per_s=rows_per_s,
            k2_launches_while_timing=k2, correct=True)
        summary[f"plan q{num}"] = [timing["engine_ms"], timing["device_busy_ms"], rep["build_s"],
                                   None, None]

    del ex6, tiles6, tables6, ex1, tiles1, tables1, result6, result1
    torch.cuda.empty_cache()

    say("primitives", card=smi, published_bytes_per_s=PEAK_BYTES_PER_S,
        **time_primitives(args.runs))

    # ---- the sort-mode paths: joins, sort-mode grouping, device TopN.  They
    # launch none of the hand-written kernels, and must not.
    before = dict((name, w.launches) for name, w in wrappers.items())
    for num in (3, 13):
        before_gen = dict(cache.generate_s)
        tables = cache.for_query(num)
        gen = {k: v for k, v in cache.generate_s.items() if k not in before_gen}
        ex, tiles, plan, rep = plan_query(num, tables, args.tile_rows)
        assert ex.kind == "sort_agg_device", ex.kind
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, got, oracles[num] = check_result(num, ex, tiles, tables)
        check_s = time.perf_counter() - t0
        first = sort_mode_report(ex)
        first["device_peak_bytes_first_run"] = torch.cuda.max_memory_allocated()
        assert not ex.carry_overflowed, first
        extra = {}
        if num == 3:
            # several tiles: grouped without a sort, merged through the carry
            assert rep["tiles"] == 1 or (rep["presorted"] and ex.carry_groups), (rep, first)
            extra["top_row"] = [int(got["l_orderkey"][0]), float(got["revenue"][0])]
        else:
            # Q13's grouping over orders is its join's build side: time that
            # plan alone too (one executor, the tile kept on the device)
            from velox_tpu_torch.exec.runner import LocalExecutor

            build_ex = LocalExecutor(join_steps(ex)[0].node.right, tile_rows=args.tile_rows,
                                     device=DEVICE)
            build_tiles = build_ex.device_tiles()
            extra["build_side"] = dict(
                kind=build_ex.kind, rows=build_ex.source_table.num_rows,
                tiles=len(build_tiles), keys=[k.name for k in build_ex.agg_exec.key_infos],
                **time_query(build_ex, build_tiles, args.runs),
                groups_out=build_ex.groups_out, carry_groups=build_ex.carry_groups,
            )
            del build_ex, build_tiles
            # once more with small tiles, for the rows only: the build side's
            # 2^22-row tiles go through the carry merge
            small = 1 << 22
            ex4, tiles4, _, rep4 = plan_query(num, tables, small, plan=plan)
            check_result(num, ex4, tiles4, tables, want=oracles[num])
            extra["again_at_tile_rows"] = dict(
                tile_rows=small, correct=True, build_s=rep4["build_s"],
                orders_tiles=-(-tables["orders"].num_rows // small),
            )
            del ex4, tiles4
        timing = time_query(ex, tiles, args.runs)
        rows_per_s = rep["rows"] / (timing["engine_ms"] * 1e-3)
        say(f"q{num}", **{
            "sf": args.sf, "generate_s": gen, **rep, **timing, "rows_per_s": rows_per_s,
            "oracle_and_first_run_s": check_s, "result_rows": int(len(got)),
            "correct": True, **first, **sort_mode_report(ex), **extra,
        })
        summary[f"plan q{num}"] = [timing["engine_ms"], timing["device_busy_ms"], rep["build_s"],
                                   None, None]
        del ex, tiles, tables, plan
        torch.cuda.empty_cache()
    assert before == dict((name, w.launches) for name, w in wrappers.items())

    # ---- the other eighteen plans, then the 22 texts through the SQL front
    # end; a text is held against the oracle of its query's plan
    for num in range(1, 23):
        if num in (1, 3, 6, 13):
            continue
        fields, oracles[num] = run_tpch(num, cache.for_query(num), args.tile_rows, args.runs)
        say("tpch_plans", sf=args.sf, **fields)
        summary[f"plan q{num}"] = [fields["engine_ms"], fields["device_busy_ms"], fields["build_s"],
                                   fields["query_ms"], fields["query_device_busy_ms"]]
    small = TpchTables(min(args.sf, 1.0))
    for num in range(1, 23):
        if num in SQL_AT_SF1 and args.sf > 1:
            fields, _ = run_tpch(num, small.for_query(num), args.tile_rows, args.runs, sql=True)
            say("tpch_sql", sf=small.sf, **fields)
        else:
            fields, _ = run_tpch(num, cache.for_query(num), args.tile_rows, args.runs,
                                 want=oracles[num], sql=True)
            say("tpch_sql", sf=args.sf, **fields)
        summary[f"sql q{num}"] = [None, None, fields["build_s"],
                                  fields["query_ms"], fields["query_device_busy_ms"]]
    say("generate", sf=args.sf, seconds=cache.generate_s, sf1_seconds=small.generate_s)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "share_of_bound", "geometry")
    for r in records:
        r["launches"] = launches[r["name"]]
    say("summary", card=smi,
        columns="[engine_ms, device_busy_ms, build_s, query_ms, query_device_busy_ms]", **summary)
    say("total", seconds=time.perf_counter() - t_begin)
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
