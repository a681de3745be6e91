#!/usr/bin/env python3
"""Longer measurements than chip_smoke.py makes: the two grouped-sum kernels,
and the scan of the sort-mode paths.

    python3 kernel_study.py [--sf 10] [--tile-rows 16777216] [--runs 5] [--sass-dir DIR]

Needs one CUDA device, nvcc and cuobjdump; run it from the repository root,
beside ``chip_smoke.py``, whose inputs, timer and JSON lines it uses.  On one
tile of TPC-H Q1 at SF ``sf`` (``last_flagged_row``: on 2^24 made-up rows) it
prints, one JSON line each:

``sass``      per kernel of the built library, the counts of the opcodes that
              show how the design was compiled (shared atomics, bulk copies,
              barrier waits, local-memory traffic); the listing is saved as
              ``kernels.sass`` beside the library or under ``--sass-dir``;
``variants``  kernel ms of ``grouped_piece_sums`` and ``grouped_int64_sums``
              with one choice of the launch geometry overridden at a time
              (chunk rows, stages, blocks a multiprocessor, table copies R),
              each launch checked against the plain version first;
``piece_cost_split``  kernel ms of ``grouped_piece_sums`` with parts of the
              work taken away (all rows dead, count specs only, one spec with
              every factor), which shows what staging, table adds and products
              each cost;
``last_flagged_row``  what the sort-mode paths compute where the JAX
              package runs ``cummax`` / ``cummin`` ("the last flagged row at
              or before this one"), timed as ``torch.cummax`` and as the
              engine's ``ops/segmented.py last_flagged`` (a prefix count of
              the flags, a scatter by that count and a gather back); equal
              results asserted;
``running_min_max``  the window's running min / max over 2^24 made-up
              rows in segments, as the engine computes it (a sparse table and
              one range query a row) and as a ``torch.cummax`` of a packed
              (segment, value rank) word; equal results asserted.

The wrappers take no tuning argument: a variant is run by planning every
launch inside ``planned_with(...)`` with that override of
``launch_geometry.plan_launch``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import re
import shutil
import subprocess
import sys

from chip_smoke import (
    DEVICE,
    PEAK_BYTES_PER_S,
    equal_bits,
    median_ms,
    prepare_query,
    q1_group_sum_inputs,
    q1_piece_inputs,
    say,
)

SASS_OPCODES = ("ATOMS", "ATOM", "RED", "UBLKCP", "SYNCS", "LDS", "STS", "LDG", "LD.E", "LDL",
                "STL", "IMAD", "BAR")


@contextlib.contextmanager
def planned_with(**overrides):
    """Inside, every launch's geometry is planned with these overrides."""
    from velox_tpu_torch.ops import launch_geometry

    original = launch_geometry.plan_launch
    launch_geometry.plan_launch = functools.partial(original, **overrides)
    try:
        yield
    finally:
        launch_geometry.plan_launch = original


def sass_report(library_path: str, listing_dir: str):
    """Disassembles the library and counts, per kernel, the opcodes of
    SASS_OPCODES.  The listing goes to listing_dir/kernels.sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", library_path], capture_output=True, text=True,
                          check=True).stdout
    os.makedirs(listing_dir, exist_ok=True)
    with open(os.path.join(listing_dir, "kernels.sass"), "w") as f:
        f.write(text)
    counts, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1), {})
            continue
        m = re.search(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)", line)
        if m and current is not None:
            op = m.group(1)
            for key in SASS_OPCODES:
                if op == key or op.startswith(key + "."):
                    full = op if key in ("ATOMS", "ATOM", "RED") else key
                    current[full] = current.get(full, 0) + 1
                    break
    return counts


def variant_sweep(cols, gid_live, plans, groups, wide, gids, mask, runs: int):
    """{kernel: [[overrides, ms]]}; the first entry of each is what
    ``plan_launch`` chooses by itself."""
    from velox_tpu_torch.ops.group_piece import grouped_piece_sums, grouped_piece_sums_plain
    from velox_tpu_torch.ops.group_sum import grouped_int64_sums, grouped_int64_sums_plain

    def ring(rows, stages, blocks_per_sm, **more):
        return dict(chunk_rows=rows, stages=stages, blocks_per_sm=blocks_per_sm, **more)

    piece_variants = [
        {},
        ring(2048, 3, 3), ring(4096, 2, 2), ring(1024, 2, 4), ring(1024, 4, 4), ring(512, 6, 4),
        ring(2048, 2, 3), ring(2048, 2, 2), ring(2048, 2, 1),
        ring(2048, 2, 4, lane_copies=1), ring(2048, 2, 4, lane_copies=4),
        ring(2048, 2, 4, lane_copies=16),
    ]
    sum_variants = [
        {},
        ring(512, 3, 3), ring(1024, 2, 2), ring(256, 4, 4), ring(256, 2, 4), ring(2048, 2, 1),
        ring(512, 2, 4, lane_copies=1), ring(512, 2, 4, lane_copies=4),
    ]
    out = {"grouped_piece_sums": [], "grouped_int64_sums": []}
    want = grouped_piece_sums_plain(cols, gid_live, plans, groups)
    for overrides in piece_variants:
        with planned_with(**overrides):
            call = lambda: grouped_piece_sums(cols, gid_live, plans, groups)  # noqa: E731
            assert equal_bits(call(), want), overrides
            out["grouped_piece_sums"].append([overrides, median_ms(call, runs)])
    want = grouped_int64_sums_plain(wide, gids, mask, groups)
    for overrides in sum_variants:
        with planned_with(**overrides):
            call = lambda: grouped_int64_sums(wide, gids, mask, groups)  # noqa: E731
            assert equal_bits(call(), want), overrides
            out["grouped_int64_sums"].append([overrides, median_ms(call, runs)])
    return out


def piece_cost_split(cols, gid_live, plans, groups, runs: int):
    """Where grouped_piece_sums spends its time on Q1's tile: the same launch
    with parts of the work taken away (kernel ms each)."""
    import torch

    from velox_tpu_torch.ops.group_piece import SpecPlan, grouped_piece_sums, plan_spec

    every_factor = [f for p in plans for f in p.factors]
    cases = {
        "all rows dead (staging and row loop only)":
            (torch.full_like(gid_live, -1), plans),
        "count specs only (table adds, no products)":
            (gid_live, [plan_spec([])] * len(plans)),
        "one spec with every factor (products, one add)":
            (gid_live, [SpecPlan(tuple(every_factor), 0, 0, 1)]),  # the kernel reads only the factors
        "one count spec": (gid_live, [plan_spec([])]),
        "as the query runs it": (gid_live, plans),
    }
    out = {"factors": len(every_factor), "specs": len(plans)}
    for name, (gid, specs) in cases.items():
        out[name] = median_ms(lambda: grouped_piece_sums(cols, gid, specs, groups), runs)
    return out


def last_flagged_row(runs: int, n: int = 1 << 24):
    """ms of "the last flagged row at or before each row" over ``n`` rows, 1
    in 8 flagged, two ways on one input: the running maximum of the flagged
    positions, and prefix count + scatter + gather (the engine's helper)."""
    import torch

    from velox_tpu_torch.ops.segmented import last_flagged

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(24)
    iota = torch.arange(n, dtype=torch.int64, device=DEVICE)
    flag = torch.randint(0, 8, (n,), generator=gen, device=DEVICE) == 0
    marked = torch.where(flag, iota, torch.full_like(iota, -1))

    def by_cummax():
        return torch.cummax(marked, 0).values

    def by_count_scatter_gather():
        return last_flagged(flag, iota, -1)

    assert torch.equal(by_cummax(), by_count_scatter_gather())
    return dict(
        rows=n,
        cummax_ms=median_ms(by_cummax, runs),
        count_scatter_gather_ms=median_ms(by_count_scatter_gather, runs),
        # flags read, positions written
        bound_ms=(n + 8 * n) / PEAK_BYTES_PER_S * 1e3,
    )


def running_min_max(runs: int, n: int = 1 << 24):
    """ms of the window's running min / max (``segmented_scan(..., "min" /
    "max")``: the extreme over [segment start, row]) over ``n`` int64 rows,
    1 in 16 starting a segment (about the shape of a window over ``orders``
    by customer), two ways on one input: the engine's sparse table with one
    range query a row (``ops/segmented.py sparse_table`` /
    ``sparse_table_query``), and the running maximum of a packed (segment,
    value rank) word by ``torch.cummax`` (what ``segmented_scan`` ran until
    the window slice); equal results asserted."""
    import torch

    from velox_tpu_torch.ops.segmented import segmented_scan

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(16)
    values = torch.randint(-(1 << 40), 1 << 40, (n,), generator=gen, device=DEVICE)
    boundary = torch.randint(0, 16, (n,), generator=gen, device=DEVICE) == 0
    iota = torch.arange(n, dtype=torch.int64, device=DEVICE)

    def by_cummax(op):
        seg = torch.cumsum(boundary, 0)
        order = torch.argsort(values, stable=True)
        rank = torch.empty_like(order)
        rank[order] = iota
        if op == "min":
            rank = (n - 1) - rank
        bits = max(1, int(n - 1).bit_length())
        best = torch.cummax((seg << bits) | rank, 0).values & ((1 << bits) - 1)
        if op == "min":
            best = (n - 1) - best
        return values.index_select(0, order.index_select(0, best))

    out = dict(rows=n, segments=int(boundary.sum()),
               # values and flags read, values written
               bound_ms=(8 * n + n + 8 * n) / PEAK_BYTES_PER_S * 1e3)
    for op in ("min", "max"):
        assert torch.equal(by_cummax(op), segmented_scan(values, boundary, op)), op
        out[op] = dict(
            sparse_table_ms=median_ms(lambda: segmented_scan(values, boundary, op), runs),
            cummax_ms=median_ms(lambda: by_cummax(op), runs),
        )
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--tile-rows", type=int, default=1 << 24)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--sass-dir", default=None,
                    help="where the SASS listing is saved (default: beside the library)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_study: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from velox_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    path = cuda_build.build()
    cuda_build.library()
    say("sass", opcodes=sass_report(path, args.sass_dir or cuda_build.build_dir()))

    ex1, tiles1, _, _ = prepare_query(1, args.sf, args.tile_rows)
    cols, gid_live, plans, groups, mask, gids = q1_piece_inputs(ex1, tiles1[0])
    wide = q1_group_sum_inputs(tiles1[0])
    say("variants", rows=int(gid_live.shape[0]),
        **variant_sweep(cols, gid_live, plans, groups, wide, gids, mask, args.runs))
    say("piece_cost_split", **piece_cost_split(cols, gid_live, plans, groups, args.runs))
    say("last_flagged_row", card=smi, **last_flagged_row(args.runs))
    say("running_min_max", card=smi, **running_min_max(args.runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
