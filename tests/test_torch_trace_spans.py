"""The port's spans (``velox_tpu_torch/utils/trace.py``) in a profiler's trace.

A join whose build side is a filtered scan, a grouped aggregation and a TopN
run under ``device_profile`` on the CPU: every span their path reaches is in
the Chrome trace, each inside the span that opened it, and the rows are the
rows of the same query run without a profiler.  A tile's span carries the
bytes ``batch_bytes`` counts in it; the K2 and K3 spans carry the launch's
operands; with no profiler a span is one shared no-op that calls nothing.
Imports nothing of the JAX package."""

import json
import os
import re

import numpy as np
import pytest
import torch

from velox_tpu_torch import dtypes as pt
from velox_tpu_torch.exec.memory import batch_bytes
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.io.table import Table
from velox_tpu_torch.ops import group_sum
from velox_tpu_torch.ops.group_piece import Factor, grouped_piece_sums, plan_spec
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.utils import trace
from velox_tpu_torch.vector.complex import HostSegments, HostStruct

N_ORDERS, N_LINES = 3000, 20000
NAME = re.compile(r"^velox\.([a-z0-9]+)(?:\[(.*)\])?$")


def q3_shaped(tile_rows):
    """Revenue of the orders of a segment by order, top 10: the build side
    is a filtered scan of ``orders``, the probe a filtered scan of
    ``lineitem``."""
    rng = np.random.default_rng(14)
    orders = table_from_numpy(
        ["o_orderkey", "o_segment", "o_priority"], ["BIGINT"] * 3,
        {"o_orderkey": np.arange(N_ORDERS, dtype=np.int64),
         "o_segment": rng.integers(0, 5, N_ORDERS),
         "o_priority": rng.integers(0, 3, N_ORDERS)},
    )
    lineitem = table_from_numpy(
        ["l_orderkey", "l_price"], ["BIGINT"] * 2,
        {"l_orderkey": rng.integers(0, N_ORDERS, N_LINES),
         "l_price": rng.integers(1, 10_000, N_LINES)},
    )
    build = PlanBuilder().table_scan(orders, filter="o_segment = 2")
    plan = (
        PlanBuilder()
        .table_scan(lineitem, filter="l_price > 100")
        .hash_join(build, ["l_orderkey"], ["o_orderkey"],
                   output=["l_orderkey", "l_price", "o_priority"])
        .aggregation(["l_orderkey", "o_priority"], ["sum(l_price) as revenue"])
        .topn(["revenue desc", "l_orderkey"], 10)
        .build()
    )
    return plan, tile_rows


SHIPMODES = ["", "AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
PRIORITIES = ["", "1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]


def q12_shaped():
    """TPC-H Q12's shape: a filtered scan of ``lineitem`` joined to
    ``orders``, grouped by ship mode in array mode, two sums of CASEs, so
    the aggregation reduces every accumulator on its own (the join breaks
    the piece path's row alignment)."""
    rng = np.random.default_rng(12)
    orders = table_from_numpy(
        ["o_orderkey", "o_orderpriority"], ["BIGINT", "VARCHAR"],
        {"o_orderkey": np.arange(N_ORDERS, dtype=np.int64),
         "o_orderpriority": rng.integers(1, 6, N_ORDERS).astype(np.int32)},
        string_values={"o_orderpriority": PRIORITIES},
    )
    lineitem = table_from_numpy(
        ["l_orderkey", "l_shipmode", "l_late"], ["BIGINT", "VARCHAR", "BIGINT"],
        {"l_orderkey": rng.integers(0, N_ORDERS, N_LINES),
         "l_shipmode": rng.integers(1, 8, N_LINES).astype(np.int32),
         "l_late": rng.integers(0, 4, N_LINES)},
        string_values={"l_shipmode": SHIPMODES},
    )
    urgent = "o_orderpriority in ('1-URGENT', '2-HIGH')"
    return (
        PlanBuilder()
        .table_scan(lineitem, filter="l_shipmode in ('MAIL', 'SHIP') and l_late = 0")
        .hash_join(PlanBuilder().table_scan(orders), ["l_orderkey"], ["o_orderkey"],
                   output=["l_shipmode", "o_orderpriority"])
        .project(["l_shipmode", f"case when {urgent} then 1 else 0 end as high",
                  f"case when {urgent} then 0 else 1 end as low"])
        .aggregation(["l_shipmode"], ["sum(high) as high_line_count", "sum(low) as low_line_count"])
        .orderby(["l_shipmode"])
        .build()
    )


def rows_of(table):
    return list(zip(*(np.asarray(table.columns[n]).tolist() for n in table.schema.names)))


def spans_in(log_dir):
    """[(kind, counts, start, end)] of the trace's ``velox.`` spans, by start."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        if e.get("cat") != "user_annotation" or not str(e.get("name", "")).startswith("velox."):
            continue
        m = NAME.match(e["name"])
        assert m, e["name"]
        counts = dict(kv.split("=") for kv in m.group(2).split(",")) if m.group(2) else {}
        out.append((m.group(1), counts, float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return sorted(out, key=lambda s: (s[2], -s[3]))


def inside(child, parents):
    return any(p[2] <= child[2] and child[3] <= p[3] for p in parents)


@pytest.mark.parametrize("tile_rows", [1 << 15, 1 << 12])
def test_q3_shaped_plan_spans_nest(tmp_path, tile_rows):
    """One tile, and several (the carry merge); every span of the path.
    One tile groups without reading the join's key order, so its probe is
    the hashed one, a ``velox.hprobe`` inside the tile's steps."""
    plan, tile_rows = q3_shaped(tile_rows)
    with trace.device_profile(str(tmp_path)):
        LocalExecutor(plan, tile_rows=tile_rows, device="cpu").run()
    spans = spans_in(str(tmp_path))
    by = {k: [s for s in spans if s[0] == k] for k in {s[0] for s in spans}}
    one_tile = N_LINES <= tile_rows
    assert set(by) == {"construct", "build", "tile", "run", "steps", "aggregate", "sort",
                       "fetch"} | ({"hprobe"} if one_tile else set())
    if one_tile:
        assert len(by["hprobe"]) == 1 and inside(by["hprobe"][0], by["steps"])
    # the query's executor and its build side's sub-executor
    assert len(by["construct"]) == 2 and len(by["run"]) == 1
    outer = [s for s in by["construct"] if not inside(s, by["build"])]
    assert len(outer) == 1 and by["run"][0][2] >= outer[0][3]
    assert all(inside(s, outer) for s in by["build"])
    # the sub-executor's construction lies inside the build side it runs
    assert all(inside(s, by["build"]) for s in by["construct"] if s is not outer[0])
    work = by["build"] + by["run"]
    for kind in ("tile", "steps", "fetch"):
        assert all(inside(s, work) for s in by[kind]), kind
    for kind in ("aggregate", "sort"):
        assert all(inside(s, by["run"]) for s in by[kind]), kind
    n_probe_tiles = -(-N_LINES // tile_rows)
    probe_tiles = [s for s in by["tile"] if inside(s, by["run"])]
    assert len(probe_tiles) == n_probe_tiles
    # a tile, its steps and its aggregation, tile after tile
    assert len([s for s in by["aggregate"] if inside(s, by["run"])]) >= n_probe_tiles
    # properly nested: two spans either nest or do not meet
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            assert b[2] >= a[3] or b[3] <= a[3], (a, b)


@pytest.mark.parametrize("tile_rows", [1 << 15, 1 << 12])
def test_q12_shaped_plan_opens_a_k3_span_a_call(tmp_path, monkeypatch, tile_rows):
    """direct_group_reduce sends each int64 sum to K3 (its plain version on
    the CPU): each call is one ``velox.k3`` span inside the tile's
    ``velox.aggregate``, with the call's operands, and the rows are those of
    the same run without a profiler."""
    plan = q12_shaped()
    plain = rows_of(LocalExecutor(plan, tile_rows=tile_rows, device="cpu").run())
    calls = []
    real = group_sum.grouped_int64_sums

    def counted(cols, gids, mask, num_groups):
        widths = [t.element_size() for t in (*cols, gids, mask)]
        calls.append({"rows": str(gids.shape[0]), "widths": "/".join(map(str, widths)),
                      "groups": str(num_groups)})
        return real(cols, gids, mask, num_groups)

    monkeypatch.setattr(group_sum, "grouped_int64_sums", counted)
    with trace.device_profile(str(tmp_path)):
        ex = LocalExecutor(plan, tile_rows=tile_rows, device="cpu")
        traced = rows_of(ex.run())
    assert traced == plain and [SHIPMODES[r[0]] for r in plain] == ["MAIL", "SHIP"]
    assert ex.kind == "direct_agg" and not ex.use_piece
    spans = spans_in(str(tmp_path))
    k3 = [s for s in spans if s[0] == "k3"]
    aggregate = [s for s in spans if s[0] == "aggregate"]
    # a tile: two exact BIGINT sums of three limbs (hi, lo, count) each, and
    # the row count
    n_tiles = ex.source_table.num_tiles(ex.capacity)
    assert len(calls) == 7 * n_tiles and len(aggregate) == n_tiles
    assert [s[1] for s in k3] == calls
    assert all(c["widths"] == "8/4/1" and c["groups"] == str(ex.agg_exec.num_groups)
               for c in calls)
    for a in aggregate:
        assert len([s for s in k3 if inside(s, [a])]) == 7


def test_rows_are_the_same_with_and_without_a_profiler(tmp_path):
    plan, tile_rows = q3_shaped(1 << 12)
    plain = rows_of(LocalExecutor(plan, tile_rows=tile_rows, device="cpu").run())
    with trace.device_profile(str(tmp_path)):
        traced = rows_of(LocalExecutor(plan, tile_rows=tile_rows, device="cpu").run())
    assert traced == plain and len(plain) == 10
    revenue = [r[2] for r in plain]
    assert revenue == sorted(revenue, reverse=True)


def _tables():
    """Host tables of every kind of column a tile uploads."""
    n = 1000
    rng = np.random.default_rng(3)
    narrow = table_from_numpy(
        ["a", "b", "c"], ["BIGINT", "INTEGER", "DATE"],
        {"a": rng.integers(0, 100, n), "b": rng.integers(-30000, 30000, n).astype(np.int32),
         "c": rng.integers(8000, 9000, n).astype(np.int32)},
    )
    mixed = table_from_numpy(
        ["s", "d", "x", "w"], ["VARCHAR", "DOUBLE", "DECIMAL(12, 2)", "DECIMAL(30, 2)"],
        {"s": rng.integers(0, 3, n).astype(np.int32), "d": rng.random(n),
         "x": rng.integers(0, 10**9, n), "w": rng.integers(0, 10**9, (n, 2))},
        string_values={"s": ["", "p", "q"]},
        validities={"d": rng.random(n) < 0.9, "s": rng.random(n) < 0.5},
    )
    at, rt = pt.array(pt.BIGINT), pt.row(["f", "g"], [pt.BIGINT, pt.VARCHAR])
    seg, seg_valid = HostSegments.from_pylist([[i, i + 1] if i % 7 else None for i in range(n)], at)
    st, st_valid = HostStruct.from_pylist([{"f": i, "g": "z"} for i in range(n)], rt)
    complex_ = Table(pt.RowType(["arr", "rec"], [at, rt]), {"arr": seg, "rec": st},
                     validities={"arr": seg_valid, "rec": st_valid})
    return {"narrow": narrow, "mixed": mixed, "complex": complex_}


@pytest.mark.parametrize("kind", ["narrow", "mixed", "complex"])
def test_tile_span_bytes_are_batch_bytes(tmp_path, kind):
    table = _tables()[kind]
    tile_rows = 384  # a padded last tile
    with trace.device_profile(str(tmp_path)):
        tiles = list(table.tiles(tile_rows, "cpu"))
    want = [batch_bytes([t]) for t in tiles]
    spans = [s for s in spans_in(str(tmp_path)) if s[0] == "tile"]
    assert [int(s[1]["bytes"]) for s in spans] == want
    assert want == [table.tile_bytes(tile_rows)] * table.num_tiles(tile_rows)


def test_no_profiler_no_span():
    def counts():
        raise AssertionError("counts called with no profiler recording")

    assert not torch.autograd._profiler_enabled()
    first, second = trace.span("tile", counts), trace.span("run")
    assert first is second
    with first:
        with second:  # the shared no-op nests in itself
            pass


def test_span_name_form(tmp_path):
    from portbench.program_trace import span_counts

    seen = []
    with trace.device_profile(str(tmp_path)):
        with trace.span("tile", lambda: seen.append(1) or {"bytes": 123456, "staged": 0}):
            pass
        with trace.span("k2", lambda: {"rows": 8, "widths": [1, 4], "specs": 2, "groups": 3}):
            pass
    names = [(s[0], s[1]) for s in spans_in(str(tmp_path))]
    assert names == [("tile", {"bytes": "123456", "staged": "0"}),
                     ("k2", {"rows": "8", "widths": "1/4", "specs": "2", "groups": "3"})]
    assert seen == [1]
    assert span_counts(trace.span_name("tile", {"bytes": 123456, "staged": 0})) == {
        "bytes": 123456, "staged": 0}


def test_a_second_executor_over_a_host_table_stages_nothing(tmp_path, monkeypatch):
    """Through the CPU staging seam: the first executor's tiles write what
    they upload (``staged`` equals ``bytes`` on every tile's first scan, and
    the ``staged`` counts sum to the bytes of the blocks written); the
    second executor over the same host tables opens ``velox.tile`` spans
    with ``staged=0`` and the same ``bytes``, and returns the same rows."""
    from torch_staging_helpers import plain_staging

    plan, tile_rows = q3_shaped(1 << 12)
    plain = rows_of(LocalExecutor(plan, tile_rows=tile_rows, device="cpu").run())
    blocks = plain_staging(monkeypatch)
    tiles, rows = [], []
    for i in range(2):
        with trace.device_profile(str(tmp_path / str(i))):
            rows.append(rows_of(LocalExecutor(plan, tile_rows=tile_rows, device="cpu").run()))
        spans = spans_in(str(tmp_path / str(i)))
        build = [s for s in spans if s[0] == "build"]
        tiles.append([(int(s[1]["bytes"]), int(s[1]["staged"]), inside(s, build))
                      for s in spans if s[0] == "tile"])
        if i == 0:
            written = sum(int(np.prod(shape)) * dtype.itemsize for shape, dtype in blocks)
    first, second = tiles
    assert rows == [plain, plain]
    assert any(in_build for _, _, in_build in first)  # the orders build side
    assert sum(staged for _, staged, _ in first) == written > 0
    assert all(staged == n for n, staged, in_build in first if in_build)
    assert [(n, 0, b) for n, _, b in first] == second
    assert sum(int(np.prod(shape)) * dtype.itemsize for shape, dtype in blocks) == written
    assert trace.span_name("k2", {"rows": 8, "widths": (1, 4)}) == "velox.k2[rows=8,widths=1/4]"


@pytest.mark.parametrize("dtypes", [(torch.int8, torch.int16, torch.int8), (torch.int32, torch.int32)])
def test_k2_span_holds_its_operands(tmp_path, dtypes):
    rows, groups = 5000, 6
    g = torch.Generator().manual_seed(5)
    cols = [torch.randint(0, 100, (rows,), generator=g).to(d) for d in dtypes]
    gid = torch.randint(-1, groups, (rows,), generator=g).to(torch.int32)
    plans = [plan_spec(f) for f in ([], [Factor(0, 1, 0, 0, 99)],
                                     [Factor(0, 2, 1, 1, 199), Factor(1, 1, 0, 0, 99)])]
    with trace.device_profile(str(tmp_path)):
        grouped_piece_sums(cols, gid, plans, groups)
    [span] = [s for s in spans_in(str(tmp_path)) if s[0] == "k2"]
    widths = [t.element_size() for t in (*cols, gid)]
    assert span[1] == {"rows": str(rows), "widths": "/".join(map(str, widths)),
                       "specs": str(len(plans)), "groups": str(groups)}


def q13_shaped(values, n_orders=5000):
    """TPC-H Q13's plan (``build_q13``) over orders whose comments are the
    entries of ``values``, one an order."""
    from velox_tpu_torch.connectors.tpch.plans import build_q13

    rng = np.random.default_rng(13)
    orders = table_from_numpy(
        ["o_custkey", "o_comment"], ["BIGINT", "VARCHAR"],
        {"o_custkey": rng.integers(1, 500, n_orders),
         "o_comment": rng.integers(1, len(values), n_orders).astype(np.int32)},
        string_values={"o_comment": values},
    )
    customer = table_from_numpy(["c_custkey"], ["BIGINT"], {"c_custkey": np.arange(1, 600)})
    return build_q13(customer, orders)


@pytest.mark.parametrize("tile_rows", [1 << 15, 1 << 10])
def test_q13_shaped_plan_opens_one_like_span_a_query(tmp_path, tile_rows):
    """The LIKE of Q13's build side is one ``velox.like`` span a query,
    whatever the number of tiles, inside the executor's construction and
    its build side, where the filter first evaluates it.  Its ``bytes`` are
    the bytes ``like_roofline_share`` counts for the same dictionary."""
    from portbench.columns.orders_text.o_comment import comment_pool
    from portbench.like_roofline import dict_like_bytes

    values = [""] + comment_pool(3000, 11)
    plain = rows_of(LocalExecutor(q13_shaped(values), tile_rows=tile_rows, device="cpu").run())
    with trace.device_profile(str(tmp_path)):
        for _ in range(2):  # two queries, each with its own plan
            traced = rows_of(LocalExecutor(q13_shaped(values), tile_rows=tile_rows,
                                           device="cpu").run())
    assert traced == plain
    spans = spans_in(str(tmp_path))
    like = [s for s in spans if s[0] == "like"]
    construct = [s for s in spans if s[0] == "construct"]
    build = [s for s in spans if s[0] == "build"]
    assert len(like) == 2
    assert all(inside(s, construct) and inside(s, build) for s in like)
    assert [s[1] for s in like] == [{"entries": str(len(values)),
                                     "bytes": str(dict_like_bytes(values))}] * 2
