"""``ops/segmented.py last_flagged`` / ``next_flagged`` — the value at the last
flagged row at or before each row (the next at or after it) — against the
running maximum / reversed running minimum they replace, with exact equality:
on random flags and on the edge cases, and on the inputs every call site of
the engine hands them while TPC-H runs (dead rows, sentinel keys, build and
probe rows of merged join sorts included)."""

import sys
from collections import Counter

import numpy as np
import pytest
import torch

from velox_tpu_torch.exec import joins as port_joins
from velox_tpu_torch.ops import segmented as seg


def _cummax_form(flags, values, fill):
    return torch.cummax(torch.where(flags, values, torch.full_like(values, fill)), 0).values


def _cummin_form(flags, values, fill):
    masked = torch.where(flags, values, torch.full_like(values, fill))
    return torch.cummin(masked.flip(0), 0).values.flip(0)


def _case(name, n, rng):
    if name == "none":
        flags = np.zeros(n, bool)
    elif name == "all":
        flags = np.ones(n, bool)
    elif name == "first_only":
        flags = np.arange(n) == 0
    elif name == "last_only":
        flags = np.arange(n) == n - 1
    else:
        flags = rng.random(n) < {"sparse": 0.02, "half": 0.5, "dense": 0.95}[name]
    # non-decreasing values with repeats, as every call site has them
    values = np.cumsum(rng.integers(0, 3, n)).astype(np.int64) + 5
    return torch.as_tensor(flags), torch.as_tensor(values)


@pytest.mark.parametrize("n", [0, 1, 2, 1000])
@pytest.mark.parametrize(
    "name", ["none", "all", "first_only", "last_only", "sparse", "half", "dense"]
)
def test_equals_the_running_extremes(name, n):
    rng = np.random.default_rng(n)
    flags, values = _case(name, n, rng)
    assert torch.equal(seg.last_flagged(flags, values, -1), _cummax_form(flags, values, -1))
    assert torch.equal(seg.last_flagged(flags, values, 0), _cummax_form(flags, values, 0))
    big = int(values.max()) + 1 if n else 1
    assert torch.equal(seg.next_flagged(flags, values, big), _cummin_form(flags, values, big))


def test_segmented_scan_sum_site():
    """``segmented_scan``'s sum finds each segment's start this way (no
    engine path calls it; the sorted-run tests hold its output against the
    JAX package)."""
    rng = np.random.default_rng(3)
    boundary = torch.as_tensor(rng.random(500) < 0.1)
    values = torch.as_tensor(rng.integers(-50, 50, 500))
    iota = torch.arange(500)
    got = seg.segmented_scan(values, boundary, "sum")
    start = _cummax_form(boundary, iota, 0)
    totals = torch.cumsum(values, 0)
    before = torch.where(start > 0, totals[(start - 1).clamp(min=0)], torch.zeros_like(totals))
    assert torch.equal(got, totals - before)
    assert torch.equal(seg.last_flagged(boundary, iota, 0), start)


SITES = {"run_boundaries", "run_is_end", "first", "_fused_post", "_lookup_sorted", "probe_spans"}


def test_every_engine_site_on_its_own_inputs(monkeypatch):
    """Each call of the helpers made while TPC-H runs is held against the
    scan it replaced, on the very tensors the site passes."""
    from velox_tpu_torch.connectors.tpch import plans
    from velox_tpu_torch.connectors.tpch.queries import SQL
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.plan.nodes import HashJoinNode
    from velox_tpu_torch.sql import run_sql

    hits = Counter()
    last, nxt = seg.last_flagged, seg.next_flagged

    def site():
        frame = sys._getframe(2)
        if frame.f_code.co_name == "_last_build_row":
            frame = frame.f_back
        return frame.f_code.co_name

    def checked_last(flags, values, fill):
        out = last(flags, values, fill)
        assert torch.equal(out, _cummax_form(flags, values, fill)), site()
        hits[site()] += 1
        return out

    def checked_next(flags, values, fill):
        out = nxt(flags, values, fill)
        assert torch.equal(out, _cummin_form(flags, values, fill)), site()
        hits[site()] += 1
        return out

    monkeypatch.setattr(seg, "last_flagged", checked_last)
    monkeypatch.setattr(seg, "next_flagged", checked_next)
    monkeypatch.setattr(port_joins, "last_flagged", checked_last)
    # Q3 by plan: fused probes, presorted grouping, carry merge; Q16's joins
    # as a collect pipeline: the classification probe (under Q16's grouping,
    # which reads no key order, they probe hashed); Q3 by SQL: an expansion
    # join
    q3 = plans.build_query(3, plans.load_query_tables(3, 0.01))
    LocalExecutor(q3, tile_rows=1 << 12, device="cpu").run()
    q16_joins = plans.build_query(16, plans.load_query_tables(16, 0.01))
    while not isinstance(q16_joins, HashJoinNode):
        q16_joins = q16_joins.sources[0]
    LocalExecutor(q16_joins, tile_rows=1 << 12, device="cpu").run()
    run_sql(SQL[3], plans.load_query_tables(3, 0.01), tile_rows=1 << 12, device="cpu")
    assert SITES <= set(hits), hits
