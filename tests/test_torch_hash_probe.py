"""The hashed probe of a unique-key join (``HashJoinExec._probe_hashed``,
``ops/hash_probe.py``, K5's plain version on the CPU) against the merge
probe on the same batches, the executor's rule that chooses it, and TPC-H
Q12, Q13 and single-tile Q3 at SF 0.01 through ``LocalExecutor`` against the
JAX package's rows.

The twin cases: INNER, LEFT, LEFT SEMI and ANTI (null-aware or not), probe
keys that are NULL, outside the build's range, or at its ends, a build
bucket padded past its keys, a tile whose rows are all dead, a build with
TPC-H's 8-of-32 order-key stride, one- and two-column keys, packed and
gathered build payloads.  The merge emits its rows in key order and the
hashed probe in the probe's order, so rows are compared by a row id."""

import json
import os

import numpy as np
import pytest
import torch

from velox_tpu.connectors.tpch import plans as ref_plans
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu_torch.connectors.tpch import plans as port_plans
from velox_tpu_torch.exec.runner import LocalExecutor, apply_streaming
from velox_tpu_torch.ops.hash_probe import (
    HashTable, build_hash_table, hash_probe, hash_probe_plain, table_log2,
)
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.utils import trace

N_PROBE, N_BUILD, TILE = 5000, 700, 1024
TAGS = ["", "red", "blue", "green"]


def order_keys(n):
    """TPC-H's order keys: 8 values out of every 32, from 1."""
    i = np.arange(n, dtype=np.int64)
    return (i // 8) * 32 + i % 8 + 1


def tables(seed=0):
    rng = np.random.default_rng(seed)
    b1 = order_keys(N_BUILD)
    build = table_from_numpy(
        ["b1", "b2", "bval", "btag", "bdbl"], ["BIGINT", "BIGINT", "BIGINT", "VARCHAR", "DOUBLE"],
        {"b1": b1, "b2": b1 % 3, "bval": rng.integers(-500, 500, N_BUILD),
         "btag": rng.integers(1, 4, N_BUILD).astype(np.int32), "bdbl": rng.normal(size=N_BUILD)},
        string_values={"btag": TAGS},
        validities={"bval": rng.random(N_BUILD) < 0.9, "b1": rng.random(N_BUILD) < 0.97},
    )
    lo, hi = int(b1.min()), int(b1.max())
    p1 = rng.integers(lo - 40, hi + 40, N_PROBE)
    p1[:4] = [lo, hi, lo - 1, hi + 1]
    probe = table_from_numpy(
        ["rid", "p1", "p2", "pv", "pk"], ["BIGINT"] * 5,
        {"rid": np.arange(N_PROBE), "p1": p1, "pk": p1,  # pk: p1 without NULLs
         "p2": np.where(rng.random(N_PROBE) < 0.8, p1 % 3, 3), "pv": rng.integers(0, 99, N_PROBE)},
        validities={"p1": rng.random(N_PROBE) < 0.95, "pv": rng.random(N_PROBE) < 0.9},
    )
    return probe, build


PAYLOADS = {"packed": ["bval", "btag"], "gathered": ["bval", "bdbl"]}


def collect_plan(join_type, n_keys, payload, null_aware=False, build_filter=None):
    probe, build = tables()
    semi = join_type in ("left_semi", "anti")
    out = ["rid", "p1", "pv"] + ([] if semi else PAYLOADS[payload])
    return (
        PlanBuilder()
        # the fourth tile (rows 3072 .. 4095) is all dead
        .table_scan(probe, filter="rid < 3072 or rid >= 4096")
        .hash_join(PlanBuilder().table_scan(build, filter=build_filter),
                   ["p1", "p2"][:n_keys], ["b1", "b2"][:n_keys], output=out,
                   join_type=join_type, null_aware=null_aware)
        .build()
    )


def rows_by_id(batch):
    cols = batch.to_pydict(decode_strings=False)
    rows = list(zip(*(cols[n].tolist() for n in batch.schema.names)))
    return {r[0]: r for r in rows}


def probe_both_ways(plan):
    """{rid: row} of every tile through the merge probe and the hashed one."""
    ex = LocalExecutor(plan, tile_rows=TILE, device="cpu")
    assert ex.kind == "collect"
    i = next(k for k, s in enumerate(ex.lin.steps) if s[0] == "join")
    pre, join = ex.lin.steps[:i], ex.lin.steps[i][1]
    assert not join.hashed and join.hashable()
    merged, hashed, per_tile = {}, {}, []
    for tile in ex.source_table.tiles(ex.capacity, "cpu"):
        batch, _ = apply_streaming(tile, pre)
        m = rows_by_id(join.probe(batch))
        join.hashed = True
        out = join.probe(batch)
        join.hashed = False
        assert out.capacity == batch.capacity
        h = rows_by_id(out)
        merged.update(m)
        hashed.update(h)
        per_tile.append(len(h))
    return join, merged, hashed, per_tile


@pytest.mark.parametrize("payload", ["packed", "gathered"])
@pytest.mark.parametrize("n_keys", [1, 2])
@pytest.mark.parametrize("join_type", ["inner", "left", "left_semi", "anti"])
def test_hashed_probe_equals_the_merge(join_type, n_keys, payload):
    join, merged, hashed, per_tile = probe_both_ways(collect_plan(join_type, n_keys, payload))
    assert join.build_size > join.n_valid_build_keys  # a padded bucket
    assert (join.bp_plan is not None) == (payload == "packed" and join_type in ("inner", "left"))
    assert hashed == merged and len(merged) > 0
    assert per_tile[3] == 0  # the dead tile
    if join_type in ("inner", "left_semi"):
        assert all(r[1] is not None for r in hashed.values())


@pytest.mark.parametrize("build_filter", [None, "b1 is not null"])
def test_hashed_null_aware_anti_equals_the_merge(build_filter):
    """NOT IN: a build with a NULL key passes no probe row, one without
    passes the rows whose key is not NULL and not in the build."""
    plan = collect_plan("anti", 1, "packed", null_aware=True, build_filter=build_filter)
    join, merged, hashed, _ = probe_both_ways(plan)
    assert join.build_has_null_key == (build_filter is None)
    assert hashed == merged
    assert (len(hashed) == 0) == (build_filter is None)
    assert all(r[1] is not None for r in hashed.values())


def test_plain_probe_finds_each_key_and_only_it():
    keys = torch.from_numpy(order_keys(3000))
    table = build_hash_table(keys, int(keys[0]), int(keys[-1]))
    assert table.slots is None and table.capacity == 1 << 13 == 4 * HashTable.nbytes(3000) // 16
    probe = torch.cat([keys, keys + 8, torch.tensor([0, int(keys[-1]) + 1, int(keys[0])])])
    probe = probe.to(torch.int32)  # stored narrower than the build keys
    n = probe.shape[0]
    valid = torch.ones(n, dtype=torch.bool)
    valid[5] = False
    sel = torch.ones(n, dtype=torch.bool)
    sel[7] = False
    length = torch.tensor(n - 1, dtype=torch.int32)  # the last row is padding
    got = hash_probe(table, probe, length, sel, valid)
    want = np.full(n, -1)
    want[:3000] = np.arange(3000)
    want[[5, 7]] = -1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    empty = build_hash_table(keys[:0], 1, 0)
    assert (hash_probe_plain(empty, probe, length).numpy() == -1).all()


def test_table_size():
    assert [table_log2(n) for n in (0, 1, 2, 3, 15_000_000)] == [1, 1, 2, 3, 25]
    assert HashTable.nbytes(15_000_000) == 128 << 20


def test_hprobe_span_holds_its_operands(tmp_path):
    keys = torch.arange(0, 300, 3)
    table = build_hash_table(keys, 0, 297)
    with trace.device_profile(str(tmp_path)):
        hash_probe(table, torch.arange(1000), torch.tensor(1000, dtype=torch.int32))
    assert hprobe_spans(tmp_path) == [{"rows": "1000", "slots": "256", "build_rows": "100"}]


def hprobe_spans(log_dir):
    with open(os.path.join(str(log_dir), "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        name = str(e.get("name", ""))
        if e.get("cat") == "user_annotation" and name.startswith("velox.hprobe["):
            out.append(dict(kv.split("=") for kv in name[len("velox.hprobe["):-1].split(",")))
    return out


# ---- the rule: the plan alone chooses the probe


def joins_of(ex):
    return [s[1] for s in ex.lin.steps if s[0] == "join"]


def agg_plan(group_by, tail=None):
    probe, build = tables()
    b = (PlanBuilder().table_scan(probe)
         .hash_join(PlanBuilder().table_scan(build), ["pk"], ["b1"], output=["pk", "pv", "bval"]))
    if tail is not None:
        b = tail(b)
    return b.aggregation([group_by], ["sum(bval) as s", "count(*) as n"]).build()


@pytest.mark.parametrize("tile_rows", [1 << 10, 1 << 16])
def test_rule_follows_what_the_aggregation_reads(tile_rows):
    """Grouping on the join key over several tiles reads the merge's key
    order (presorted): the merge stays.  Grouping on anything else, or on
    the key in one tile, hashes.  The rows agree either way."""
    several = tile_rows < N_PROBE
    by_key = LocalExecutor(agg_plan("pk"), tile_rows=tile_rows, device="cpu")
    by_other = LocalExecutor(agg_plan("pv"), tile_rows=tile_rows, device="cpu")
    assert by_key.agg_exec.presorted == several
    assert [j.hashed for j in joins_of(by_key)] == [not several]
    assert [j.hashed for j in joins_of(by_other)] == [True]
    assert not by_other.agg_exec.presorted
    got = by_other.run().to_pandas().sort_values("pv").reset_index(drop=True)
    for j in joins_of(by_other):
        j.hashed = False
    want = by_other.run().to_pandas().sort_values("pv").reset_index(drop=True)
    assert got.equals(want)


def test_rule_keeps_the_merge_where_rows_are_numbered_or_collected():
    """A collect pipeline, and an aggregation over row ids assigned after
    the join (AssignUniqueId numbers rows by position), keep the merge."""
    collect = LocalExecutor(collect_plan("inner", 1, "packed"), tile_rows=TILE, device="cpu")
    numbered = LocalExecutor(agg_plan("uid", lambda b: b.assign_unique_id("uid")),
                             tile_rows=TILE, device="cpu")
    assert [j.hashed for j in joins_of(collect)] == [False]
    assert [j.hashed for j in joins_of(numbered)] == [False]
    assert numbered.lin.agg is not None and not numbered.agg_exec.presorted


def test_hashed_table_counts_in_the_pool():
    ex = LocalExecutor(agg_plan("pv"), tile_rows=TILE, device="cpu")
    [j] = joins_of(ex)
    assert j.hashed and ex.pool.reserved >= j.state_bytes()
    assert j.state_bytes() - HashTable.nbytes(j.n_valid_build_keys) > 0
    ex.run()
    assert j._table is not None and j._table.capacity == 1 << table_log2(j.n_valid_build_keys)


def test_a_budget_that_refuses_the_table_keeps_the_merge():
    from velox_tpu_torch.config import QueryConfig

    base = LocalExecutor(agg_plan("pv"), tile_rows=TILE, device="cpu")
    [j] = joins_of(base)
    want = base.run().to_pandas().sort_values("pv").reset_index(drop=True)
    limit = base.pool.reserved - HashTable.nbytes(j.n_valid_build_keys) + 1
    tight = LocalExecutor(agg_plan("pv"), tile_rows=TILE, device="cpu",
                          config=QueryConfig(query_memory_limit_bytes=limit))
    assert [j.hashed for j in joins_of(tight)] == [False]
    got = tight.run().to_pandas().sort_values("pv").reset_index(drop=True)
    assert got.equals(want)


# ---- TPC-H at SF 0.01 against the JAX package

SF = 0.01
_CACHE = {}


def tpch_tables(num):
    if num not in _CACHE:
        ref = ref_plans.load_query_tables(num, SF, cache_dir=None)
        port = {}
        for k, t in ref.items():
            names = list(t.schema.names)
            port[k] = table_from_numpy(
                names, [str(x) for x in t.schema.types],
                {n: np.asarray(t.columns[n]) for n in names},
                {n: s.values() for n, s in t.string_tables.items()},
                {n: np.asarray(v) for n, v in t.validities.items()},
            )
        _CACHE[num] = (ref, port)
    return _CACHE[num]


def same_table(got, want):
    assert list(got.schema.names) == list(want.schema.names)
    assert got.num_rows == want.num_rows > 0
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        if dtype.is_floating:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("num", [12, 13, 3])
def test_tpch_query_on_the_hashed_probe_matches_the_jax_package(tmp_path, num):
    """One tile: Q12 (direct-mode grouping by ship mode), Q13 (the LEFT
    probe under a grouping of counts) and Q3 (one tile, so not presorted)
    each probe hashed once; Q3's semi-join build side, a collect pipeline,
    keeps the merge."""
    ref_t, port_t = tpch_tables(num)
    tile_rows = 1 << 20
    with trace.device_profile(str(tmp_path)):
        ex = LocalExecutor(port_plans.build_query(num, port_t), tile_rows=tile_rows, device="cpu")
        got = ex.run()
    assert [j.hashed for j in joins_of(ex)] == [True]
    [span] = hprobe_spans(tmp_path)
    assert span["rows"] == str(ex.capacity)
    assert span["build_rows"] == str(joins_of(ex)[0].n_valid_build_keys)
    want = RefExecutor(ref_plans.build_query(num, ref_t), tile_rows=tile_rows).run()
    same_table(got, want)


def test_multi_tile_q3_keeps_the_merge(tmp_path):
    _, port_t = tpch_tables(3)
    with trace.device_profile(str(tmp_path)):
        ex = LocalExecutor(port_plans.build_query(3, port_t), tile_rows=1 << 12, device="cpu")
        ex.run()
    assert ex.agg_exec.presorted and [j.hashed for j in joins_of(ex)] == [False]
    assert hprobe_spans(tmp_path) == []
