"""The sort-mode paths on the card against the same plans on the CPU.

Joins, sort-mode grouping, the carry merge and its overflow, collect pipelines
and the device OrderBy / TopN are plain torch calls, so the CPU tests hold
their logic against the JAX package; what only a CUDA device can show is that
every one of those calls exists there for the dtypes used (stable sorts of
int64 and uint8, ``scatter_reduce_`` with ``amin`` / ``amax`` on int64 and
float64, the last-flagged-row helper's scatter and gather) and gives the same
rows.  ``chip_smoke.py``
runs TPC-H Q3 and Q13 at full size; these cases reach the branches those two
queries do not (two-limb keys, the classification probe, an empty build side,
the host merge, NULL keys, min / max, DOUBLE sums).  Skipped where there is no
CUDA device; run with ``python -m pytest tests/test_torch_gpu_sort_paths.py -m gpu``.

Integers, dates, dictionary codes and masks exact; DOUBLE rtol 1e-9 (sums add in
another order on the card), atol 1e-6 where they cancel."""

import numpy as np
import pytest
import torch

from velox_tpu_torch.config import QueryConfig
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy

pytestmark = pytest.mark.gpu

N_PROBE, N_BUILD = 6000, 700
_TAGS = ["", "red", "blue", "green"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _tables(wide=False):
    rng = np.random.default_rng(0)
    step = (1 << 61) // 1000 if wide else 1
    step2 = (1 << 40) // 4 if wide else 1
    b1 = rng.choice(np.arange(100, 900), N_BUILD, replace=False).astype(np.int64)
    build = table_from_numpy(
        ["b1", "b2", "bval", "bday", "bdbl"],
        ["BIGINT", "BIGINT", "BIGINT", "DATE", "DOUBLE"],
        {
            "b1": b1 * step,
            "b2": (b1 % 4) * step2,
            "bval": rng.integers(-500, 500, N_BUILD).astype(np.int64),
            "bday": rng.integers(9000, 9100, N_BUILD).astype(np.int32),
            "bdbl": rng.normal(size=N_BUILD),
        },
        validities={"bval": rng.random(N_BUILD) < 0.9, "b1": rng.random(N_BUILD) < 0.97},
    )
    p1 = rng.integers(0, 1000, N_PROBE).astype(np.int64)
    probe = table_from_numpy(
        ["p1", "p2", "p3", "pv", "ptag", "pz", "w", "x"],
        ["BIGINT", "BIGINT", "BIGINT", "BIGINT", "VARCHAR", "BIGINT", "BIGINT", "DOUBLE"],
        {
            "p1": p1 * step,
            "p2": (p1 % 4) * step2,
            "p3": p1 * step,
            "pv": rng.integers(-(1 << 40), 1 << 40, N_PROBE).astype(np.int64),
            "ptag": rng.integers(1, 4, N_PROBE).astype(np.int32),
            "pz": rng.integers(0, 3, N_PROBE).astype(np.int64),
            "w": rng.integers(-(1 << 61), 1 << 61, 40)[rng.integers(0, 40, N_PROBE)].astype(np.int64),
            "x": rng.normal(0, 100, N_PROBE),
        },
        {"ptag": _TAGS},
        {"p1": rng.random(N_PROBE) < 0.95, "pv": rng.random(N_PROBE) < 0.9,
         "w": rng.random(N_PROBE) < 0.9},
    )
    return probe, build


def _same(got, want):
    assert list(got.schema.names) == list(want.schema.names)
    assert got.num_rows == want.num_rows
    assert set(got.validities) == set(want.validities)
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        valid = want.validities.get(name)
        if valid is not None:
            np.testing.assert_array_equal(got.validities[name], valid, err_msg=name)
            g, w = g[valid], w[valid]
        if dtype.is_floating:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-6, err_msg=name)
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _both(plan, cuda, tile_rows=1 << 10, config=None):
    on_card = LocalExecutor(plan, tile_rows=tile_rows, device=cuda, config=config)
    on_cpu = LocalExecutor(plan, tile_rows=tile_rows, device="cpu", config=config)
    _same(on_card.run(), on_cpu.run())
    return on_card, on_cpu


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n_keys", [1, 2])
@pytest.mark.parametrize("join_type", ["inner", "left", "left_semi", "anti"])
def test_join_plans(cuda, join_type, n_keys, wide):
    probe, build = _tables(wide)
    semi = join_type in ("left_semi", "anti")
    out = ["p1", "pv", "ptag"] + ([] if semi else ["bval", "bday" if n_keys == 1 else "bdbl"])
    plan = (
        PlanBuilder().table_scan(probe, filter="pz < 2")
        .hash_join(
            PlanBuilder().table_scan(build), ["p1", "p2"][:n_keys], ["b1", "b2"][:n_keys],
            output=out, join_type=join_type,
        )
        .orderby([f"{c} nulls first" for c in out]).build()
    )
    on_card, _ = _both(plan, cuda)
    [join] = [s[1] for s in on_card.lin.steps if s[0] == "join"]
    assert join.device.type == "cuda"
    assert (join._fused_static(on_card.capacity) is None) == wide


def test_empty_and_host_built_sides(cuda):
    probe, build = _tables()
    empty = (
        PlanBuilder().table_scan(probe)
        .hash_join(PlanBuilder().table_scan(build, filter="bval < -9999"), ["p1"], ["b1"],
                   output=["p1", "bval"], join_type="left")
        .orderby(["p1 nulls first"]).build()
    )
    _both(empty, cuda)
    counts = PlanBuilder().table_scan(build).aggregation(["b2"], ["count(*) as cnt", "min(bdbl) as m"])
    q13_like = (
        PlanBuilder().table_scan(probe)
        .hash_join(counts, ["p2"], ["b2"], output=["p1", "cnt", "m"], join_type="left")
        .project(["coalesce(cnt, 0) as c", "m", "p1"])
        .aggregation(["c"], ["count(*) as n", "max(m) as mm", "min(p1) as lo"])
        .orderby(["c"]).build()
    )
    _both(q13_like, cuda)


_AGGS = [
    "count(*) as n", "count(pv) as nv", "sum(pv) as s", "avg(pv) as a", "min(pv) as lo",
    "max(p3) as hi", "sum(x) as sx", "min(x) as mx", "max(ptag) as t",
]


@pytest.mark.parametrize(
    "keys", [["p1", "ptag"], ["w", "ptag"], ["p3"]], ids=["packed_nullable", "fallback_nullbits", "packed"]
)
@pytest.mark.parametrize("device_merge", [True, False])
def test_sort_mode_grouping(cuda, keys, device_merge):
    probe, _ = _tables()
    plan = (
        PlanBuilder().table_scan(probe, filter="pz < 2")
        .aggregation(keys, _AGGS).orderby([f"{k} nulls first" for k in keys]).build()
    )
    on_card, _ = _both(plan, cuda, config=QueryConfig(device_agg_merge=device_merge))
    assert on_card.kind == ("sort_agg_device" if device_merge else "sort_agg")
    one_tile = LocalExecutor(plan, tile_rows=1 << 20, device=cuda)
    _same(one_tile.run(), on_card.run())


def test_carry_overflow_on_the_card(cuda):
    rng = np.random.default_rng(3)
    n = 8192
    k = np.concatenate([rng.integers(0, 4, 1024), rng.integers(0, 3000, n - 1024)]).astype(np.int64)
    t = table_from_numpy(["k", "u"], ["BIGINT", "BIGINT"], {"k": k, "u": rng.integers(-9, 9, n).astype(np.int64)})
    plan = PlanBuilder().table_scan(t).aggregation(["k"], ["sum(u) as s"]).orderby(["k"]).build()
    on_card, _ = _both(plan, cuda)
    assert on_card.carry_overflowed and on_card.carry_groups == 16


@pytest.mark.parametrize(
    "finish",
    [
        lambda b: b.orderby(["ptag", "pv desc nulls first", "x"]),
        lambda b: b.topn(["x desc", "p3"], 25),
        lambda b: b.orderby(["p3 desc", "x"]).limit(40, 3),
        lambda b: b,
    ],
    ids=["orderby", "topn", "orderby_limit", "plain_collect"],
)
def test_collect_pipelines(cuda, finish):
    probe, _ = _tables()
    b = PlanBuilder().table_scan(probe, filter="pz < 2").project(["p3", "pv", "ptag", "x"])
    _both(finish(b).build(), cuda)


def test_presorted_grouping_and_device_topn(cuda):
    probe, build = _tables()
    plan = (
        PlanBuilder().table_scan(probe, filter="pz < 2 and p3 < 350")
        .hash_join(PlanBuilder().table_scan(build), ["p3"], ["b1"], output=["p3", "pv", "bday", "ptag"])
        .aggregation(["p3", "bday", "ptag"], ["sum(pv) as s", "count(*) as n"])
        .topn(["s desc", "bday", "p3"], 7).build()
    )
    on_card, _ = _both(plan, cuda)
    assert on_card.agg_exec.grouping.presorted and not on_card.carry_overflowed
    assert on_card._device_topn_plan()[0] == 7
