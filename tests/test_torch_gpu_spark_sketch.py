"""The sketch / Spark slice on the card against the same calls on the CPU:
the slice's TPC-H texts (``chip_smoke.py`` H1, H2, P1, P2, B1, X1, X2, X3)
at SF 0.01 against their numpy oracles and the CPU's rows, the device
functions (the HLL register and rank, the DDSketch bucket with the powers of
gamma where its boundaries lie, the Spark hashes, the bloom filter's hash
and mask, rand) value for value (DDSketch's buckets to one bucket on their
boundaries, within its bound), and dbgen's SF-1 tables held to the TPC-H
specification's published answers (``dbgen_golden``).  The CPU tests hold
the same code against the JAX package.  Skipped where there is no CUDA
device.  The card's machine has no JAX, and ``tests/conftest.py`` imports
it, so run with ``python -m pytest tests/test_torch_gpu_spark_sketch.py -m
gpu --noconftest -q``.

Integers, strings, bytes and arrays exact; DOUBLE rtol 1e-9."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from velox_tpu_torch.connectors.tpch import load_table
from velox_tpu_torch.exec import sketch
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.functions.spark import scalar as spark
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.sql import plan_sql
from velox_tpu_torch.testing import assert_same_values, python_rows
from velox_tpu_torch.utils.spark_bloom import bloom_mask, twang_mix64

pytestmark = pytest.mark.gpu
SF = 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _run(name, tables, device, tile_rows=1 << 12):
    plan = (plan_sql(cs.SPARK_SQL[name], tables) if name in cs.SPARK_SQL
            else cs.spark_plan(name, PlanBuilder, tables))
    ex = LocalExecutor(plan, tile_rows=tile_rows, config=cs.spark_config(name), device=device)
    result = ex.run()
    if name != "B1":
        return ex, result, None
    data = result.to_pandas()["bf"][0]
    probe = plan_sql(cs.B1_PROBE.format(hex=data.hex()), {"lineitem": tables["lineitem"]})
    return ex, LocalExecutor(probe, tile_rows=tile_rows, device=device).run(), data


def _sorted_rows(table):
    rows = python_rows(table)
    order = sorted(range(table.num_rows), key=lambda i: tuple(repr(v[i]) for v in rows.values()))
    return {c: [v[i] for i in order] for c, v in rows.items()}


@pytest.mark.parametrize("name", cs.SPARK_NAMES)
def test_spark_text_matches_cpu(cuda, name):
    tables = {t: load_table(t, SF, list(c)) for t, c in cs.SPARK_COLUMNS[name].items()}
    ex, got, data = _run(name, tables, cuda)
    cs.check_spark(name, got, tables, ex, {"filter": data})
    _, want, cpu_data = _run(name, tables, "cpu")
    assert data == cpu_data
    got, want = _sorted_rows(got), _sorted_rows(want)
    for col in want:
        assert_same_values(got[col], want[col], path=col)


def test_device_functions_match_cpu(cuda):
    rng = np.random.default_rng(4)
    ints = np.concatenate([rng.integers(-(1 << 63), (1 << 63) - 1, 1 << 20, dtype=np.int64),
                           [0, -1, 1, -(1 << 63), (1 << 63) - 1]]).astype(np.int64)
    gamma = (1 + 0.005) / (1 - 0.005)
    doubles = np.concatenate([rng.lognormal(0, 6, 1 << 20), -rng.lognormal(0, 6, 1 << 10),
                              [0.0, -0.0, 1e-300]])
    for fn in (sketch.hll_bucket, sketch.hll_rho):
        for x in (ints, doubles):
            t = torch.from_numpy(x)
            np.testing.assert_array_equal(fn(t.to(cuda)).cpu().numpy(), fn(t).numpy(),
                                          err_msg=fn.__name__)
    t = torch.from_numpy(ints)
    for fn in (twang_mix64, lambda v: bloom_mask(twang_mix64(v)),
               lambda v: spark._murmur3_long(v, torch.full_like(v, 42)),
               lambda v: spark._xxh64_long(v, torch.full_like(v, 42)),
               lambda v: spark._xxh64_int(v & 0xFFFFFFFF, torch.full_like(v, 42)),
               lambda v: spark.rand_values(42, v)):
        np.testing.assert_array_equal(fn(t.to(cuda)).cpu().numpy(), fn(t).numpy())


def test_dd_bucket_boundaries(cuda):
    """DDSketch buckets on the card against the CPU: the bucket is
    ceil(log|x| / log gamma), and the card's log may differ from the CPU's
    in the last bit, which moves a value on a bucket boundary (the powers of
    gamma) into the next bucket.  Values off the boundaries agree; a moved
    value is one bucket away and its representative still within
    DDSketch's bound of it (``chip_smoke.DD_BOUND``).  The counts are
    printed (run with ``-s``)."""
    import json

    rng = np.random.default_rng(9)
    gamma = (1 + 0.005) / (1 - 0.005)
    sets = {"random": np.concatenate([rng.lognormal(0, 6, 1 << 20), -rng.lognormal(0, 6, 1 << 10)]),
            "boundaries": gamma ** np.arange(-4000, 4000, dtype=np.float64)}
    counts, moved = {}, {}
    for name, x in sets.items():
        t = torch.from_numpy(x)
        got, want = sketch.dd_bucket(t.to(cuda)).cpu().numpy(), sketch.dd_bucket(t).numpy()
        moved[name] = (x, got, want, np.flatnonzero(got != want))
        counts[name] = [int(len(moved[name][3])), len(x)]
    print(json.dumps({"dd_bucket_moved_on_the_card": counts}))
    for x, got, want, idx in moved.values():
        assert (np.abs(got[idx] - want[idx]) == 1).all()
        # a value on a boundary put one bucket up is sqrt(gamma) - 1 from its
        # representative, the bound itself, up to the rounding of both
        rep = sketch.dd_bucket_value(got[idx])
        assert (np.abs(rep - x[idx]) <= cs.DD_BOUND * (1 + 1e-9) * np.abs(x[idx])).all()
    assert counts["random"][0] <= counts["random"][1] // 1000


def test_dbgen_golden_at_sf1(cuda):
    """dbgen's SF-1 tables: Q1, Q6 and Q3 equal the TPC-H specification's
    published answers to the cent on the card, and Q13 its pinned rows;
    Q1 takes the piece path and launches grouped_piece_sums."""
    fields = cs.run_dbgen_golden(1.0, cs.DBGEN_TILE_ROWS, device=cuda)
    assert fields["correct"] and fields["rows"]["lineitem"] == 6_001_215
    assert fields["q1_piece_path"] and fields["q1_k2_launches"] == 2
