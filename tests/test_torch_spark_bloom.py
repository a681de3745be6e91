"""Spark bloom_filter_agg / might_contain of the port
(``utils/spark_bloom.py``, ``exec/sketch.py _rewrite_bloom``) against the JAX
package's: every case of ``tests/test_spark_bloom.py`` on the same rows, the
filters' bytes equal in both packages and to the host build of the Spark
wire format, and the device half (``twang_mix64``, ``bloom_mask``) on int64
lanes against the numpy uint64 reference bit for bit.  Also the plain
``utils/bloom.py`` filter's host and device tests, and the rule that a
literal filter's words go to a device once per bind, not once per tile.

Reference: velox/common/base/BloomFilter.h (blocked bloom wire format),
velox/functions/sparksql/aggregates/BloomFilterAggAggregate.cpp,
velox/functions/sparksql/MightContain.h, tests
BloomFilterAggAggregateTest.cpp / MightContainTest.cpp.
"""

import types

import numpy as np
import torch

import velox_tpu.dtypes as vt
import velox_tpu_torch.dtypes as pt
from velox_tpu.exec.runner import run_plan as ref_run_plan
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.utils import spark_bloom as ref_bloom
from velox_tpu_torch.exec.runner import LocalExecutor, run_plan
from velox_tpu_torch.io.table import Table
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import python_rows
from velox_tpu_torch.utils.spark_bloom import (
    bloom_mask,
    build_host,
    deserialize,
    might_contain_host,
    num_words,
    probe_uploads,
    serialize,
    twang_mix64,
    twang_mix64_np,
)

REF = types.SimpleNamespace(t=vt, Table=RefTable, B=RefBuilder,
                            run=lambda p: ref_run_plan(p))
PORT = types.SimpleNamespace(t=pt, Table=Table, B=PlanBuilder,
                             run=lambda p: run_plan(p, device="cpu"))


def scan(k, validities=None, filter=None, **arrays):
    names = list(arrays)
    t = k.Table(
        k.t.RowType(names, [k.t.BIGINT] * len(names)),
        {n: np.asarray(v, np.int64) for n, v in arrays.items()},
        validities=validities or {},
    )
    return k.B().table_scan(t, filter=filter) if filter else k.B().table_scan(t)


def both(make):
    """The plan ``make(k)`` through both packages; asserts their rows are
    equal (bytes exactly) and returns the port's."""
    got, want = python_rows(PORT.run(make(PORT))), python_rows(REF.run(make(REF)))
    assert got == want
    return got


class TestFormat:
    def test_serialize_roundtrip(self):
        words = np.arange(8, dtype=np.uint64) * np.uint64(0x123456789)
        data = serialize(words)
        assert data[0] == 1  # version
        assert data == ref_bloom.serialize(words)
        np.testing.assert_array_equal(deserialize(data), words)

    def test_twang_mix64_matches_scalar_reference(self):
        # vectorized np path and the int64-lane device path vs an
        # independent python-int transcription of folly's twang_mix64
        M = (1 << 64) - 1

        def twang(key):
            key = ((~key) + (key << 21)) & M
            key ^= key >> 24
            key = (key + (key << 3) + (key << 8)) & M
            key ^= key >> 14
            key = (key + (key << 2) + (key << 4)) & M
            key ^= key >> 28
            key = (key + (key << 31)) & M
            return key

        vals = np.array([0, 1, -1, 123456789, 2**62, -(2**63), 2**63 - 1], dtype=np.int64)
        exp = [twang(int(np.uint64(v))) for v in vals]
        assert twang_mix64_np(vals).tolist() == exp
        dev = twang_mix64(torch.from_numpy(vals)).numpy().view(np.uint64)
        assert dev.tolist() == exp

    def test_device_half_matches_numpy(self):
        """twang_mix64 / bloom_mask / the word index on int64 lanes equal the
        numpy uint64 build bit for bit, on random keys and the int64 edges."""
        rng = np.random.default_rng(8)
        vals = np.concatenate([rng.integers(-(1 << 63), (1 << 63) - 1, 20_000, dtype=np.int64),
                               [0, -1, 1, -(1 << 63), (1 << 63) - 1]]).astype(np.int64)
        h_np = twang_mix64_np(vals)
        h = twang_mix64(torch.from_numpy(vals))
        np.testing.assert_array_equal(h.numpy().view(np.uint64), h_np)
        one = np.uint64(1)
        mask_np = ((one << (h_np & np.uint64(63))) | (one << ((h_np >> np.uint64(6)) & np.uint64(63)))
                   | (one << ((h_np >> np.uint64(12)) & np.uint64(63)))
                   | (one << ((h_np >> np.uint64(18)) & np.uint64(63))))
        np.testing.assert_array_equal(bloom_mask(h).numpy().view(np.uint64), mask_np)

    def test_num_words_default(self):
        # default numBits 8388608 capped at 4194304 -> capacity 262144
        # -> words = nextPow2(262144)/4 = 65536
        assert num_words(8_388_608) == 65536 == ref_bloom.num_words(8_388_608)
        assert num_words(64) == 4  # floor

    def test_host_build_probe(self):
        vals = np.arange(0, 100000, 7, dtype=np.int64)
        data = build_host(vals, num_bits=1 << 20)
        assert data == ref_bloom.build_host(vals, num_bits=1 << 20)
        hits = might_contain_host(data, vals)
        assert hits.all(), "no false negatives ever"
        probe = np.arange(1, 100000, 7919, dtype=np.int64)
        misses = might_contain_host(data, probe)
        np.testing.assert_array_equal(misses, ref_bloom.might_contain_host(data, probe))
        assert misses.mean() < 0.25


class TestAgg:
    def test_agg_matches_host_oracle(self):
        vals = np.array([10, 20, 30, 12345678901234], np.int64)
        out = both(lambda k: scan(k, x=vals).aggregation([], ["bloom_filter_agg(x) as bf"]).build())
        assert out["bf"][0] == build_host(vals)

    def test_agg_size_args(self):
        vals = np.arange(100, dtype=np.int64)
        out = both(lambda k: scan(k, x=vals)
                   .aggregation([], ["bloom_filter_agg(x, 100, 4096) as bf"]).build())
        data = out["bf"][0]
        assert len(deserialize(data)) == num_words(4096)
        assert data == build_host(vals, num_bits=4096)

    def test_agg_grouped(self):
        g = np.array([0, 1, 0, 1, 0], np.int64)
        x = np.array([1, 2, 3, 4, 5], np.int64)
        out = both(lambda k: scan(k, g=g, x=x)
                   .aggregation(["g"], ["bloom_filter_agg(x, 10, 1024) as bf"])
                   .orderby(["g"]).build())
        assert out["bf"][0] == build_host(x[g == 0], num_bits=1024)
        assert out["bf"][1] == build_host(x[g == 1], num_bits=1024)

    def test_agg_mixed_node(self):
        vals = np.arange(50, dtype=np.int64)
        out = both(lambda k: scan(k, x=vals).aggregation(
            [], ["bloom_filter_agg(x, 10, 1024) as bf", "count(*) as c"]).build())
        assert out["c"] == [50]
        assert out["bf"][0] == build_host(vals, num_bits=1024)

    def test_agg_skips_nulls(self):
        out = both(lambda k: scan(k, validities={"x": np.array([True, False, True])},
                                  x=np.array([1, 2, 3]))
                   .aggregation([], ["bloom_filter_agg(x, 10, 1024) as bf"]).build())
        assert out["bf"][0] == build_host(np.array([1, 3], np.int64), num_bits=1024)

    def test_all_null_group_yields_null_filter(self):
        # groups whose x values are all NULL still appear, with a NULL filter
        out = both(lambda k: scan(
            k, validities={"x": np.array([True, True, False, False])},
            g=np.array([1, 1, 2, 2]), x=np.array([7, 8, 0, 0]),
        ).aggregation(["g"], ["bloom_filter_agg(x, 10, 1024) as bf"]).orderby(["g"]).build())
        assert out["g"] == [1, 2]
        assert out["bf"] == [build_host(np.array([7, 8], np.int64), num_bits=1024), None]

    def test_empty_input_yields_null_filter(self):
        # a global agg over zero rows emits one row with a NULL filter
        out = both(lambda k: scan(k, filter="x > 100", x=np.array([1, 2, 3]))
                   .aggregation([], ["bloom_filter_agg(x, 10, 1024) as bf"]).build())
        assert out == {"bf": [None]}


class TestMightContain:
    def test_probe_literal(self):
        vals = np.array([10, 20, 30], np.int64)
        data = build_host(vals, num_bits=1024)
        out = both(lambda k: scan(k, y=[10, 11, 30, 999])
                   .project([f"might_contain(X'{data.hex()}', y) as m"]).build())
        assert out["m"] == might_contain_host(data, np.array([10, 11, 30, 999])).tolist()
        assert out["m"][0] and out["m"][2]

    def test_probe_agg_roundtrip(self):
        """The aggregate's output probes correctly through might_contain."""
        build_vals = np.arange(0, 1000, 3, dtype=np.int64)
        bf = both(lambda k: scan(k, x=build_vals)
                  .aggregation([], ["bloom_filter_agg(x) as bf"]).build())["bf"][0]
        probe = np.arange(0, 1000, dtype=np.int64)
        out = both(lambda k: scan(k, y=probe)
                   .project([f"might_contain(X'{bf.hex()}', y) as m"]).build())
        got = np.asarray(out["m"])
        assert got[::3].all(), "no false negatives"
        np.testing.assert_array_equal(got, might_contain_host(bf, probe))

    def test_null_filter_probes_null(self):
        # a NULL filter argument gets default-null semantics (NULL out),
        # unlike an EMPTY filter (isSet() ?: false -> constant false)
        out = both(lambda k: scan(k, y=[1, 2])
                   .project(["might_contain(cast(null as varbinary), y) as m"]).build())
        assert out["m"] == [None, None]

    def test_words_go_to_the_device_once_per_bind(self):
        """Eight tiles probe one literal filter: its words are put on the
        batch's device at the first probe and reused for every later tile."""
        data = build_host(np.arange(0, 5000, 5, dtype=np.int64), num_bits=1 << 16)
        probe = np.arange(8 * 1024, dtype=np.int64)
        plan = (scan(PORT, y=probe).project([f"might_contain(X'{data.hex()}', y) as m"]).build())
        ex = LocalExecutor(plan, tile_rows=1024, device="cpu")
        got = np.asarray(ex.run().columns["m"])
        np.testing.assert_array_equal(got, might_contain_host(data, probe))
        from velox_tpu_torch.utils.spark_bloom import register_bloom_probe

        assert probe_uploads(register_bloom_probe(data)) == 1


def test_varbinary_hex_literal_parses():
    from velox_tpu_torch.dtypes import RowType, TypeKind
    from velox_tpu_torch.expr.parser import parse_expr

    e = parse_expr("X'AB12'", RowType([], []))
    assert e.dtype.kind == TypeKind.VARBINARY
    assert e.value == bytes.fromhex("AB12")


def test_plain_bloom_filter_matches_reference():
    """utils/bloom.py: the same words as the JAX package's filter, and the
    device membership test equal to the host one and to the JAX package's."""
    from velox_tpu.utils.bloom import BloomFilter as RefBloom
    from velox_tpu_torch.utils.bloom import BloomFilter

    keys = np.arange(0, 50_000, 3, dtype=np.int64)
    probe = np.arange(0, 50_000, dtype=np.int64)
    ref, port = RefBloom(capacity=len(keys)), BloomFilter(capacity=len(keys))
    ref.add(keys)
    port.add(keys)
    np.testing.assert_array_equal(port.words, ref.words)
    host = port.might_contain_host(probe)
    assert host[::3].all()
    np.testing.assert_array_equal(host, ref.might_contain_host(probe))
    dev = port.might_contain_device(torch.from_numpy(probe)).numpy()
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(np.asarray(ref.might_contain_device(probe)), host)
