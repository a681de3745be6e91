"""The unique-build sort-merge join of the port against the JAX package's, on
the same numpy inputs: key normalization, the device build (from a collect
pipeline's tiles and from an aggregation's uploaded result), the fused probe and the classification probe, and whole join plans
through both ``LocalExecutor``s (INNER / LEFT / LEFT_SEMI / ANTI, one- and
two-column keys, NULL keys, probe keys outside the build range, an empty build
side).  Every column agrees exactly: the joins move values, they compute none
(DOUBLE payloads are compared bit for bit too)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import velox_tpu as vt
from velox_tpu.exec import joins as ref_joins
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.vector.string_table import StringTable as RefStrings
from velox_tpu_torch.exec import joins as port_joins
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor
from velox_tpu_torch.plan import PlanBuilder as PortBuilder
from velox_tpu_torch.testing import table_from_numpy

N_PROBE, N_BUILD = 5000, 700
_TAGS = ["", "red", "blue", "green"]


def _pair(names, type_strings, ref_types, cols, strings=None, validities=None):
    port = table_from_numpy(names, type_strings, cols, strings, validities)
    ref = RefTable(
        vt.RowType(names, ref_types), dict(cols),
        {k: RefStrings.from_values(v) for k, v in (strings or {}).items()},
        dict(validities or {}),
    )
    return ref, port


def _data(wide=False, seed=0):
    """(probe pair, build pair).  Build keys (b1, b2) are unique as a pair and
    b1 alone is unique too; probe keys overshoot the build's range on both
    sides and hold NULLs.  ``wide`` spreads b1 over 2^61 (no packed probe word
    fits: the classification path runs) and b2 over 2^40 (two-limb keys)."""
    rng = np.random.default_rng(seed)
    step = (1 << 61) // 1000 if wide else 1
    step2 = (1 << 40) // 4 if wide else 1
    b1 = rng.choice(np.arange(100, 900), N_BUILD, replace=False).astype(np.int64)
    build_cols = {
        "b1": b1 * step,
        "b2": (b1 % 4).astype(np.int64) * step2,
        "bval": rng.integers(-500, 500, N_BUILD).astype(np.int64),
        "bday": rng.integers(9000, 9100, N_BUILD).astype(np.int32),
        "bdbl": rng.normal(size=N_BUILD),
        "btag": rng.integers(1, 4, N_BUILD).astype(np.int32),
    }
    build_valid = {"bval": rng.random(N_BUILD) < 0.9, "b1": rng.random(N_BUILD) < 0.97}
    p1 = rng.integers(0, 1000, N_PROBE).astype(np.int64)
    probe_cols = {
        "p1": p1 * step,
        "p2": (np.where(rng.random(N_PROBE) < 0.8, p1 % 4, rng.integers(0, 6, N_PROBE))).astype(np.int64) * step2,
        "pv": rng.integers(-(1 << 40), 1 << 40, N_PROBE).astype(np.int64),
        "ptag": rng.integers(1, 4, N_PROBE).astype(np.int32),
        "pz": rng.integers(0, 3, N_PROBE).astype(np.int64),
        "p3": p1 * step,  # p1 without NULLs
    }
    probe_valid = {"p1": rng.random(N_PROBE) < 0.95, "pv": rng.random(N_PROBE) < 0.9}
    build = _pair(
        list(build_cols), ["BIGINT", "BIGINT", "BIGINT", "DATE", "DOUBLE", "VARCHAR"],
        [vt.BIGINT, vt.BIGINT, vt.BIGINT, vt.DATE, vt.DOUBLE, vt.VARCHAR],
        build_cols, {"btag": _TAGS}, build_valid,
    )
    probe = _pair(
        list(probe_cols), ["BIGINT", "BIGINT", "BIGINT", "VARCHAR", "BIGINT", "BIGINT"],
        [vt.BIGINT, vt.BIGINT, vt.BIGINT, vt.VARCHAR, vt.BIGINT, vt.BIGINT],
        probe_cols, {"ptag": _TAGS}, probe_valid,
    )
    return probe, build


def _same_table(got, want):
    assert list(got.schema.names) == list(want.schema.names)
    assert [str(t) for t in got.schema.types] == [str(t) for t in want.schema.types]
    assert got.num_rows == want.num_rows
    assert set(got.validities) == set(want.validities)
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        valid = want.validities.get(name)
        if valid is not None:
            np.testing.assert_array_equal(got.validities[name], valid, err_msg=name)
            g, w = g[valid], w[valid]
        if dtype.is_string:
            g = got.string_tables[name].decode(g)
            w = want.string_tables[name].decode(w)
        else:
            assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# which build columns ride along decides the probe's tier: integers with
# bounds pack into the build word (tier 1), a DOUBLE forces gathers (tier 2)
_PAYLOADS = {
    "packed": ["bval", "bday", "btag"],
    "gathered": ["bval", "bdbl"],
}


def _join_plan(builder, probe, build, join_type, n_keys, payload, build_filter=None):
    semi = join_type in ("left_semi", "anti")
    right = builder().table_scan(build, filter=build_filter)
    left_keys = ["p1", "p2"][:n_keys]
    right_keys = ["b1", "b2"][:n_keys]
    out = ["p1", "pv", "ptag"] + ([] if semi else _PAYLOADS[payload])
    b = (
        builder()
        .table_scan(probe, filter="pz < 2")
        .hash_join(right, left_keys, right_keys, output=out, join_type=join_type)
    )
    return b.orderby([f"{c} nulls first" for c in out]).build()


@pytest.mark.parametrize("tile_rows", [1 << 10, 1 << 20])
@pytest.mark.parametrize("n_keys", [1, 2])
@pytest.mark.parametrize("join_type", ["inner", "left", "left_semi", "anti"])
def test_join_plan_matches_reference(join_type, n_keys, tile_rows):
    (ref_p, port_p), (ref_b, port_b) = _data()
    payload = "packed" if n_keys == 1 else "gathered"
    ref = RefExecutor(
        _join_plan(RefBuilder, ref_p, ref_b, join_type, n_keys, payload), tile_rows=tile_rows
    )
    port = PortExecutor(
        _join_plan(PortBuilder, port_p, port_b, join_type, n_keys, payload),
        tile_rows=tile_rows, device="cpu",
    )
    assert port.kind == ref.kind == "collect"
    r_ex = [s[1] for s in ref.lin.steps if s[0] == "join"][0]
    p_ex = [s[1] for s in port.lin.steps if s[0] == "join"][0]
    assert p_ex.build_size == r_ex.build_size
    assert p_ex.key_range == r_ex.key_range
    assert p_ex.n_valid_build_keys == r_ex.n_valid_build_keys
    assert p_ex.build_has_null_key == r_ex.build_has_null_key
    assert (p_ex.bp_plan is None) == (r_ex.bp_plan is None)
    assert p_ex.probe_output_capacity(port.capacity) == r_ex.probe_output_capacity(ref.capacity)
    np.testing.assert_array_equal(p_ex.build_keys.numpy(), np.asarray(r_ex.build_keys))
    assert port.pool.reserved >= p_ex.state_bytes() > 0
    _same_table(port.run(), ref.run())


@pytest.mark.parametrize("join_type", ["inner", "left", "anti"])
def test_wide_keys_take_the_classification_path(join_type):
    """A key range of 2^61 leaves no room for the packed probe word, and two
    such columns need two limbs: ``_lookup_sorted`` runs, not the fused probe."""
    (ref_p, port_p), (ref_b, port_b) = _data(wide=True)
    for n_keys in (1, 2):
        ref = RefExecutor(
            _join_plan(RefBuilder, ref_p, ref_b, join_type, n_keys, "gathered"), tile_rows=1 << 11
        )
        port = PortExecutor(
            _join_plan(PortBuilder, port_p, port_b, join_type, n_keys, "gathered"),
            tile_rows=1 << 11, device="cpu",
        )
        p_ex = [s[1] for s in port.lin.steps if s[0] == "join"][0]
        assert p_ex._fused_static(port.capacity) is None
        assert p_ex.probe_output_capacity(port.capacity) == port.capacity
        assert (p_ex.build_keys_hi is not None) == (n_keys == 2)
        _same_table(port.run(), ref.run())


@pytest.mark.parametrize("join_type", ["inner", "left", "left_semi", "anti"])
def test_empty_build_side(join_type):
    (ref_p, port_p), (ref_b, port_b) = _data()
    args = (join_type, 1, "packed", "bval < -100000")
    ref = RefExecutor(_join_plan(RefBuilder, ref_p, ref_b, *args), tile_rows=1 << 11)
    port = PortExecutor(_join_plan(PortBuilder, port_p, port_b, *args), tile_rows=1 << 11, device="cpu")
    got = port.run()
    _same_table(got, ref.run())
    n_probe = int((port_p.columns["pz"] < 2).sum())
    assert got.num_rows == (n_probe if join_type in ("left", "anti") else 0)


@pytest.mark.parametrize("join_type", ["inner", "left"])
def test_host_build_from_an_aggregated_build_side(join_type):
    """A build side that ends in an aggregation is executed to a host Table,
    uploaded, and ``HashJoinExec.build`` sorts it on the device like any
    other (TPC-H Q13's shape).  The aggregation above the join then groups on
    the join's output."""
    (ref_p, port_p), (ref_b, port_b) = _data()

    def plan(builder, probe, build):
        counts = builder().table_scan(build).aggregation(["b2"], ["count(*) as cnt", "sum(bval) as s"])
        return (
            builder().table_scan(probe)
            .hash_join(counts, ["p2"], ["b2"], output=["p1", "cnt", "s"], join_type=join_type)
            .project(["coalesce(cnt, 0) as c", "s", "p1"])
            .aggregation(["c"], ["count(*) as n", "sum(s) as ss", "min(p1) as lo"])
            .orderby(["c"])
            .build()
        )

    ref = RefExecutor(plan(RefBuilder, ref_p, ref_b), tile_rows=1 << 11)
    port = PortExecutor(plan(PortBuilder, port_p, port_b), tile_rows=1 << 11, device="cpu")
    assert port.kind == ref.kind == "sort_agg_device"
    assert [k.name for k in port.agg_exec.key_infos] == [k.name for k in ref.agg_exec.key_infos]
    assert port.build_seconds > 0
    _same_table(port.run(), ref.run())


def test_presorted_grouping_after_a_join():
    """Several tiles, grouping on the join key first: the join's key-ordered
    output is grouped without a sort and the carry merge collapses the runs
    that secondary keys split (TPC-H Q3's shape, with its device TopN)."""
    (ref_p, port_p), (ref_b, port_b) = _data()

    def plan(builder, probe, build):
        return (
            builder().table_scan(probe, filter="pz < 2 and p3 < 350")  # ~660 groups
            .hash_join(builder().table_scan(build), ["p3"], ["b1"], output=["p3", "pv", "bday", "ptag"])
            .aggregation(["p3", "bday", "ptag"], ["sum(pv) as s", "count(*) as n"])
            .topn(["s desc", "bday", "p3"], 7)
            .build()
        )

    ref = RefExecutor(plan(RefBuilder, ref_p, ref_b), tile_rows=1 << 10)
    port = PortExecutor(plan(PortBuilder, port_p, port_b), tile_rows=1 << 10, device="cpu")
    assert port.agg_exec.presorted and ref.agg_exec.grouping.presorted
    assert port.agg_exec.grouping.presorted
    got = port.run()
    assert port.carry_groups is not None and not port.carry_overflowed
    assert port._device_topn_plan()[0] == 7
    _same_table(got, ref.run())
    one_tile = PortExecutor(plan(PortBuilder, port_p, port_b), tile_rows=1 << 20, device="cpu")
    assert not one_tile.agg_exec.presorted
    _same_table(one_tile.run(), got)


def test_right_join_flips_and_inner_filter_lowers():
    (ref_p, port_p), (ref_b, port_b) = _data()

    def plan(builder, probe, build, which):
        if which == "right":
            # build RIGHT JOIN probe == probe LEFT JOIN build
            b = builder().table_scan(build).hash_join(
                builder().table_scan(probe), ["b1"], ["p1"],
                output=["p1", "pv", "bval"], join_type="right",
            )
        else:
            b = builder().table_scan(probe).hash_join(
                builder().table_scan(build), ["p1"], ["b1"],
                output=["p1", "pv", "bval"], filter="pv > bval * 1000",
            )
        return b.orderby(["p1 nulls first", "pv nulls first", "bval nulls first"]).build()

    for which in ("right", "filtered_inner"):
        ref = RefExecutor(plan(RefBuilder, ref_p, ref_b, which), tile_rows=1 << 11)
        port = PortExecutor(plan(PortBuilder, port_p, port_b, which), tile_rows=1 << 11, device="cpu")
        assert [s[0] for s in port.lin.steps] == [s[0] for s in ref.lin.steps]
        _same_table(port.run(), ref.run())


def test_what_is_not_ported_raises_by_name():
    """What the unique-build slice refused now runs (a duplicate-key build
    from a scan or from an aggregation, a LEFT join's filter) and gives the
    JAX package's rows; FULL joins and the lowerings that need UNION ALL
    still raise by name."""
    (ref_p, port_p), (ref_b, port_b) = _data()

    def plans(builder, p, b):
        scan_p = lambda: builder().table_scan(p)  # noqa: E731
        scan_b = lambda: builder().table_scan(b)  # noqa: E731
        agg_b = scan_b().aggregation(["b1"], ["min(b2) as b2"])
        return {
            # b2 alone repeats: the build side needs the expansion join
            "dup": scan_p().hash_join(scan_b(), ["p2"], ["b2"], output=["p1", "bval"]),
            # ... from an aggregated build side too
            "dup_agg": scan_p().hash_join(agg_b, ["p2"], ["b2"], output=["p1"]),
            "left_filter": scan_p().hash_join(
                scan_b(), ["p1"], ["b1"], output=["p1", "pv", "bval"], join_type="left",
                filter="pv > bval",
            ),
        }

    ref_plans, port_plans = plans(RefBuilder, ref_p, ref_b), plans(PortBuilder, port_p, port_b)
    for name in ref_plans:
        keys = list(ref_plans[name].schema.names)
        ref = RefExecutor(ref_plans[name].orderby(keys).build(), tile_rows=1 << 11)
        port = PortExecutor(port_plans[name].orderby(keys).build(), tile_rows=1 << 11, device="cpu")
        assert [s[0] for s in port._all_steps] == [s[0] for s in ref._all_steps], name
        _same_table(port.run(), ref.run())
    # the device build finds the duplicates and holds the per-key runs:
    # each valid slot's run start and length over the sorted b2 values
    dup = plans(PortBuilder, port_p, port_b)["dup"].build()
    built = port_joins.HashJoinExec.build(dup, *PortExecutor(dup.right, device="cpu").run_device())
    b2 = np.sort(port_b.columns["b2"])
    starts = np.flatnonzero(np.concatenate([[True], b2[1:] != b2[:-1]]))
    lengths = np.diff(np.append(starts, len(b2)))
    assert built.expansion and built.n_valid_build_keys == N_BUILD
    assert built.build_size == 1024 and int(built.build_valid.sum()) == N_BUILD
    np.testing.assert_array_equal(built.build_keys[:N_BUILD].numpy(), b2)
    np.testing.assert_array_equal(built.run_start[:N_BUILD].numpy(), np.repeat(starts, lengths))
    np.testing.assert_array_equal(built.run_count[:N_BUILD].numpy(), np.repeat(lengths, lengths))
    scan_p = lambda: PortBuilder().table_scan(port_p)  # noqa: E731
    scan_b = lambda: PortBuilder().table_scan(port_b)  # noqa: E731
    # FULL joins and the lowerings that needed UNION ALL now run too (their
    # rows are held against the JAX package in test_torch_setops_joins.py);
    # the split dispatch, which exists for the JAX package's compiler, raises
    full = scan_p().hash_join(scan_b(), ["p1"], ["b1"], output=["p1"], join_type="full").build()
    full_ex = PortExecutor(full, device="cpu")
    assert [s[0] for s in full_ex._all_steps] == ["xjoin"]
    assert full_ex.run().num_rows >= N_PROBE
    for name in ("rewrite_full_filter", "rewrite_null_aware_anti_filter"):
        assert callable(getattr(port_joins, name))
    ok = scan_p().hash_join(scan_b(), ["p1"], ["b1"], output=["p1"]).build()
    ex = [s[1] for s in PortExecutor(ok, device="cpu").lin.steps if s[0] == "join"][0]
    with pytest.raises(NotImplementedError, match="probe_split_host"):
        ex.probe_split_host(None)


BOUNDS = [
    ([0, 5], [100, 9]),
    ([-(1 << 40), 0], [1 << 40, 1 << 30]),  # 41 + 31 bits: two limbs
    ([0], [(1 << 63) - 1]),
    ([3, 3, 3], [3, 3, 3]),
]


@pytest.mark.parametrize("los,his", BOUNDS)
def test_normalized_key(los, his):
    want = ref_joins._NormalizedKey.fit_from_bounds(los, his)
    got = port_joins._NormalizedKey.fit_from_bounds(los, his)
    np.testing.assert_array_equal(got.mins, want.mins)
    np.testing.assert_array_equal(got.maxs, want.maxs)
    np.testing.assert_array_equal(got.shifts, want.shifts)
    assert got.split == want.split and got.two_limb == want.two_limb
    rng = np.random.default_rng(0)
    n = 512
    arrays = []
    for lo, hi in zip(los, his):
        a = (lo + (rng.random(n) * (float(hi) - float(lo))).astype(np.int64)).astype(np.int64)
        a[0], a[1] = lo, hi
        arrays.append(np.clip(a, lo, hi))
    (g_hi, g_lo), ok = got.pack_device_limbs(
        [torch.as_tensor(a) for a in arrays], torch.ones(n, dtype=torch.bool)
    )
    w_hi, w_lo = want.pack_host_limbs(arrays)
    assert bool(ok.all())
    np.testing.assert_array_equal(g_lo.numpy(), w_lo)
    assert (g_hi is None) == (w_hi is None)
    if g_hi is not None:
        np.testing.assert_array_equal(g_hi.numpy(), w_hi)
    # device packing: rows out of range or invalid pack to -1 in every limb
    probe = [a.copy() for a in arrays]
    if his[0] < (1 << 62):
        probe[0][2] = his[0] + 1
    valid = rng.random(n) < 0.9
    (d_hi, d_lo), d_ok = got.pack_device_limbs(
        [torch.from_numpy(a) for a in probe], torch.from_numpy(valid)
    )
    (r_hi, r_lo), r_ok = want.pack_device_limbs(
        [jnp.asarray(a) for a in probe], jnp.asarray(valid)
    )
    np.testing.assert_array_equal(d_ok.numpy(), np.asarray(r_ok))
    np.testing.assert_array_equal(d_lo.numpy(), np.asarray(r_lo))
    if d_hi is not None:
        np.testing.assert_array_equal(d_hi.numpy(), np.asarray(r_hi))
    assert (d_lo.numpy()[~d_ok.numpy()] == -1).all()


def test_normalized_key_refuses_three_limbs():
    with pytest.raises(port_joins.JoinBuildError, match="two int64 limbs"):
        port_joins._NormalizedKey.fit_from_bounds([0, 0, 0], [1 << 50, 1 << 50, 1 << 50])


def test_key_codes_on_edge_values():
    keys = np.asarray(
        [np.iinfo(np.int64).min, -1, 9, 10, 11, 20, 21, np.iinfo(np.int64).max], dtype=np.int64
    )
    lo, hi = 10, 20
    span = hi - lo + 2
    want = ref_joins._key_codes(jnp.asarray(keys), lo, span)
    got = port_joins._key_codes(torch.from_numpy(keys), lo, span)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().tolist() == [0, 0, 0, 1, 2, 11, 12, 12]
