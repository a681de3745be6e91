"""velox_tpu_torch.ops.group_piece against the JAX package's
ops/pallas_group_piece: same numpy inputs through both, exact equality (the
sums are integer, so no tolerance applies).  The Pallas kernel runs in
interpret mode, its XLA twin as compiled for the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velox_tpu.ops import pallas_group_piece as ref
from velox_tpu_torch.ops import group_piece as port

G = 6
_BOUNDS = {  # column index -> (dtype, lo, hi) of the Q1-shaped operands
    0: (np.int32, 90000, 10500000),  # l_extendedprice
    1: (np.int16, 100, 5000),  # l_quantity
    2: (np.int8, 0, 10),  # l_discount
    3: (np.int8, 0, 8),  # l_tax
}


def _factor(mod, col, scale=1, offset=0):
    _, lo, hi = _BOUNDS[col]
    a, b = scale * lo + offset, scale * hi + offset
    return mod.Factor(col, scale, offset, min(a, b), max(a, b))


def _specs(mod):
    ep, qty, d = _factor(mod, 0), _factor(mod, 1), _factor(mod, 2)
    one_minus_d = _factor(mod, 2, -1, 100)
    one_plus_t = _factor(mod, 3, 1, 100)
    return {
        "count": [],
        "qty": [qty],
        "ep_chunked": [ep],
        "disc_price": [ep, one_minus_d],
        "charge": [ep, one_minus_d, one_plus_t],
        "disc": [d],
    }


def _inputs(n, seed, dead=0.1, gid_dtype=np.int8, groups=G):
    rng = np.random.default_rng(seed)
    cols = [
        rng.integers(lo, hi + 1, n).astype(dt) for dt, lo, hi in _BOUNDS.values()
    ]
    gid = rng.integers(0, groups, n).astype(gid_dtype)
    gid[rng.random(n) < dead] = -1
    return cols, gid


def _to_port_plan(p) -> port.SpecPlan:
    return port.SpecPlan(
        tuple(port.Factor(**dataclasses.asdict(f)) for f in p.factors),
        p.n_prefix, p.chunk_w, p.n_chunks, p.piece_bound,
    )


def _np_oracle(cols, gid, plans, groups):
    out = []
    for plan in plans:
        v = np.ones(len(gid), dtype=np.int64)
        for f in plan.factors:
            v = v * (f.scale * cols[f.col].astype(np.int64) + f.offset)
        s = np.zeros(groups, np.int64)
        live = gid >= 0
        np.add.at(s, gid[live], v[live])
        out.append(s)
    return out


@pytest.mark.parametrize("name", sorted(_specs(ref)))
@pytest.mark.parametrize("piece_max", [ref.PIECE_MAX, ref.PIECE_MAX_PALLAS])
def test_plan_spec_field_for_field(name, piece_max):
    r = ref.plan_spec(_specs(ref)[name], piece_max=piece_max)
    p = port.plan_spec(_specs(port)[name], piece_max=piece_max)
    assert r is not None and p is not None
    assert dataclasses.asdict(r) == dataclasses.asdict(p)


def test_plan_spec_refusals_match():
    for factors in (
        [(0, 1, 0, -5, 10)],  # negative lower bound
        [(0, 1, 0, 0, 1 << 31)],  # a single factor past int32
        [(0, 1, 0, 0, 1 << 20), (1, 1, 0, 0, 1 << 20), (2, 1, 0, 0, 1 << 30)],
    ):
        r = ref.plan_spec([ref.Factor(*f) for f in factors])
        p = port.plan_spec([port.Factor(*f) for f in factors])
        assert (r is None) == (p is None)
        if r is not None:
            assert dataclasses.asdict(r) == dataclasses.asdict(p)
    assert port.PIECE_MAX == ref.PIECE_MAX
    assert port.PIECE_MAX_PALLAS == ref.PIECE_MAX_PALLAS


@pytest.mark.parametrize("seed,n,gid_dtype", [(0, 4096, np.int8), (1, 2048, np.int32)])
def test_wrapper_matches_xla_form(seed, n, gid_dtype):
    cols, gid = _inputs(n, seed, gid_dtype=gid_dtype)
    ref_plans = tuple(ref.plan_spec(s) for s in _specs(ref).values())
    want = ref.grouped_piece_sums_xla(
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(gid), ref_plans, G
    )
    got = port.grouped_piece_sums(
        [torch.from_numpy(c) for c in cols],
        torch.from_numpy(gid),
        [_to_port_plan(p) for p in ref_plans],
        G,
    )
    oracle = _np_oracle(cols, gid, ref_plans, G)
    assert len(got) == len(want)
    for g, w, o in zip(got, want, oracle):
        assert g.dtype == torch.int64 and tuple(g.shape) == (G,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), o)


def test_wrapper_matches_pallas_interpret_with_chunked_specs():
    cols, gid = _inputs(4 * ref.BLOCK, seed=2)
    ref_plans = tuple(
        ref.plan_spec(s, piece_max=ref.PIECE_MAX_PALLAS) for s in _specs(ref).values()
    )
    assert any(p.n_chunks > 1 for p in ref_plans)  # the chunked form is exercised
    want = ref.grouped_piece_sums(
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(gid), ref_plans, G,
        interpret=True,
    )
    port_plans = [
        port.plan_spec(s, piece_max=port.PIECE_MAX_PALLAS)
        for s in _specs(port).values()
    ]
    got = port.grouped_piece_sums(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gid), port_plans, G
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_all_rows_dead_and_empty_groups():
    cols, gid = _inputs(1024, seed=3, dead=1.1)
    assert (gid == -1).all()
    plans = [port.plan_spec(s) for s in _specs(port).values()]
    got = port.grouped_piece_sums(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gid), plans, G
    )
    for g in got:
        assert not g.any()


def test_more_groups_than_int8_and_count_only():
    groups = 40
    cols, gid = _inputs(2048, seed=4, gid_dtype=np.int32, groups=groups)
    ref_plans = (ref.plan_spec([]),)
    want = ref.grouped_piece_sums_xla((), jnp.asarray(gid), ref_plans, groups)
    got = port.grouped_piece_sums(
        [], torch.from_numpy(gid), [port.plan_spec([])], groups
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[0].sum()) == int((gid >= 0).sum())


def test_plain_is_the_cpu_path_and_counts_no_launch():
    cols, gid = _inputs(1024, seed=5)
    plans = [port.plan_spec(s) for s in _specs(port).values()]
    before = port.grouped_piece_sums.launches
    got = port.grouped_piece_sums(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gid), plans, G
    )
    plain = port.grouped_piece_sums_plain(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gid), plans, G
    )
    assert port.grouped_piece_sums.launches == before
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


@pytest.mark.parametrize(
    "bad",
    ["gid_dtype", "length", "factor_col", "too_many_groups", "float_column"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    cols, gid = _inputs(1024, seed=6)
    tcols = [torch.from_numpy(c) for c in cols]
    tgid = torch.from_numpy(gid)
    plans = [port.plan_spec(s) for s in _specs(port).values()]
    groups = G
    if bad == "gid_dtype":
        tgid = tgid.to(torch.int64)
    elif bad == "length":
        tcols[0] = tcols[0][:-1]
    elif bad == "factor_col":
        plans = [port.SpecPlan((port.Factor(9, 1, 0, 0, 1),), 1, 0, 1, 1)]
    elif bad == "too_many_groups":
        groups = 2000  # 2000 groups x 6 specs x 8 B > 48 KB
    else:
        tcols[0] = tcols[0].to(torch.float32)
    with pytest.raises((TypeError, ValueError)):
        port.grouped_piece_sums(tcols, tgid, plans, groups)
