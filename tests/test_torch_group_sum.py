"""velox_tpu_torch.ops.group_sum against the JAX package's
ops/pallas_group_sum.grouped_int64_sums (Pallas interpret mode): same numpy
inputs, exact equality.  Values near +-2**62 make the per-group sums wrap mod
2**64, so the comparison shows that both wrap alike."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velox_tpu.ops.pallas_group_sum import grouped_int64_sums as ref_grouped_int64_sums
from velox_tpu_torch.ops.group_sum import grouped_int64_sums, grouped_int64_sums_plain
from velox_tpu_torch.ops.segmented import direct_group_reduce


def _inputs(cap, ncols, groups, seed, keep=0.9):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-(1 << 62), 1 << 62, cap, dtype=np.int64) for _ in range(ncols)]
    gids = rng.integers(0, groups, cap, dtype=np.int32)
    mask = rng.random(cap) < keep
    return cols, gids, mask


def _wrapping_oracle(cols, gids, mask, groups):
    out = []
    for c in cols:
        s = np.zeros(groups, np.uint64)
        np.add.at(s, gids[mask], c[mask].view(np.uint64))
        out.append(s.view(np.int64))
    return out


@pytest.mark.parametrize(
    "cap,ncols,groups,seed", [(1 << 13, 3, 8, 0), (1 << 12, 2, 3, 3), (2048, 1, 12, 5)]
)
def test_matches_pallas_interpret_and_wraps(cap, ncols, groups, seed):
    cols, gids, mask = _inputs(cap, ncols, groups, seed)
    want = ref_grouped_int64_sums(
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(gids), jnp.asarray(mask),
        num_groups=groups, interpret=True,
    )
    got = grouped_int64_sums(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gids),
        torch.from_numpy(mask), groups,
    )
    oracle = _wrapping_oracle(cols, gids, mask, groups)
    exact = [
        [int(c[mask & (gids == g)].astype(object).sum()) for g in range(groups)]
        for c in cols
    ]
    assert any(abs(x) >= 1 << 63 for row in exact for x in row)  # the wrap shows
    assert len(got) == ncols
    for g, w, o in zip(got, want, oracle):
        assert g.dtype == torch.int64 and tuple(g.shape) == (groups,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), o)


def test_mask_all_false_and_out_of_range_groups():
    cols, gids, mask = _inputs(2048, 2, 4, seed=8)
    t = [torch.from_numpy(c) for c in cols]
    none = grouped_int64_sums(t, torch.from_numpy(gids), torch.zeros(2048, dtype=torch.bool), 4)
    assert all(not x.any() for x in none)
    # a group id outside [0, G) contributes nowhere, as in the reference's one-hot
    got = grouped_int64_sums(t, torch.from_numpy(gids), torch.from_numpy(mask), 2)
    want = ref_grouped_int64_sums(
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(gids), jnp.asarray(mask),
        num_groups=2, interpret=True,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_agrees_with_direct_group_reduce():
    cols, gids, mask = _inputs(4096, 2, 5, seed=11)
    got = grouped_int64_sums(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(gids),
        torch.from_numpy(mask), 5,
    )
    for c, g in zip(cols, got):
        one = direct_group_reduce(
            torch.from_numpy(c), torch.from_numpy(mask), torch.from_numpy(gids), 5, "sum"
        )
        assert torch.equal(one, g)


def test_plain_is_the_cpu_path_and_counts_no_launch():
    cols, gids, mask = _inputs(2048, 2, 4, seed=12)
    args = ([torch.from_numpy(c) for c in cols], torch.from_numpy(gids), torch.from_numpy(mask), 4)
    before = grouped_int64_sums.launches
    got = grouped_int64_sums(*args)
    plain = grouped_int64_sums_plain(*args)
    assert grouped_int64_sums.launches == before
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


@pytest.mark.parametrize("bad", ["no_columns", "gid_dtype", "int32_column", "table_too_large", "length"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    cols, gids, mask = _inputs(2048, 2, 4, seed=13)
    t = [torch.from_numpy(c) for c in cols]
    tg, tm, groups = torch.from_numpy(gids), torch.from_numpy(mask), 4
    if bad == "no_columns":
        t = []
    elif bad == "gid_dtype":
        tg = tg.to(torch.int64)
    elif bad == "int32_column":
        t[0] = t[0].to(torch.int32)
    elif bad == "table_too_large":
        groups = 4000  # 4000 groups x 2 columns x 8 B > 48 KB: raises, no fallback
    else:
        tm = tm[:-1]
    with pytest.raises((TypeError, ValueError)):
        grouped_int64_sums(t, tg, tm, groups)
