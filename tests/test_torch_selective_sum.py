"""velox_tpu_torch.ops.selective_sum against the JAX package's
ops/pallas_kernels.selective_sum (Pallas interpret mode) and selective_sum_xla:
same numpy inputs, exact equality (integer sums)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velox_tpu.ops.pallas_kernels import selective_sum as ref_selective_sum
from velox_tpu.ops.pallas_kernels import selective_sum_xla
from velox_tpu_torch.ops.selective_sum import selective_sum, selective_sum_plain

_BANDS = [(8766, 9130), (5, 7), (-(1 << 62), 2399)]  # Q6's three bands


def _inputs(n, n_filters, seed):
    rng = np.random.default_rng(seed)
    values = rng.integers(-(1 << 45), 1 << 45, n, dtype=np.int64)
    filters = [
        rng.integers(8000, 10000, n, dtype=np.int64),
        rng.integers(0, 11, n, dtype=np.int64),
        rng.integers(100, 5001, n, dtype=np.int64),
    ][:n_filters]
    return values, filters, _BANDS[:n_filters]


def _ints(triple):
    return tuple(int(np.asarray(x)) for x in triple)


@pytest.mark.parametrize("n_filters", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 1000, 4097])  # ragged: no multiple of any tile
def test_matches_xla_form(n_filters, n):
    values, filters, bounds = _inputs(n, n_filters, seed=n + n_filters)
    want = _ints(
        selective_sum_xla(
            jnp.asarray(values), [jnp.asarray(f) for f in filters], bounds
        )
    )
    got = selective_sum(
        torch.from_numpy(values), [torch.from_numpy(f) for f in filters], bounds
    )
    assert all(g.dtype == torch.int64 and g.dim() == 0 for g in got)
    assert tuple(int(g) for g in got) == want
    hi, lo, cnt = want
    keep = np.ones(n, bool)
    for f, (a, b) in zip(filters, bounds):
        keep &= (f >= a) & (f <= b)
    assert hi * (1 << 32) + lo == int(values[keep].astype(object).sum())
    assert cnt == int(keep.sum())


@pytest.mark.parametrize("n_filters", [0, 1, 3])
def test_matches_pallas_interpret(n_filters):
    values, filters, bounds = _inputs(3001, n_filters, seed=40 + n_filters)
    want = _ints(
        ref_selective_sum(
            jnp.asarray(values), [jnp.asarray(f) for f in filters], bounds,
            interpret=True,
        )
    )
    got = selective_sum(
        torch.from_numpy(values), [torch.from_numpy(f) for f in filters], bounds
    )
    assert tuple(int(g) for g in got) == want


def test_all_negative_values_and_nothing_passing():
    values = -np.arange(1, 2001, dtype=np.int64) * (1 << 33)
    f = np.arange(2000, dtype=np.int64)
    got = selective_sum(torch.from_numpy(values), [torch.from_numpy(f)], [(0, 1999)])
    want = _ints(selective_sum_xla(jnp.asarray(values), [jnp.asarray(f)], [(0, 1999)]))
    assert tuple(int(g) for g in got) == want
    assert int(got[0]) * (1 << 32) + int(got[1]) == int(values.astype(object).sum())
    none = selective_sum(torch.from_numpy(values), [torch.from_numpy(f)], [(5000, 6000)])
    assert tuple(int(g) for g in none) == (0, 0, 0)


def test_narrow_inputs_widen_like_the_reference():
    rng = np.random.default_rng(7)
    values = rng.integers(-30000, 30000, 777).astype(np.int16)
    f = rng.integers(-100, 100, 777).astype(np.int8)
    want = _ints(ref_selective_sum(jnp.asarray(values), [jnp.asarray(f)], [(-5, 50)], interpret=True))
    got = selective_sum(torch.from_numpy(values), [torch.from_numpy(f)], [(-5, 50)])
    assert tuple(int(g) for g in got) == want


def test_plain_is_the_cpu_path_and_counts_no_launch():
    values, filters, bounds = _inputs(512, 2, seed=9)
    before = selective_sum.launches
    tv, tf = torch.from_numpy(values), [torch.from_numpy(f) for f in filters]
    got = selective_sum(tv, tf, bounds)
    plain = selective_sum_plain(tv, tf, bounds)
    assert selective_sum.launches == before
    assert [int(g) for g in got] == [int(p) for p in plain]


@pytest.mark.parametrize("bad", ["four_filters", "length", "bounds_count", "float"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    values, filters, bounds = _inputs(64, 3, seed=10)
    tv, tf = torch.from_numpy(values), [torch.from_numpy(f) for f in filters]
    if bad == "four_filters":
        tf, bounds = tf + [tf[0]], bounds + [(0, 1)]
    elif bad == "length":
        tf[1] = tf[1][:-1]
    elif bad == "bounds_count":
        bounds = bounds[:2]
    else:
        tv = tv.to(torch.float64)
    with pytest.raises((TypeError, ValueError)):
        selective_sum(tv, tf, bounds)
