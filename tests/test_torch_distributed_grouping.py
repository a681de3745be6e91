"""Sort-mode grouping distributed on 4 gloo ranks on the CPU, against the
JAX package's DistributedExecutor on 4 of the conftest's virtual devices:
one tile and several (several exchange rounds into the carry) from
tests/test_distributed.py, long-decimal sums (limbs through the exchange
and the carry) from test_hugeint.py and a VARCHAR cast key rendered on the
host from test_strcast.py; the same rows in the same order and the same
carry slots; and nullable keys through the group exchange and a shuffle
join's probe exchange, against expected rows too.
"""

import numpy as np
import pytest

from torch_world_helpers import check_case, world_fixture

world = world_fixture()


def test_sort_mode_groupby_distributed(world):
    got, _ = check_case(world, "sort_mode_groupby")
    assert got["after"]["kind"] == "sort_agg_exchange"


def test_distributed_multi_tile(world):
    """Several sharded tiles -> several exchange rounds into the carry."""
    got, _ = check_case(world, "multi_tile")
    assert got["result"].num_rows == 500


@pytest.mark.parametrize("name", ["hugeint", "strcast"])
def test_distributed_long_decimal_and_cast_keys(world, name):
    check_case(world, name)


def test_null_keys_through_the_exchanges(world):
    """A nullable grouping key and a nullable LEFT probe key cross the
    exchanges with their validity: one NULL group with the NULL rows' sums,
    and every NULL-key probe row once, unmatched (expected rows beside the
    JAX package's)."""
    from velox_tpu_torch.testing import python_rows
    from velox_tpu_torch.testing.dist_tasks import null_key_columns

    k, v, valid = null_key_columns()
    got, _ = check_case(world, "null_keys_groupby")
    rows = python_rows(got["result"])
    want = {None: (int(v[~valid].sum()), int((~valid).sum()))}
    for key in np.unique(k[valid]):
        sel = valid & (k == key)
        want[int(key)] = (int(v[sel].sum()), int(sel.sum()))
    assert dict(zip(rows["k"], zip(rows["s"], rows["c"]))) == want

    got, _ = check_case(world, "null_keys_shuffle_left")
    rows = python_rows(got["result"])
    assert len(rows["k"]) == len(k)
    null_rows = [w for kk, w in zip(rows["k"], rows["w"]) if kk is None]
    assert len(null_rows) == int((~valid).sum()) and all(w is None for w in null_rows)
