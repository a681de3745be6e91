"""The eighteen TPC-H plans the earlier slices had not ported (all but Q1, Q3,
Q6, Q13) at SF 0.01 through the port's ``LocalExecutor`` at two tile sizes,
against the port's oracle on the port's tables and against the JAX package's
oracle on the JAX package's tables (the port's tables are those, carried
across as plain numpy values).  The JAX package's own
``tests/test_tpch_queries.py`` holds its executor to the same oracle.
Integer, decimal, date and string columns agree exactly, DOUBLE to rtol
1e-9."""

import numpy as np
import pandas as pd
import pytest

from velox_tpu.connectors.tpch import plans as ref_plans
from velox_tpu_torch.connectors.tpch import plans as port_plans
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.testing import table_from_numpy

SF = 0.01
REST = [n for n in range(1, 23) if n not in (1, 3, 6, 13)]
_CACHE = {}


def _carry_across(table):
    names = list(table.schema.names)
    return table_from_numpy(
        names,
        [str(t) for t in table.schema.types],
        {n: np.asarray(table.columns[n]) for n in names},
        {n: t.values() for n, t in table.string_tables.items()},
        {n: np.asarray(v) for n, v in table.validities.items()},
    )


def _case(num):
    """(port tables, the port's oracle frame, the JAX package's oracle frame)."""
    if num not in _CACHE:
        ref = ref_plans.load_query_tables(num, SF, cache_dir=None)
        port = {k: _carry_across(t) for k, t in ref.items()}
        _CACHE[num] = (
            port,
            port_plans.oracle_result(num, port).reset_index(drop=True),
            ref_plans.oracle_result(num, ref).reset_index(drop=True),
        )
    return _CACHE[num]


@pytest.mark.parametrize("tile_rows", [1 << 12, 1 << 14])
@pytest.mark.parametrize("num", REST)
def test_plan_matches_both_oracles(num, tile_rows):
    tables, own, ref = _case(num)
    pd.testing.assert_frame_equal(own, ref)
    plan = port_plans.build_query(num, tables, device="cpu")
    got = LocalExecutor(plan, tile_rows=tile_rows, device="cpu").run().to_pandas()
    if num in port_plans.ENGINE_OUTPUT_ORDER:
        got = got[port_plans.ENGINE_OUTPUT_ORDER[num]]
    assert len(got) > 0 or len(ref) == 0
    pd.testing.assert_frame_equal(
        got.reset_index(drop=True), ref, check_dtype=False, rtol=1e-9
    )


@pytest.mark.parametrize("num", [11, 15, 22])
def test_plan_time_fragments_run_on_the_given_device(num, monkeypatch):
    """Q11, Q15 and Q22 run a scalar subquery while the plan is built; it runs
    on the device ``build_query`` is given, never quietly elsewhere."""
    import velox_tpu_torch.connectors.tpch.plans as mod

    tables, _, _ = _case(num)
    seen = []
    real = mod.run_plan

    def spy(plan, *args, **kwargs):
        seen.append(kwargs.get("device"))
        return real(plan, *args, **kwargs)

    monkeypatch.setattr(mod, "run_plan", spy)
    port_plans.build_query(num, tables, device="cpu")
    assert seen == ["cpu"]
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_plans.build_query(num, tables)
