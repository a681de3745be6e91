"""The TPC-H texts and plans of the complex-type slice (``chip_smoke.py``
``COMPLEX_SQL`` C1-C6 and ``complex_plan`` C7, C8: collect aggregates,
array constructors and lambdas, ROLLUP, a VARCHAR cast as grouping key,
array_join over a collect, a collect back on the device, split + unnest and
a collect feeding an unnest) at SF 0.01 in two tile sizes, through both
packages and against the numpy oracles that ``chip_smoke.py`` holds the
card's rows to (``check_complex``).

The JAX package's rows are computed once for the module.  Integers,
decimals, strings and array contents exactly (``array_agg`` in input order,
set-like results as sorted sets), DOUBLE to rtol 1e-9."""

import numpy as np
import pytest

import chip_smoke as cs
from velox_tpu.connectors.tpch import load_table as ref_load_table
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu.sql import run_sql as ref_run_sql
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.plan.nodes import GroupIdNode
from velox_tpu_torch.sql import plan_sql
from velox_tpu_torch.testing import assert_same_values, python_rows, table_from_numpy

SF = 0.01
NAMES = [*cs.COMPLEX_SQL, "C7", "C8"]


def _carry_across(table):
    names = list(table.schema.names)
    return table_from_numpy(
        names,
        [str(t) for t in table.schema.types],
        {n: np.asarray(table.columns[n]) for n in names},
        {n: t.values() for n, t in table.string_tables.items()},
        {n: np.asarray(v) for n, v in table.validities.items()},
    )


def _ref_tables(name):
    return {t: ref_load_table(t, SF, list(c), cache_dir=None)
            for t, c in cs.COMPLEX_COLUMNS[name].items()}


def _sorted_rows(table):
    rows = python_rows(table)
    order = sorted(range(table.num_rows), key=lambda i: tuple(repr(v[i]) for v in rows.values()))
    return {c: [v[i] for i in order] for c, v in rows.items()}


@pytest.fixture(scope="module")
def ref_rows():
    """Every text through the JAX package once (tiles of 2^12 rows)."""
    out = {}
    for name in NAMES:
        tables = _ref_tables(name)
        if name in cs.COMPLEX_SQL:
            result = ref_run_sql(cs.COMPLEX_SQL[name], tables, tile_rows=1 << 12)
        else:
            result = RefExecutor(cs.complex_plan(name, RefBuilder, tables), tile_rows=1 << 12).run()
        out[name] = (tables, _sorted_rows(result))
    return out


def _port(name, tables, tile_rows):
    plan = (plan_sql(cs.COMPLEX_SQL[name], tables) if name in cs.COMPLEX_SQL
            else cs.complex_plan(name, PlanBuilder, tables))
    ex = LocalExecutor(plan, tile_rows=tile_rows, device="cpu")
    return plan, ex, ex.run()


@pytest.mark.parametrize("tile_rows", [1 << 12, 1 << 20])
@pytest.mark.parametrize("name", NAMES)
def test_text_matches_reference_and_oracle(ref_rows, name, tile_rows):
    ref_tables, want = ref_rows[name]
    tables = {t: _carry_across(v) for t, v in ref_tables.items()}
    plan, ex, got = _port(name, tables, tile_rows)
    assert got.num_rows > 0
    facts = cs.check_complex(name, got, tables)
    rows = _sorted_rows(got)
    assert list(rows) == list(want)
    for col in want:
        assert_same_values(rows[col], want[col], path=col)
    # the path each text is there for
    kinds = [k for k, *_ in ex.barrier_aggregations] + ([ex.kind] if ex.agg_exec else [])
    if name in ("C1", "C5", "C6", "C8"):
        assert "collect_agg" in kinds, kinds
    if name == "C3":
        node = plan
        while not isinstance(node, GroupIdNode):
            node = node.sources[0]
        assert len(node.grouping_sets) == 3
    if name in ("C7", "C8"):
        assert facts["elements"] > 0 and facts["groups"] > 1
