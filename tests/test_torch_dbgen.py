"""The port's dbgen (``connectors/tpch/dbgen.py``: TPC's generator bit for
bit) against the JAX package's: every column of every TPC-H table at
SF 0.01 equal value for value (strings decoded), the Park-Miller stream
against hand-advanced values, the 10 MB text pool against the JAX package's
and its pinned prefix, and the hand-built Q1, Q6, Q3 and Q13 plans over
dbgen data at SF 0.01 through both packages.  The SF-1 published answers
(``chip_smoke.py`` ``dbgen_golden``) run on the card
(``test_torch_gpu_spark_sketch.py``): 6 M rows are too many for this file's
time.  The JAX package's text pool is cached in a temporary directory."""

import numpy as np
import pytest

import chip_smoke as cs
from velox_tpu.connectors.tpch import dbgen as ref_dbgen
from velox_tpu.connectors.tpch import plans as ref_plans
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu_torch.connectors.tpch import dbgen
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.testing import assert_same_values, python_rows

SF = 0.01
TABLES = ["lineitem", "orders", "customer", "supplier", "part", "partsupp", "nation", "region"]


@pytest.fixture(scope="module")
def ref_cache(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("VELOX_TPU_TPCH_CACHE", str(tmp_path_factory.mktemp("ref_tpch")))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def both(ref_cache):
    """Every table through both generators once."""
    return {name: (dbgen.table(name, SF), ref_dbgen.table(name, SF)) for name in TABLES}


def _values(table, col):
    values = np.asarray(table.columns[col])
    if col in table.string_tables:
        return table.string_tables[col].decode(values)
    return values


@pytest.mark.parametrize("name", TABLES)
def test_every_column_matches_reference(both, name):
    got, want = both[name]
    assert list(got.schema.names) == list(want.schema.names)
    assert [str(t) for t in got.schema.types] == [str(t) for t in want.schema.types]
    assert got.num_rows == want.num_rows > 0
    for col in want.schema.names:
        np.testing.assert_array_equal(_values(got, col), _values(want, col), err_msg=col)


def test_row_counts(both):
    assert both["lineitem"][0].num_rows == 60_175  # 6 001 215 at SF 1
    assert both["orders"][0].num_rows == 15_000
    assert both["region"][0].num_rows == 5 and both["nation"][0].num_rows == 25


def test_lineitem_table_and_shared_generation(both):
    """``lineitem_table`` (gen.py's flags as codes) and ``table`` over one
    shared ``gen_orders_lineitem`` give the same columns; a table asked for
    no text column generates none."""
    raw = dbgen.gen_orders_lineitem(SF)
    full = both["lineitem"][0]
    cols = ["l_orderkey", "l_quantity", "l_extendedprice", "l_returnflag", "l_shipdate"]
    a = dbgen.lineitem_table(SF, columns=cols, _raw=raw["lineitem"])
    b = dbgen.table("lineitem", SF, cols, raw_orders_lineitem=raw)
    o = dbgen.table("orders", SF, ["o_orderkey", "o_comment"], raw_orders_lineitem=raw)
    for col in cols:
        np.testing.assert_array_equal(_values(a, col), _values(full, col), err_msg=col)
        np.testing.assert_array_equal(_values(b, col), _values(full, col), err_msg=col)
    np.testing.assert_array_equal(_values(o, "o_comment"), _values(both["orders"][0], "o_comment"))


def test_unifint_bit_exactness():
    """Spot-check the Park-Miller stream against hand-advanced values."""
    s = 209208115  # L_QTY seed
    vals = []
    x = s
    for _ in range(10):
        x = (x * 16807) % 2147483647
        vals.append(int((x / 2147483647.0) * 50) + 1)
    got = dbgen._unif(dbgen._seed_at(s, np.arange(1, 11, dtype=np.int64)), 1, 50)
    np.testing.assert_array_equal(got, vals)


def test_text_pool_prefix(ref_cache):
    """First bytes of the 10 MB pool, pinned from the reference generator,
    and the whole pool equal to the JAX package's."""
    pool = dbgen.text_pool()
    assert pool[:66] == b"furiously special foxes haggle furiously blithely ironic deposits."[:66]
    assert len(pool) == dbgen.TEXT_POOL_SIZE
    assert pool == ref_dbgen.text_pool()


@pytest.mark.parametrize("num", [1, 6, 3, 13])
def test_golden_queries_match_reference(both, num):
    """Q1, Q6, Q3 and Q13 over dbgen's SF-0.01 tables, the port against the
    JAX package (``chip_smoke.golden_rows`` shapes the rows as the published
    answers are; at SF 1 they must equal them)."""
    port = {n: both[n][0] for n in ("lineitem", "orders", "customer")}
    ref = {n: both[n][1] for n in ("lineitem", "orders", "customer")}
    got = LocalExecutor(cs.golden_plan(num, port), tile_rows=1 << 14, device="cpu").run()
    ref_plan = {1: lambda: ref_plans.build_q1(ref["lineitem"]),
                6: lambda: ref_plans.build_q6(ref["lineitem"]),
                3: lambda: ref_plans.build_q3(ref["customer"], ref["orders"], ref["lineitem"]),
                13: lambda: ref_plans.build_q13(ref["customer"], ref["orders"])}[num]()
    want = RefExecutor(ref_plan, tile_rows=1 << 14).run()
    assert cs.golden_rows(num, got) == cs.golden_rows(num, want)
    rows_got, rows_want = python_rows(got), python_rows(want)
    for col in rows_want:
        assert_same_values(rows_got[col], rows_want[col], path=col)
    assert got.num_rows > 0
