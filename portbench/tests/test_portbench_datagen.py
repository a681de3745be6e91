"""The generator repeats for one seed, differs for another, and keeps the
TPC-H rules it states."""

import numpy as np
import pytest
from portbench_testing import SF

from portbench import datagen

ALL = {t: datagen.table_columns(t) for t in ("lineitem", "orders", "customer")}


@pytest.fixture(scope="module")
def made():
    return datagen.generate_host(SF, 2**33 + 17, ALL, "cpu")


def test_same_seed_same_columns(made):
    again = datagen.generate_host(SF, 2**33 + 17, ALL, "cpu")
    for t, cols in made.items():
        for c, v in cols.items():
            assert np.array_equal(v, again[t][c]), (t, c)


def test_other_seed_other_columns(made):
    other = datagen.generate_host(SF, 2**33 + 18, ALL, "cpu")
    for t, c in [("lineitem", "l_extendedprice"), ("lineitem", "l_shipdate"),
                 ("orders", "o_custkey"), ("customer", "c_mktsegment")]:
        assert not np.array_equal(made[t][c], other[t][c]), (t, c)


def test_a_column_does_not_depend_on_the_others():
    alone = datagen.generate_host(SF, 5, {"lineitem": ["l_discount"]}, "cpu")
    many = datagen.generate_host(SF, 5, {"lineitem": ["l_tax", "l_discount", "l_shipmode"]}, "cpu")
    assert np.array_equal(alone["lineitem"]["l_discount"], many["lineitem"]["l_discount"])


def test_tpch_rules(made):
    li, od, cu = made["lineitem"], made["orders"], made["customer"]
    n_orders = int(1_500_000 * SF)
    assert len(od["o_orderkey"]) == n_orders and len(cu["c_custkey"]) == int(150_000 * SF)
    assert n_orders <= len(li["l_orderkey"]) <= 7 * n_orders
    assert set(od["o_orderkey"] % 32) <= set(range(1, 9))
    assert np.all(np.diff(li["l_orderkey"]) >= 0)
    lines = np.bincount(np.searchsorted(od["o_orderkey"], li["l_orderkey"]), minlength=n_orders)
    assert lines.min() >= 1 and lines.max() <= 7
    assert li["l_quantity"].min() >= 100 and li["l_quantity"].max() <= 5000
    assert 0 <= li["l_discount"].min() and li["l_discount"].max() <= 10
    assert 0 <= li["l_tax"].min() and li["l_tax"].max() <= 8
    odate = od["o_orderdate"][np.searchsorted(od["o_orderkey"], li["l_orderkey"])]
    ship = li["l_shipdate"] - odate
    assert ship.min() >= 1 and ship.max() <= 121
    commit = li["l_commitdate"] - odate
    assert commit.min() >= 30 and commit.max() <= 90
    receipt = li["l_receiptdate"] - li["l_shipdate"]
    assert receipt.min() >= 1 and receipt.max() <= 30
    flag = np.asarray(datagen.RETURNFLAGS)[li["l_returnflag"] - 1]
    assert np.all((flag == "N") == (li["l_receiptdate"] > datagen.CURRENTDATE))
    status = np.asarray(datagen.LINESTATUSES)[li["l_linestatus"] - 1]
    assert np.all((status == "O") == (li["l_shipdate"] > datagen.CURRENTDATE))
    assert np.all(od["o_custkey"] % 3 != 0)
    unit = li["l_extendedprice"] // (li["l_quantity"] // 100)
    assert np.all(li["l_extendedprice"] % (li["l_quantity"] // 100) == 0)
    assert unit.min() >= 90000 and unit.max() <= 90000 + 20000 + 100 * 999
    for t, cols in made.items():
        for c, v in cols.items():
            cats = datagen.column_type(t, c)[1]
            if cats is not None:
                assert v.min() >= 1 and v.max() <= len(cats), (t, c)


def test_columns_are_found_by_name():
    assert len(ALL["lineitem"]) == 11 and len(ALL["orders"]) == 5 and len(ALL["customer"]) == 2
    assert datagen.column_type("lineitem", "l_shipmode") == ("VARCHAR", datagen.SHIPMODES)
    with pytest.raises(KeyError):
        datagen.column_type("lineitem", "l_comment")
    with pytest.raises(KeyError):
        datagen.generate_host(SF, 5, {"nation": ["n_name"]}, "cpu")
