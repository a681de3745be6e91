"""LIKE over a dictionary (``ops/dict_like.py``, K4's plain version on the
CPU) against ``like_to_regex`` on seeded dictionaries, and which patterns
take the deferred path (``expr/ir.py LikeTable``) and which keep the
bind-time one.  Imports nothing of the JAX package."""

import re

import numpy as np
import pytest
import torch

from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.expr import binding
from velox_tpu_torch.expr.ir import DictLookup, FieldAccess, HostArray, LikeTable
from velox_tpu_torch.ops.dict_like import dict_like, launch_bytes, parse_like
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.vector.string_table import StringTable

ALPHABET = ["a", "b", "c", "%", " ", "é", "中", "ß"]


def seeded_dictionary(seed, n=400):
    """The empty string first, then distinct strings of 0-9 characters from a
    small alphabet, non-ASCII letters among them, and a few fixed cases."""
    rng = np.random.default_rng(seed)
    values = {"": None, "aaa": None, "aa": None, "aaaa": None, "abcabc": None}
    while len(values) < n:
        k = int(rng.integers(0, 10))
        values.setdefault("".join(rng.choice(ALPHABET, k)))
    return list(values)


def regex_like(values, pattern):
    rx = re.compile(binding.like_to_regex(pattern), re.DOTALL)
    return [rx.fullmatch(v) is not None for v in values]


PATTERNS = [
    "", "%", "%%", "%%%", "a", "aa", "ab", "a%", "%a", "%a%", "aa%aa", "a%a", "%a%b%",
    "%b%a%", "a%b%c", "ab%ab", "%abc%", "%aa%aa%", "abc%", "%é", "é%", "%中%ß%", "%é%a",
    "%ß%", "中", "c%%b", "%a%a%a%", "abcabc", "%ca%",
]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_version_equals_the_regex(seed):
    values = seeded_dictionary(seed)
    table = StringTable.from_values(values)
    data, offsets = table.byte_arrays()
    for pattern in PATTERNS:
        got = dict_like(data, offsets, parse_like(pattern), "cpu").tolist()
        assert got == regex_like(values, pattern), pattern


def test_edge_cases():
    values = ["", "aaa", "aa", "é", "xéy", "special requests", "requests special"]
    table = StringTable.from_values(values)
    data, offsets = table.byte_arrays()

    def like(pattern):
        return dict_like(data, offsets, parse_like(pattern), "cpu").tolist()

    assert like("") == [True] + [False] * 6  # only the empty string (code 0)
    assert like("%%") == [True] * 7
    assert like("aa%aa") == [False] * 7  # the prefix and suffix may not overlap
    assert like("aa%a") == [False, True, False, False, False, False, False]
    assert like("%é%") == [False, False, False, True, True, False, False]
    assert like("%special%requests%") == [False] * 5 + [True, False]
    assert like("aa") == [False, False, True, False, False, False, False]


def test_int64_offsets_and_an_empty_dictionary():
    table = StringTable.from_values(["", "ab"])
    data, offsets = table.byte_arrays()
    assert offsets.dtype == torch.int32 and offsets.tolist() == [0, 0, 2]
    wide = dict_like(data, offsets.long(), parse_like("a%"), "cpu")
    assert wide.tolist() == [False, True]
    empty = dict_like(torch.zeros(0, dtype=torch.uint8), torch.zeros(1, dtype=torch.int32),
                      parse_like("%a%"), "cpu")
    assert empty.shape == (0,) and empty.dtype == torch.bool
    assert launch_bytes(2, 2) == 2 + 4 * 3 + 2


def test_byte_arrays_are_made_once_and_again_after_growth():
    table = StringTable(["x", "é"])
    data, offsets = table.byte_arrays()
    assert bytes(data.tolist()) == "xé".encode() and offsets.tolist() == [0, 0, 1, 3]
    assert table.byte_arrays()[0] is data
    table.intern("yz")
    data2, offsets2 = table.byte_arrays()
    assert data2 is not data and offsets2.tolist() == [0, 0, 1, 3, 5]


def _strings_table(values, codes, valid=None):
    return table_from_numpy(
        ["s", "k"], ["VARCHAR", "BIGINT"],
        {"s": np.asarray(codes, dtype=np.int32), "k": np.arange(len(codes), dtype=np.int64)},
        string_values={"s": values},
        validities=None if valid is None else {"s": valid},
    )


@pytest.mark.parametrize("negate", [False, True])
def test_like_and_not_like_over_a_nullable_column(negate):
    values = seeded_dictionary(7)
    rng = np.random.default_rng(7)
    codes = rng.integers(0, len(values), 3000)
    valid = rng.random(3000) > 0.2
    table = _strings_table(values, codes, valid)
    pattern = "%a%b%"
    op = "not like" if negate else "like"
    plan = (
        PlanBuilder().table_scan(table, filter=f"s {op} '{pattern}'")
        .aggregation([], ["count(*) as n", "sum(k) as total"]).build()
    )
    out = LocalExecutor(plan, tile_rows=1 << 10, device="cpu").run()
    hit = np.asarray(regex_like(values, pattern))[codes]
    keep = valid & (~hit if negate else hit)  # a NULL is neither LIKE nor NOT LIKE
    assert int(out.columns["n"][0]) == int(keep.sum())
    assert int(out.columns["total"][0]) == int(np.arange(3000)[keep].sum())


TPCH_PATTERNS = [
    "%BRASS", "%green%", "%special%requests%", "PROMO%", "MEDIUM POLISHED%",
    "%Customer%Complaints%", "forest%",
]


def _bound(pattern, escape=None):
    strings = StringTable.from_values(["", "x"])
    from velox_tpu_torch import dtypes as pt
    from velox_tpu_torch.expr.ir import Call, Constant

    args = (FieldAccess(pt.VARCHAR, "s"), Constant(pt.VARCHAR, pattern))
    if escape is not None:
        args += (Constant(pt.VARCHAR, escape),)
    return binding.bind_string_literals(Call(pt.BOOLEAN, "like", args), {"s": strings})


@pytest.mark.parametrize("pattern", TPCH_PATTERNS + ["", "%", "abc", "a%b%c"])
def test_literal_and_percent_patterns_are_deferred(pattern):
    bound = _bound(pattern)
    assert isinstance(bound, DictLookup) and isinstance(bound.values, LikeTable)


@pytest.mark.parametrize("pattern,escape", [
    ("a_c", None), ("%a_%", None), ("_", None), ("%a%", "\\"), ("a\\%%", "\\"),
    ("%" + "a%" * 40, None),  # more middle segments than the kernel holds
])
def test_underscore_escape_and_long_patterns_bind_on_the_host(pattern, escape):
    bound = _bound(pattern, escape)
    assert isinstance(bound, DictLookup) and isinstance(bound.values, HostArray)


def test_every_like_of_the_tpch_plans_is_deferred():
    """The 22 hand-built plans and SQL texts bind each LIKE they hold as a
    LikeTable: Q2, Q9, Q13, Q14, Q16 (both) and Q20."""
    import inspect

    from velox_tpu_torch.connectors.tpch import plans, queries

    found = set(re.findall(r"like '([^']*)'", inspect.getsource(plans) + inspect.getsource(queries)))
    assert found == set(TPCH_PATTERNS)
    for pattern in found:
        assert isinstance(_bound(pattern).values, LikeTable), pattern
