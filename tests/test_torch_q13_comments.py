"""TPC-H Q13 over distinct free-text comments, as the benchmark's ``sf10-q13``
cell runs it (``portbench/queries/q13.py`` through ``PlanBuilder`` and
``LocalExecutor``), held row for row against the benchmark's plain reference
(``portbench/reference/q13.py``) for all 16 (WORD1, WORD2) patterns on three
seeds, at a few thousand orders on the CPU.  Binding the pattern does no
work per dictionary entry; the executor matches it once a plan, not once a
tile.  Imports nothing of the JAX package."""

import itertools

import pytest
import torch

from portbench import compare, datagen, harness
from portbench.columns.orders_text import o_comment
from portbench.queries import q13
from portbench.reference import q13 as reference
from velox_tpu_torch.exec.runner import LocalExecutor
from velox_tpu_torch.expr import binding
from velox_tpu_torch.ops import dict_like as dict_like_module
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.testing import table_from_numpy
from velox_tpu_torch.vector.string_table import StringTable

N_ORDERS = 3000
SF = N_ORDERS / 1_500_000  # 300 customers
WORD1 = ["special", "pending", "unusual", "express"]
WORD2 = ["packages", "requests", "accounts", "deposits"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these plans run many small ops, which under the
    parallel test run's load wait on the other threads of an idle pool (one
    seed's 16 queries took 20-56 s so, 1-2 s with one thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def small_pool(monkeypatch):
    """The comment dictionary cut to one comment an order of the small scale."""

    def use(seed):
        monkeypatch.setattr(o_comment, "N_COMMENTS", N_ORDERS)
        monkeypatch.setattr(o_comment, "POOL_SEED", seed)
        return o_comment.categories()

    return use


def tables_and_data(seed):
    host = datagen.generate_host(SF, seed, q13.TABLES, "cpu")
    data = {t: {c: torch.from_numpy(a) for c, a in cols.items()} for t, cols in host.items()}
    return harness.program_tables(host), data


@pytest.mark.parametrize("seed", [3, 2**33 + 7, 424242])
def test_rows_equal_the_reference_for_every_pattern(small_pool, seed):
    comments = small_pool(seed % 1000)
    assert len(comments) == N_ORDERS == len(set(comments))
    tables, data = tables_and_data(seed)
    memo, matched = {}, 0
    for word1, word2 in itertools.product(WORD1, WORD2):
        p = {"word1": word1, "word2": word2}
        got = LocalExecutor(q13.build(tables, p), tile_rows=1 << 12, device="cpu").run()
        want = reference.answer(data, p, "exact", memo)
        assert compare.compare(harness.answer_of(got), want) == (0, 0.0), p
        matched += int(reference.matching(memo, "cpu", word1, word2).sum())
        # every customer is counted once, those with no order included
        assert sum(want[1][3]) == len(data["customer"]["c_custkey"])
        assert 0 in want[0][3]
    assert matched > 0


def test_the_executor_matches_once_a_plan_not_once_a_tile(small_pool, monkeypatch):
    small_pool(5)
    tables, _ = tables_and_data(5)
    calls = []
    real = dict_like_module.dict_like

    def counted(data, offsets, pattern, device):
        calls.append(pattern)
        return real(data, offsets, pattern, device)

    monkeypatch.setattr(dict_like_module, "dict_like", counted)
    plan = q13.build(tables, {"word1": "special", "word2": "requests"})
    assert calls == []  # nothing while the plan is built
    ex = LocalExecutor(plan, tile_rows=1 << 10, device="cpu")
    ex.run()
    assert tables["orders_text"].num_tiles(1 << 10) > 1
    assert [(p.middle, p.prefix, p.suffix) for p in calls] == [((b"special", b"requests"), b"", b"")]


def test_binding_does_no_work_per_entry(monkeypatch):
    values = [""] + [f"comment {i} special requests" for i in range(100_000)]
    table = table_from_numpy(["s"], ["VARCHAR"], {"s": torch.arange(1, 1001).int().numpy()},
                             string_values={"s": values})

    def refused(*_args, **_kwargs):
        raise AssertionError("per-entry work while binding")

    monkeypatch.setattr(binding, "_per_entry", refused)
    monkeypatch.setattr(StringTable, "values", refused)
    monkeypatch.setattr(StringTable, "byte_arrays", refused)
    for pattern in ("%special%requests%", "comment 1%", "%requests", "comment 7 special requests"):
        PlanBuilder().table_scan(table, filter=f"s not like '{pattern}'").build()
