"""``sf10-q13``'s correctness check on the CPU, over a small comment pool: a
sound run is correct; each fault the harness's tests give the other cells (a
query that returns its first answer again, half of the probe's tiles left
out, an answer altered where it is produced) is refused; and so is each
control that breaks a guarantee of the configuration, its answers put in the
program's place and judged by the harness's own check (``check_answers``):
WORD2 allowed before WORD1, the LIKE over only a comment's first 32 bytes,
and an inner join that drops the customers with no order.  A program without
the LIKE that runs with the query is refused before set-up.

The reference in float32 (``control.py``) cannot be refused here: every
number of Q13 is a count below 2^24, exact in float32."""

import itertools

import pytest
import torch
from portbench_testing import SF
from test_portbench_harness import altered_answer, first_answer_again

from portbench import datagen, harness
from portbench.columns.orders_text import o_comment
from portbench.reference import q13 as reference

CELL = "sf10-q13"
COMMENTS = 20_000  # the pool's size here: more than the 15 000 orders at SF 0.01
TILE_ROWS = 1 << 9  # 3 customer tiles, 30 of orders_text
SECONDS = 3


@pytest.fixture(autouse=True)
def small_pool(monkeypatch):
    monkeypatch.setattr(o_comment, "N_COMMENTS", COMMENTS)
    monkeypatch.setattr(o_comment, "_MADE", {})


def either_order(memo, device, word1, word2):
    """Both words anywhere in the comment, in either order."""
    matrix, lens = reference.comment_matrix(memo, device)
    zero = torch.zeros(matrix.shape[0], dtype=torch.int64, device=device)
    found1, _ = reference._find(matrix, lens, word1.encode(), zero)
    found2, _ = reference._find(matrix, lens, word2.encode(), zero)
    return found1 & found2


def first_32_bytes(memo, device, word1, word2):
    """The pattern matched against a comment's first 32 bytes only."""
    matrix, lens = reference.comment_matrix(memo, device)
    rows, n = matrix[:, :32], lens.clamp(max=32)
    zero = torch.zeros(matrix.shape[0], dtype=torch.int64, device=device)
    found1, end1 = reference._find(rows, n, word1.encode(), zero)
    found2, _ = reference._find(rows, n, word2.encode(), end1)
    return found1 & found2


def inner_join(data, p, monkeypatch):
    """The reference's rows without the customers that have no order."""
    (name, kind, scale, counts), (name2, kind2, scale2, dists) = reference.answer(data, p)
    kept = [(c, d) for c, d in zip(counts, dists) if c != 0]
    return [(name, kind, scale, [c for c, _ in kept]), (name2, kind2, scale2, [d for _, d in kept])]


def with_matching(matching):
    def answer(data, p, monkeypatch):
        with monkeypatch.context() as m:
            m.setattr(reference, "matching", matching)
            return reference.answer(data, p)
    return answer


CONTROLS = {"either_order": with_matching(either_order),
            "first_32_bytes": with_matching(first_32_bytes),
            "inner_join": inner_join}


def control_checks(monkeypatch, control, seed=31, n_queries=32):
    """The harness's check of ``control``'s answers to the queries a run's
    window draws."""
    cell = harness.Cell(CELL, scale_factor=SF)
    host = datagen.generate_host(cell.sf, seed, cell.columns(), "cpu")
    data = {t: {c: torch.from_numpy(a) for c, a in cols.items()} for t, cols in host.items()}
    queries = []
    for kind, drawn in itertools.islice(harness.draws(cell, seed), n_queries):
        q = harness.Query(kind, drawn, 0)
        q.answer = CONTROLS[control](data, q.params, monkeypatch)
        queries.append(q)
    return harness.check_answers(cell, host, queries, "cpu")


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_broken_guarantee_is_refused(monkeypatch, control):
    checks = control_checks(monkeypatch, control)
    assert checks["mismatched_cells"]["value"] > checks["mismatched_cells"]["limit"], checks


def half_the_tiles(original, ex, tiles):
    """Half of the probe's resident tiles; the build side, which the executor
    runs from its host table (no tiles handed in), stays whole."""
    return original(ex, prefetched_tiles=None if tiles is None else tiles[: len(tiles) // 2])


def run(monkeypatch, fault=None):
    from velox_tpu_torch.exec.runner import LocalExecutor

    if fault is not None:
        original = LocalExecutor.run
        monkeypatch.setattr(LocalExecutor, "run", lambda self, prefetched_tiles=None, stats=None:
                            fault(original, self, prefetched_tiles))
    return harness.run_cell(CELL, 2**31 + 77, SECONDS, False, device="cpu", scale_factor=SF,
                            tile_rows=TILE_ROWS)


def test_sound_run_is_correct(monkeypatch):
    out = run(monkeypatch)
    assert out["correct"] is True and out["attempted"] > 2 and out["failed"] == 0, out["checks"]


@pytest.mark.parametrize("fault", ["first_answer_again", "half_the_tiles", "altered_answer"])
def test_faults_are_refused(monkeypatch, fault):
    make = {"first_answer_again": first_answer_again(), "half_the_tiles": half_the_tiles,
            "altered_answer": altered_answer}[fault]
    out = run(monkeypatch, make)
    assert out["attempted"] > 2
    assert out["correct"] is False, out["checks"]


def test_a_program_that_binds_like_per_entry_is_refused_before_set_up(monkeypatch):
    from portbench.queries import q13

    monkeypatch.setattr(q13, "LIKE_AT_RUN_TIME", "velox_tpu_torch.ops.no_such_module")
    with pytest.raises(RuntimeError, match="binds it per dictionary entry"):
        q13.require_like_at_run_time()
