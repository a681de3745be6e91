"""The CUDA kernels against their plain PyTorch versions, on the card.

These build ``velox_tpu_torch/csrc`` with nvcc and launch on a CUDA device, so
they are skipped where there is none (run them on a GPU machine with
``python -m pytest tests/test_torch_gpu_kernels.py -m gpu``).  Exact equality:
integer addition wraps and is associative, so the order of the atomics cannot
show."""

import numpy as np
import pytest
import torch

from velox_tpu_torch.ops import group_piece, group_sum, selective_sum as sel
from velox_tpu_torch.testing import kernel_cases

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 1000, (1 << 20) + 7])
@pytest.mark.parametrize("n_filters", [0, 1, 3])
def test_selective_sum_kernel(cuda, n, n_filters):
    rng = np.random.default_rng(n + n_filters)
    values = torch.from_numpy(rng.integers(-(1 << 45), 1 << 45, n)).to(cuda)
    filters = [torch.from_numpy(rng.integers(0, 100, n)).to(cuda) for _ in range(n_filters)]
    bounds = [(10, 60)] * n_filters
    before = sel.selective_sum.launches
    got = sel.selective_sum(values, filters, bounds)
    want = sel.selective_sum_plain(values, filters, bounds)
    torch.cuda.synchronize()
    assert sel.selective_sum.launches == before + 1
    assert [int(g) for g in got] == [int(w) for w in want]


@pytest.mark.parametrize("n,groups,gid_dtype", [(1024, 6, torch.int8), ((1 << 20) + 3, 64, torch.int32)])
def test_grouped_piece_sums_kernel(cuda, n, groups, gid_dtype):
    rng = np.random.default_rng(n)
    cols = [
        torch.from_numpy(rng.integers(90000, 10500000, n).astype(np.int32)).to(cuda),
        torch.from_numpy(rng.integers(100, 5001, n).astype(np.int16)).to(cuda),
        torch.from_numpy(rng.integers(0, 11, n).astype(np.int8)).to(cuda),
    ]
    gid = rng.integers(0, groups, n)
    gid[rng.random(n) < 0.1] = -1
    gid = torch.from_numpy(gid).to(gid_dtype).to(cuda)
    F = group_piece.Factor
    plans = [
        group_piece.plan_spec(s)
        for s in (
            [],
            [F(1, 1, 0, 100, 5000)],
            [F(0, 1, 0, 90000, 10500000), F(2, -1, 100, 90, 100)],
        )
    ]
    before = group_piece.grouped_piece_sums.launches
    got = group_piece.grouped_piece_sums(cols, gid, plans, groups)
    want = group_piece.grouped_piece_sums_plain(cols, gid, plans, groups)
    torch.cuda.synchronize()
    assert group_piece.grouped_piece_sums.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,groups,ncols", [(2048, 3, 1), ((1 << 20) + 5, 12, 4)])
def test_grouped_int64_sums_kernel(cuda, n, groups, ncols):
    rng = np.random.default_rng(n)
    cols = [
        torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)).to(cuda) for _ in range(ncols)
    ]
    gids = torch.from_numpy(rng.integers(0, groups, n).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    before = group_sum.grouped_int64_sums.launches
    got = group_sum.grouped_int64_sums(cols, gids, mask, groups)
    want = group_sum.grouped_int64_sums_plain(cols, gids, mask, groups)
    torch.cuda.synchronize()
    assert group_sum.grouped_int64_sums.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


PIECE_CASES = list(kernel_cases.piece_cases())  # specs only; the data is made in the test
SUM_CASES = list(kernel_cases.group_sum_cases())


@pytest.mark.parametrize("case", PIECE_CASES, ids=[c["name"] for c in PIECE_CASES])
def test_grouped_piece_sums_edge_case(cuda, case):
    """Ragged lengths, unaligned slices, dead rows, 1 and 64 groups, the table
    limit, both group-id types, every number of table copies: the cases
    chip_smoke.py runs."""
    args = kernel_cases.piece_inputs(case, cuda)
    before = group_piece.grouped_piece_sums.launches
    got = group_piece.grouped_piece_sums(*args)
    want = group_piece.grouped_piece_sums_plain(*args)
    torch.cuda.synchronize()
    assert group_piece.grouped_piece_sums.launches == before + 1
    geometry = group_piece.grouped_piece_sums.last_geometry
    assert geometry.head + geometry.body_rows + geometry.tail == case["n"]
    assert case["copies"] in (None, geometry.lane_copies)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", SUM_CASES, ids=[c["name"] for c in SUM_CASES])
def test_grouped_int64_sums_edge_case(cuda, case):
    args = kernel_cases.group_sum_inputs(case, cuda)
    before = group_sum.grouped_int64_sums.launches
    got = group_sum.grouped_int64_sums(*args)
    want = group_sum.grouped_int64_sums_plain(*args)
    torch.cuda.synchronize()
    assert group_sum.grouped_int64_sums.launches == before + 1
    assert case["copies"] in (None, group_sum.grouped_int64_sums.last_geometry.lane_copies)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_compiled_limits_are_the_planned_ones(cuda):
    """grouped_common.cuh and ops/launch_geometry.py each hold the limits."""
    from velox_tpu_torch.ops import cuda_build, launch_geometry

    assert cuda_build.compiled_limits(cuda_build.library()) == launch_geometry.COMPILED_LIMITS


def test_q1_on_the_card_takes_the_kernel(cuda):
    import pandas as pd

    from velox_tpu_torch.connectors.tpch.plans import build_query, load_query_tables, oracle_result
    from velox_tpu_torch.exec.runner import LocalExecutor

    tables = load_query_tables(1, 0.05)
    ex = LocalExecutor(build_query(1, tables), tile_rows=1 << 16)  # default: CUDA
    before = group_piece.grouped_piece_sums.launches
    got = ex.run().to_pandas().reset_index(drop=True)
    assert group_piece.grouped_piece_sums.launches - before == ex.source_table.num_tiles(ex.capacity)
    pd.testing.assert_frame_equal(
        got, oracle_result(1, tables).reset_index(drop=True), check_dtype=False, rtol=1e-9
    )


def _index_add_sum(values, mask, gids, num_groups):
    """direct_group_reduce's int64 sum as it reads with ``index_add_``."""
    gid = gids.to(torch.int64)
    live = mask & (gid >= 0) & (gid < num_groups)
    index = torch.where(live, gid, torch.zeros_like(gid))
    v = torch.where(live, values, torch.zeros_like(values))
    return torch.zeros((num_groups,), dtype=values.dtype, device=values.device).index_add_(
        0, index, v
    )


@pytest.mark.parametrize("n,groups,live,gid_dtype", [
    (1 << 24, 7, 0.005, torch.int32),  # a Q12 tile: a few groups, nearly every row dead
    ((1 << 20) + 3, 6144, 0.5, torch.int32),  # the largest table the kernel takes
    (1 << 16, 7, 0.9, torch.int64),  # wider ids, some past int32
    (0, 7, 0.9, torch.int32),
])
def test_direct_int64_sum_takes_the_kernel(cuda, n, groups, live, gid_dtype):
    from velox_tpu_torch.ops.segmented import direct_group_reduce

    g = torch.Generator(device=cuda).manual_seed(n + groups)
    values = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g, device=cuda)
    mask = torch.rand(n, generator=g, device=cuda) < live
    gids = torch.randint(-1, groups + 1, (n,), generator=g, device=cuda).to(gid_dtype)
    if gid_dtype == torch.int64:
        gids = gids + (torch.rand(n, generator=g, device=cuda) < 0.3) * (1 << 32)
    before = group_sum.grouped_int64_sums.launches
    got = direct_group_reduce(values, mask, gids, groups, "sum")
    torch.cuda.synchronize()
    assert group_sum.grouped_int64_sums.launches == before + 1
    assert torch.equal(got, _index_add_sum(values, mask, gids, groups))


def test_q12_on_the_card_takes_the_kernel(cuda):
    """Q12 groups by ship mode in array mode after a join: every accumulator
    of a tile is one launch of grouped_int64_sums, two exact BIGINT sums of
    three limbs each and the row count, 7 a tile, and no index_add_."""
    import pandas as pd

    from velox_tpu_torch.connectors.tpch.plans import build_query, load_query_tables, oracle_result
    from velox_tpu_torch.exec.runner import LocalExecutor

    tables = load_query_tables(12, 0.05)
    ex = LocalExecutor(build_query(12, tables), tile_rows=1 << 16)  # default: CUDA
    before = group_sum.grouped_int64_sums.launches
    got = ex.run().to_pandas().reset_index(drop=True)
    assert ex.kind == "direct_agg" and not ex.use_piece
    tiles = ex.source_table.num_tiles(ex.capacity)
    assert tiles > 1 and group_sum.grouped_int64_sums.launches - before == 7 * tiles
    pd.testing.assert_frame_equal(
        got, oracle_result(12, tables).reset_index(drop=True), check_dtype=False, rtol=1e-9
    )


def _dictionary_on(cuda, values):
    """(bytes, offsets) of ``values`` resident on the card, made once a table."""
    from velox_tpu_torch.vector.string_table import StringTable

    table = StringTable.from_values(values)
    data, offsets = table.byte_arrays(cuda)
    assert data.device.type == "cuda" and offsets.device.type == "cuda"
    assert table.byte_arrays(cuda)[0] is data
    return data, offsets


def _like_patterns():
    words1 = ["special", "pending", "unusual", "express"]
    words2 = ["packages", "requests", "accounts", "deposits"]
    return [f"%{a}%{b}%" for a in words1 for b in words2]


def test_dict_like_kernel_on_the_full_comment_pool(cuda):
    """K4 against its plain version (run on the card), bit for bit, over the
    benchmark's 15 M comments resident on the card, for each of the 16 Q13
    patterns and a few more shapes."""
    from portbench.columns.orders_text import o_comment
    from velox_tpu_torch.ops import dict_like as k4

    values = [""] + o_comment.categories()
    assert len(values) == 15_000_001
    data, offsets = _dictionary_on(cuda, values)
    extra = ["", "%", "ly%", "%s.", "%the%", "furiously%deposits", "e", "%a%e%i%o%u%", "%s%"]
    for text in _like_patterns() + extra:
        pattern = k4.parse_like(text)
        want = k4.dict_like_plain(data, offsets, pattern)
        before = k4.dict_like.launches
        got = k4.dict_like(data, offsets, pattern, cuda)
        torch.cuda.synchronize()
        assert k4.dict_like.launches == before + 1
        assert torch.equal(got, want), text
        assert 0 < int(want.sum()) < len(values) or text in ("", "e", "%")


@pytest.mark.parametrize("values", [
    None,  # no entries at all
    [""],  # entries, but no bytes
    ["", "é中ß", "aaa", "aa" * 20000, "x" * 40000 + "special" + "y" * 3 + "requests"],
    # a block whose bytes all but fill the stage: the search reads past them
    [""] + [f"{i:03d}" + "xa" * 46 + "y" for i in range(300)],
])
def test_dict_like_kernel_edge_cases(cuda, values):
    """0 entries; only the empty string; non-ASCII text, an overlap, and
    entries longer than a block's shared-memory stage, which are read where
    they lie; operands not on the card are refused."""
    from velox_tpu_torch.ops import dict_like as k4

    if values is None:
        data = torch.zeros(0, dtype=torch.uint8, device=cuda)
        offsets = torch.zeros(1, dtype=torch.int32, device=cuda)
        got = k4.dict_like(data, offsets, k4.parse_like("%a%"), cuda)
        assert got.shape == (0,) and got.device.type == "cuda"
        return
    data, offsets = _dictionary_on(cuda, values)
    for text in ["%", "", "aa%aa", "%中%", "%special%requests%", "x%", "%y%s", "é%ß", "%a%",
                 "%ay%", "%xa%y"]:
        pattern = k4.parse_like(text)
        want = k4.dict_like_plain(data, offsets, pattern)
        assert torch.equal(k4.dict_like(data, offsets, pattern, cuda), want), text
        wide = k4.dict_like(data, offsets.long(), pattern, cuda)
        assert torch.equal(wide, want), text
    if offsets.shape[0] > 1:
        with pytest.raises(ValueError, match="operand on cpu"):
            k4.dict_like(data.cpu(), offsets.cpu(), k4.parse_like("%a%"), cuda)


def test_q13_on_the_card_takes_the_kernel(cuda):
    """The LIKE of Q13's build side is one K4 launch a query, whatever the
    number of tiles, and the rows are the oracle's."""
    import pandas as pd

    from velox_tpu_torch.connectors.tpch.plans import build_query, load_query_tables, oracle_result
    from velox_tpu_torch.exec.runner import LocalExecutor
    from velox_tpu_torch.ops import dict_like as k4

    tables = load_query_tables(13, 0.05)
    before = k4.dict_like.launches
    ex = LocalExecutor(build_query(13, tables), tile_rows=1 << 14)  # default: CUDA
    assert k4.dict_like.launches == before + 1  # in the build side, while constructing
    got = ex.run().to_pandas().reset_index(drop=True)
    assert k4.dict_like.launches == before + 1
    assert tables["orders"].num_tiles(1 << 14) > 1
    pd.testing.assert_frame_equal(
        got, oracle_result(13, tables).reset_index(drop=True), check_dtype=False, rtol=1e-9
    )
