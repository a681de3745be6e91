"""The launch geometry of the two grouped-sum kernels (ops/launch_geometry.py).

``plan_launch`` is a pure function, so everything the CUDA kernels rely on can
be checked without a card: head + body + tail cover the rows exactly once,
every bulk copy has a 16-byte aligned address and size, the shared memory
fits, the copy count R is a power of two in 1..32 and 1 at the table limit,
and the shapes of TPC-H Q1 get the geometry PERF.md states.  The edge cases
that ``chip_smoke.py`` runs on the card are checked here for their geometry,
and the same inputs go through the JAX package's functions
(``pallas_group_piece.grouped_piece_sums_xla``, the form the reference executor
calls, and ``pallas_group_sum.grouped_int64_sums`` in Pallas interpret mode)
and through the port's wrappers, which must agree exactly: the sums are
integers, so no tolerance applies.  The JAX functions take whole blocks only,
so their copy of the inputs is padded with dead rows, which add nothing.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from velox_tpu.ops import pallas_group_piece as ref_piece
from velox_tpu.ops import pallas_group_sum as ref_sum
from velox_tpu_torch.ops import group_piece, group_sum
from velox_tpu_torch.ops import launch_geometry as lg
from velox_tpu_torch.testing import kernel_cases

Q1_WIDTHS = (2, 4, 1, 1, 1)  # int16, int32, int8, int8 columns + int8 group ids
SUM_WIDTHS = (8, 8, 8, 8, 4, 1)  # four int64 columns + int32 group ids + bool mask


def check_invariants(g, n, widths, alignments, groups, cells):
    # rows: three ranges that cover [0, n) once
    assert g.head >= 0 and g.body_rows >= 0 and g.tail >= 0
    assert g.head + g.body_rows + g.tail == n == g.n
    assert g.body_rows % 16 == 0
    if g.body_rows:
        assert g.head < 16 and g.tail < 16
    # every bulk copy: address and size multiples of 16, inside its stage slice
    assert g.chunk_rows % 16 == 0 and g.chunk_rows >= 16
    assert len(g.stage_offsets) == len(widths)
    end = 0
    for w, a, off in zip(widths, alignments, g.stage_offsets):
        assert off % 16 == 0 and off >= end
        end = off + g.chunk_rows * w
        if g.body_rows:
            assert (a + g.head * w) % 16 == 0
            for chunk in {0, g.n_chunks - 1}:
                rows = min(g.chunk_rows, g.body_rows - chunk * g.chunk_rows)
                assert rows > 0 and (rows * w) % 16 == 0
                assert (a + (g.head + chunk * g.chunk_rows) * w) % 16 == 0
    assert end <= g.stage_bytes and g.stage_bytes % 128 == 0
    # table and shared memory
    assert g.lane_copies in (1, 2, 4, 8, 16, 32)
    assert g.table_bytes == groups * cells * 8 * g.lane_copies
    assert g.smem_bytes == lg.BARRIER_BYTES + g.stages * g.stage_bytes + g.table_bytes
    assert g.smem_bytes <= lg.MAX_SHARED_BYTES
    assert g.opt_in == (g.smem_bytes > 48 * 1024)
    assert 2 <= g.stages <= lg.MAX_STAGES
    # blocks: at least one, never more than there is work or room for
    assert 1 <= g.blocks <= lg.DEFAULT_SM_COUNT * lg.MAX_BLOCKS_PER_SM
    assert len(g.as_c()) == 9 and all(isinstance(v, int) for v in g.as_c())


GRID = list(
    itertools.product(
        (0, 1, 15, 16, 17, 1000, (1 << 20) + 7, 1 << 24),  # rows
        (Q1_WIDTHS, SUM_WIDTHS, (1,), (8,) * 16 + (4,)),  # widths
        (0, 1, 3),  # every array sliced at this element
        ((1, 1), (12, 6), (64, 16), (2048, 3)),  # groups, cells
    )
)


@pytest.mark.parametrize("n,widths,offset,table", GRID)
def test_geometry_invariants(n, widths, offset, table):
    groups, cells = table
    alignments = [(offset * w) % 16 for w in widths]
    g = lg.plan_launch(n, widths, alignments, groups, cells)
    check_invariants(g, n, widths, alignments, groups, cells)
    if offset == 0:
        assert g.head == 0 and g.tail == n % 16 if n >= 16 else g.body_rows == 0
    elif n >= 32:  # the first row at which every pointer is aligned
        assert g.head == -offset % (16 // min(widths))


@given(
    n=st.integers(0, 1 << 26),
    widths=st.lists(st.sampled_from((1, 2, 4, 8)), min_size=1, max_size=lg.MAX_ARRAYS),
    data=st.data(),
    groups=st.integers(1, 512),
    cells=st.integers(1, 16),
    sm_count=st.sampled_from((1, 16, 108, 132)),
)
@settings(max_examples=300, deadline=None)
def test_geometry_property(n, widths, data, groups, cells, sm_count):
    alignments = [data.draw(st.integers(0, 16 // w - 1)) * w for w in widths]
    if groups * cells * 8 > lg.MAX_TABLE_BYTES:
        with pytest.raises(ValueError):
            lg.plan_launch(n, widths, alignments, groups, cells, sm_count)
        return
    g = lg.plan_launch(n, widths, alignments, groups, cells, sm_count)
    check_invariants(g, n, widths, alignments, groups, cells)
    assert g.blocks <= sm_count * lg.MAX_BLOCKS_PER_SM


def test_q1_geometry_is_the_documented_one():
    g = lg.plan_launch(1 << 24, Q1_WIDTHS, [0] * 5, 12, 6)
    assert g.summary() == dict(
        R=32, stages=2, chunk_rows=2048,
        smem_bytes=55424, blocks=528, head=0, body_rows=1 << 24, tail=0,
    )
    assert g.table_bytes == 12 * 6 * 8 * 32 == 18432
    assert g.stage_offsets == (0, 4096, 12288, 14336, 16384)
    assert g.n_chunks == 8192


def test_group_sum_geometry_is_the_documented_one():
    g = lg.plan_launch(1 << 24, SUM_WIDTHS, [0] * 6, 12, 4)
    assert g.summary() == dict(
        R=32, stages=2, chunk_rows=512,
        smem_bytes=50304, blocks=528, head=0, body_rows=1 << 24, tail=0,
    )


@pytest.mark.parametrize(
    "groups,cells,copies",
    [(12, 6, 32), (64, 16, 4), (128, 16, 2), (6144, 1, 1), (2048, 3, 1), (1, 1, 32)],
)
def test_copies_shrink_to_one_at_the_table_limit(groups, cells, copies):
    g = lg.plan_launch(1 << 20, Q1_WIDTHS, [0] * 5, groups, cells)
    assert g.lane_copies == copies
    if groups * cells * 8 == lg.MAX_TABLE_BYTES:
        assert g.lane_copies == 1


def test_table_over_the_limit_raises():
    with pytest.raises(ValueError, match="exceed"):
        lg.plan_launch(1000, Q1_WIDTHS, [0] * 5, 6145, 1)


@pytest.mark.parametrize(
    "alignments,head,body",
    [
        ((0, 0, 0), 0, 992),
        ((1, 2, 4), 15, 976),  # int8, int16, int32 all sliced at element 1
        ((3, 5, 0), 1000, 0),  # two int8 arrays that are never aligned together
        ((0, 8, 0), 1000, 0),
    ],
)
def test_head_is_the_first_commonly_aligned_row(alignments, head, body):
    widths = (1, 1, 4) if alignments[1] % 2 else (1, 2, 4)
    if alignments == (0, 8, 0):
        widths = (8, 8, 4)
    g = lg.plan_launch(1000, widths, alignments, 4, 2)
    assert (g.head, g.body_rows) == (head, body)
    assert g.head + g.body_rows + g.tail == 1000


def test_small_inputs_get_small_chunks_and_few_blocks():
    g = lg.plan_launch(1000, Q1_WIDTHS, [0] * 5, 12, 6)
    assert g.chunk_rows == lg.MIN_CHUNK_ROWS and g.blocks == 4
    g = lg.plan_launch(0, Q1_WIDTHS, [0] * 5, 12, 6)
    assert g.blocks == 1 and g.body_rows == 0


@pytest.mark.parametrize(
    "tuning,error",
    [
        (dict(lane_copies=3), "power of two"),
        (dict(stages=1), "stages"),
        (dict(chunk_rows=100), "multiple of 16"),
        (dict(chunk_rows=4096, stages=8), "shared memory"),
    ],
)
def test_overrides_that_do_not_fit_raise(tuning, error):
    with pytest.raises(ValueError, match=error):
        lg.plan_launch(1 << 20, Q1_WIDTHS, [0] * 5, 12, 6, **tuning)


def test_overrides_are_taken():
    g = lg.plan_launch(1 << 20, Q1_WIDTHS, [0] * 5, 12, 6, lane_copies=4, stages=3,
                       chunk_rows=4096, blocks_per_sm=1)
    assert (g.lane_copies, g.stages, g.chunk_rows) == (4, 3, 4096)
    assert g.blocks == lg.DEFAULT_SM_COUNT and g.opt_in
    g = lg.plan_launch(1 << 20, Q1_WIDTHS, [0] * 5, 12, 6, chunk_rows=256)
    assert not g.opt_in and g.smem_bytes == 128 + 2 * 2304 + 18432


def test_bad_arrays_raise():
    with pytest.raises(ValueError):
        lg.plan_launch(10, (3,), (0,), 1, 1)
    with pytest.raises(ValueError):
        lg.plan_launch(10, (4,), (2,), 1, 1)  # not aligned to its own width
    with pytest.raises(ValueError):
        lg.plan_launch(10, (1,) * 19, (0,) * 19, 1, 1)


# ---------------------------------------------------------------------------
# the edge cases the card runs: their geometry, and the port against the JAX
# package on their inputs


def _geometry_of(arrays, groups, cells):
    return lg.plan_launch(
        arrays[-1].shape[0], [t.element_size() for t in arrays],
        [t.data_ptr() % 16 for t in arrays], groups, cells,
    )


def _padded(array: np.ndarray, block: int, fill) -> np.ndarray:
    """``array`` extended with ``fill`` to a whole number of blocks."""
    extra = -len(array) % block
    return np.concatenate([array, np.full((extra,), fill, dtype=array.dtype)])


PIECE_CASES = list(kernel_cases.piece_cases())
SUM_CASES = list(kernel_cases.group_sum_cases())


@pytest.mark.parametrize("case", PIECE_CASES, ids=[c["name"] for c in PIECE_CASES])
def test_piece_edge_case(case):
    cols, gid, plans, groups = kernel_cases.piece_inputs(case, "cpu")
    arrays = (*cols, gid)
    g = _geometry_of(arrays, groups, len(plans))
    check_invariants(g, gid.shape[0], [t.element_size() for t in arrays],
                     [t.data_ptr() % 16 for t in arrays], groups, len(plans))
    if case["copies"] is not None:
        assert g.lane_copies == case["copies"]
    if case["name"] == "table limit":
        assert groups * len(plans) * 8 == lg.MAX_TABLE_BYTES
    got = group_piece.grouped_piece_sums(cols, gid, plans, groups)
    cols_np, gid_np = kernel_cases.piece_numpy(case)
    if case["wide_column"]:
        # the JAX package takes columns up to int32 only: numpy in uint64,
        # which wraps as the kernel's int64 does
        gid_np = gid_np.astype(np.int64)
        live = (gid_np >= 0) & (gid_np < groups)
        want = []
        for spec in case["specs"]:
            value = np.ones(gid_np.shape, dtype=np.uint64)
            for f in spec:
                col = cols_np[f.col].astype(np.int64)
                value = value * (col * np.int64(f.scale) + np.int64(f.offset)).astype(np.uint64)
            total = np.zeros((groups,), dtype=np.uint64)
            np.add.at(total, gid_np[live], value[live])
            want.append(total.view(np.int64))
    else:
        block = 512
        ref_plans = tuple(
            ref_piece.plan_spec([ref_piece.Factor(**dataclasses.asdict(f)) for f in spec])
            for spec in case["specs"]
        )
        assert all(p is not None for p in ref_plans)
        want = ref_piece.grouped_piece_sums_xla(
            tuple(jnp.asarray(_padded(c, block, 0)) for c in cols_np),
            jnp.asarray(_padded(gid_np, block, -1)), ref_plans, groups, block=block,
        )
    assert len(got) == len(want) == len(case["specs"])
    for out, w in zip(got, want):
        np.testing.assert_array_equal(out.numpy(), np.asarray(w), err_msg=case["name"])


@pytest.mark.parametrize("case", SUM_CASES, ids=[c["name"] for c in SUM_CASES])
def test_group_sum_edge_case(case):
    cols, gids, mask, groups = kernel_cases.group_sum_inputs(case, "cpu")
    arrays = (*cols, gids, mask)
    g = _geometry_of(arrays, groups, len(cols))
    check_invariants(g, gids.shape[0], [t.element_size() for t in arrays],
                     [t.data_ptr() % 16 for t in arrays], groups, len(cols))
    if case["copies"] is not None:
        assert g.lane_copies == case["copies"]
    got = group_sum.grouped_int64_sums(cols, gids, mask, groups)
    cols_np, gid_np, mask_np = kernel_cases.group_sum_numpy(case)
    block = 2048  # rows of one grid step of the Pallas kernel
    want = ref_sum.grouped_int64_sums(
        tuple(jnp.asarray(_padded(c, block, 0)) for c in cols_np),
        jnp.asarray(_padded(gid_np, block, 0)), jnp.asarray(_padded(mask_np, block, False)),
        num_groups=groups, interpret=True,
    )
    assert len(got) == len(want) == case["ncols"]
    for out, w in zip(got, want):
        np.testing.assert_array_equal(out.numpy(), np.asarray(w), err_msg=case["name"])


def test_sliced_case_tensors_start_off_alignment():
    case = next(c for c in PIECE_CASES if c["name"].startswith("odd slices"))
    cols, gid, _, _ = kernel_cases.piece_inputs(case, "cpu")
    cols_np, gid_np = kernel_cases.piece_numpy(case)
    for t, a in zip((*cols, gid), (*cols_np, gid_np)):
        assert t.is_contiguous() and t.storage_offset() == 1
        assert np.array_equal(t.numpy(), a)
    assert torch.equal(gid, torch.from_numpy(gid_np))
