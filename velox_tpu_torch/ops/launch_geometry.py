"""Launch geometry of the two grouped-sum kernels, as a pure function.

``plan_launch`` takes what a wrapper can observe (row count, element widths
and pointer alignments of the staged arrays, groups, cells per group, the
card's multiprocessor count) and returns a frozen ``Geometry``: which rows
are staged and which take the scalar path, the ring of shared-memory stages,
the privatised accumulator table, the shared-memory bytes and the blocks.
The kernels (``csrc/grouped_common.cuh``) decide none of it themselves; they
check it and run it.  The function needs no card, so the CPU tests cover it.

Rows.  A bulk copy needs a 16-byte aligned device address and a size that is
a multiple of 16, for every array at its own width.  ``head`` is the least
row h in 0..15 at which every array's address is aligned (there may be none
when the arrays were sliced at different offsets; then no row is staged and
head is n).  The body is the largest multiple of 16 rows after it; head and
tail rows take the scalar path inside the same launch.

Table.  One logical table is ``groups * cells`` 64-bit words.  ``lane_copies``
(R) is the largest power of two up to 32 whose copies fit in
``TABLE_BUDGET_BYTES`` (TPC-H Q1: 12 groups x 6 specs x 8 B x 32 = 18 KB); at
the table limit (``MAX_TABLE_BYTES``, one copy of 48 KB) it is 1.  The warps
of a block share the R copies and add with native 32-bit shared atomics.

Ring.  What ``BLOCK_SHARED_TARGET`` (a quarter of a multiprocessor's shared
memory, so that four blocks are resident) leaves beside the table is cut into
``stages`` (2) stages; ``chunk_rows`` is the largest power of two between 256
and 4096 whose rows fit a stage (2048 rows at the 9 bytes a row of TPC-H Q1,
512 at 37), halved while the body has fewer chunks than the card has
multiprocessors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

THREADS = 256
MAX_ARRAYS = 18
MAX_STAGES = 8
MAX_TABLE_BYTES = 48 * 1024  # one copy of the table; the wrappers raise above it
MAX_SHARED_BYTES = 232448  # 227 KB: the most dynamic shared memory of one block
DEFAULT_SHARED_BYTES = 48 * 1024  # above it the launch must opt in
SM_SHARED_BYTES = 233472  # 228 KB of one multiprocessor, 1 KB of it reserved per block
BARRIER_BYTES = 128
BLOCK_SHARED_TARGET = SM_SHARED_BYTES // 4 - 1024  # four resident blocks
TABLE_BUDGET_BYTES = 32 * 1024  # the R lane copies of one block
MAX_BLOCKS_PER_SM = 4  # what the kernels' registers allow
MIN_CHUNK_ROWS = 256
MAX_CHUNK_ROWS = 4096
DEFAULT_STAGES = 2
DEFAULT_SM_COUNT = 132  # H100 SXM
# The limits csrc/grouped_common.cuh has its own copy of, in the order the
# library's ``velox_grouped_limits`` reports them (kThreads, kMaxArrays,
# kMaxStages, kMaxSharedBytes, kBarrierBytes); ``cuda_build.library`` compares.
COMPILED_LIMITS = (THREADS, MAX_ARRAYS, MAX_STAGES, MAX_SHARED_BYTES, BARRIER_BYTES)


@dataclasses.dataclass(frozen=True)
class Geometry:
    n: int
    head: int  # rows [0, head): scalar path
    body_rows: int  # rows [head, head + body_rows): staged; multiple of 16
    tail: int  # rows after the body: scalar path
    chunk_rows: int
    stages: int
    stage_bytes: int
    stage_offsets: Tuple[int, ...]  # byte offset of every array's slice in a stage
    lane_copies: int  # R
    table_bytes: int
    smem_bytes: int
    blocks: int

    @property
    def opt_in(self) -> bool:
        """Whether the launch must ask for more than the default 48 KB."""
        return self.smem_bytes > DEFAULT_SHARED_BYTES

    @property
    def n_chunks(self) -> int:
        return -(-self.body_rows // self.chunk_rows)

    def as_c(self) -> Tuple[int, ...]:
        """The numbers in the order ``geometry_from_host`` reads them."""
        return (
            self.n, self.head, self.body_rows, self.chunk_rows, self.stages,
            self.stage_bytes, self.lane_copies, self.smem_bytes, self.blocks,
        )

    def summary(self) -> dict:
        """What a report prints of it."""
        return dict(
            R=self.lane_copies, stages=self.stages, chunk_rows=self.chunk_rows,
            smem_bytes=self.smem_bytes, blocks=self.blocks,
            head=self.head, body_rows=self.body_rows, tail=self.tail,
        )


def split_rows(n: int, widths: Sequence[int], alignments: Sequence[int]) -> Tuple[int, int, int]:
    """(head, body_rows, tail) with head + body_rows + tail == n."""
    head = next(
        (
            h
            for h in range(16)
            if all((a + h * w) % 16 == 0 for w, a in zip(widths, alignments))
        ),
        None,
    )
    if head is None or n - head < 16:
        return n, 0, 0
    body = (n - head) // 16 * 16
    return head, body, n - head - body


def _pow2_floor(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def plan_launch(
    n: int,
    widths: Sequence[int],
    alignments: Sequence[int],
    groups: int,
    cells: int,
    sm_count: int = DEFAULT_SM_COUNT,
    *,
    chunk_rows: Optional[int] = None,
    stages: Optional[int] = None,
    lane_copies: Optional[int] = None,
    blocks_per_sm: Optional[int] = None,
) -> Geometry:
    """The geometry of one launch.

    widths / alignments: bytes per element and ``data_ptr() % 16`` of every
    staged array, in the order the kernel takes them.  groups x cells 64-bit
    accumulators make one table.  The keyword arguments override a choice
    (for measurements and tests); what they ask for must fit, or ValueError.
    """
    widths = tuple(int(w) for w in widths)
    alignments = tuple(int(a) % 16 for a in alignments)
    if not 1 <= len(widths) <= MAX_ARRAYS or len(widths) != len(alignments):
        raise ValueError(f"1..{MAX_ARRAYS} staged arrays with one alignment each")
    if any(w not in (1, 2, 4, 8) for w in widths):
        raise ValueError(f"element widths must be 1, 2, 4 or 8, got {widths}")
    if any(a % w for w, a in zip(widths, alignments)):
        raise ValueError("an array is not aligned to its own element width")
    if n < 0 or groups < 1 or cells < 1:
        raise ValueError("n >= 0, groups >= 1 and cells >= 1 are required")
    single = groups * cells * 8
    if single > MAX_TABLE_BYTES:
        raise ValueError(
            f"{groups} groups x {cells} cells exceed the {MAX_TABLE_BYTES}-byte table"
        )
    head, body_rows, tail = split_rows(n, widths, alignments)

    if lane_copies is None:
        lane_copies = min(32, _pow2_floor(TABLE_BUDGET_BYTES // single))
    if lane_copies not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"lane_copies must be a power of two in 1..32, got {lane_copies}")
    table_bytes = single * lane_copies

    stages = DEFAULT_STAGES if stages is None else stages
    if not 2 <= stages <= MAX_STAGES:
        raise ValueError(f"2..{MAX_STAGES} stages, got {stages}")
    row_bytes = sum(widths)
    if chunk_rows is None:
        room = max(BLOCK_SHARED_TARGET - BARRIER_BYTES - table_bytes, 0)
        chunk_rows = _pow2_floor(room // stages // row_bytes)
        chunk_rows = min(max(chunk_rows, MIN_CHUNK_ROWS), MAX_CHUNK_ROWS)
        while chunk_rows > MIN_CHUNK_ROWS and -(-body_rows // chunk_rows) < sm_count:
            chunk_rows //= 2
    if chunk_rows < 16 or chunk_rows % 16:
        raise ValueError(f"chunk_rows must be a positive multiple of 16, got {chunk_rows}")
    offsets, at = [], 0
    for w in widths:
        offsets.append(at)
        at += chunk_rows * w
    stage_bytes = -(-at // 128) * 128
    smem_bytes = BARRIER_BYTES + stages * stage_bytes + table_bytes
    if smem_bytes > MAX_SHARED_BYTES:
        raise ValueError(f"{smem_bytes} bytes of shared memory exceed {MAX_SHARED_BYTES}")

    if blocks_per_sm is None:
        blocks_per_sm = SM_SHARED_BYTES // (smem_bytes + 1024)
    blocks_per_sm = min(max(blocks_per_sm, 1), MAX_BLOCKS_PER_SM)
    work = max(-(-body_rows // chunk_rows), -(-(head + tail) // THREADS), 1)
    blocks = min(sm_count * blocks_per_sm, work)
    return Geometry(
        n=n, head=head, body_rows=body_rows, tail=tail, chunk_rows=chunk_rows,
        stages=stages, stage_bytes=stage_bytes, stage_offsets=tuple(offsets),
        lane_copies=lane_copies, table_bytes=table_bytes, smem_bytes=smem_bytes, blocks=blocks,
    )
