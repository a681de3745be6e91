"""Grouped wrapping int64 sums of several columns in one pass.

Replaces the TPU kernel ``grouped_int64_sums`` of the JAX package
(``velox_tpu/ops/pallas_group_sum.py``, kernel body ``_kernel``), which the
reference executor never calls.  Here it is on the executor's path:
ops/segmented.py ``direct_group_reduce`` sends every wrapping int64 sum whose
table fits (one column, at most 6 144 groups) to it, one launch a column:
every int64 accumulator of an array-mode aggregation, and its row count, over
a tile that does not take the piece path (ops/group_piece.py).  Each call is
one ``velox.k3[rows=,widths=,groups=]`` span (utils/trace.py) while a
profiler records.

What it computes: per group g, for every column, the sum over rows with
``mask`` set and ``gids == g``, wrapping mod 2**64.

The CUDA kernel (``csrc/grouped_int64_sums.cu``, shared parts in
``csrc/grouped_common.cuh``) is bound by bytes: one read of every column, of
the group ids and of the mask, 8 bytes a column for one add.  The aligned body
of the rows streams through a ring of shared-memory stages filled by bulk
asynchronous copies, several chunks in flight per block, every byte read from
device memory once; an unaligned head and a tail of fewer than 16 rows take a
scalar path inside the same launch.  The accumulator table ``[G][ncols]`` is
privatised as in ``ops/group_piece.py`` (``R`` copies, copy index fastest, one
per lane, added to with native 32-bit shared atomics and a carry), summed by
the block and published once into a ``[ncols][G]`` output.
``ops/launch_geometry.py plan_launch`` chooses the geometry.  The reference's
7-bit limbs and one-hot matmuls stood in for missing int64 and scatter support
and have no counterpart here.  A table over 48 KB (one copy) raises; there is
no fallback.  Two's-complement addition wraps the same way in any order, so
the result equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..utils.trace import span
from . import launch_geometry

MAX_COLS = 16
MAX_TABLE_BYTES = launch_geometry.MAX_TABLE_BYTES


def grouped_int64_sums_plain(
    cols: Sequence[torch.Tensor],
    gids: torch.Tensor,
    mask: torch.Tensor,
    num_groups: int,
) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version: masked values and ``index_add_``."""
    gid = gids.to(torch.int64)
    live = mask & (gid >= 0) & (gid < num_groups)
    index = torch.where(live, gid, torch.zeros_like(gid))
    out = []
    for c in cols:
        value = torch.where(live, c, torch.zeros_like(c))
        total = torch.zeros((num_groups,), dtype=torch.int64, device=c.device)
        out.append(total.index_add_(0, index, value))
    return tuple(out)


def grouped_int64_sums(
    cols: Sequence[torch.Tensor],
    gids: torch.Tensor,
    mask: torch.Tensor,
    num_groups: int,
) -> Tuple[torch.Tensor, ...]:
    """[num_groups] wrapping int64 sum per group for every column.

    cols: (N,) int64 tensors; gids int32; mask bool.  Returns a tuple of
    (num_groups,) int64 tensors.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    cols = tuple(cols)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"1..{MAX_COLS} columns, got {len(cols)}")
    if num_groups < 1:
        raise ValueError(f"num_groups must be positive, got {num_groups}")
    n = gids.shape[0]
    if gids.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError("gids must be int32 and mask bool")
    for t in (*cols, gids, mask):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError("all operands must be 1-D of one length")
        if t.device != gids.device:
            raise ValueError("all operands must lie on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    for c in cols:
        if c.dtype != torch.int64:
            raise TypeError(f"columns must be int64, got {c.dtype}")
    if num_groups * len(cols) * 8 > MAX_TABLE_BYTES:
        raise ValueError(
            f"{num_groups} groups x {len(cols)} columns exceed the "
            f"{MAX_TABLE_BYTES}-byte shared-memory table"
        )
    # the operands that set the bytes a launch moves, in the trace
    operands = lambda: dict(  # noqa: E731
        rows=n, widths=[t.element_size() for t in (*cols, gids, mask)], groups=num_groups,
    )
    with span("k3", operands):
        if gids.device.type == "cpu":
            return grouped_int64_sums_plain(cols, gids, mask, num_groups)
        if gids.device.type != "cuda":
            raise ValueError(f"unsupported device {gids.device}")
        return _launch(cols, gids, mask, num_groups)


def _launch(cols, gids, mask, num_groups) -> Tuple[torch.Tensor, ...]:
    """One launch of the CUDA kernel over checked operands."""
    from . import cuda_build

    lib = cuda_build.library()
    arrays = (*cols, gids, mask)  # the order the kernel takes them in
    sm_count, stream = cuda_build.sm_count_and_stream(gids.device)
    geometry = launch_geometry.plan_launch(
        gids.shape[0],
        [t.element_size() for t in arrays],
        [t.data_ptr() % 16 for t in arrays],
        num_groups,
        len(cols),
        sm_count,
    )
    out = torch.zeros(
        (len(cols), num_groups), dtype=torch.int64, device=gids.device
    )
    ptrs = (ctypes.c_void_p * len(arrays))(*[t.data_ptr() for t in arrays])
    stage_off = (ctypes.c_int * len(arrays))(*geometry.stage_offsets)
    geom = (ctypes.c_longlong * len(geometry.as_c()))(*geometry.as_c())
    code = lib.velox_grouped_int64_sums(
        ctypes.addressof(ptrs),
        ctypes.addressof(stage_off),
        len(cols),
        ctypes.addressof(geom),
        num_groups,
        out.data_ptr(),
        stream,
    )
    cuda_build.check(code, "grouped_int64_sums")
    cuda_build.count_launch(grouped_int64_sums)
    grouped_int64_sums.last_geometry = geometry
    return tuple(out.unbind(0))


grouped_int64_sums.launches = 0
grouped_int64_sums.last_geometry = None  # the Geometry of the newest launch
