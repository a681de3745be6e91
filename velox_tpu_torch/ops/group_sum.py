"""Grouped wrapping int64 sums of several columns in one pass.

Replaces the TPU kernel ``grouped_int64_sums`` of the JAX package
(``velox_tpu/ops/pallas_group_sum.py``, kernel body ``_kernel``).  It is the
general form under array-mode grouped sums (ops/segmented.py
``direct_group_reduce``); the reference executor never calls it and neither
does this one: it is an op with its own entry point.

What it computes: per group g, for every column, the sum over rows with
``mask`` set and ``gids == g``, wrapping mod 2**64.

The CUDA kernel (``csrc/kernels.cu`` ``grouped_int64_sums_kernel``) is bound by
bytes: one read of every column, of the group ids and of the mask.  A block
adds its rows into a shared-memory table ``[G][ncols]`` of 64-bit accumulators
with shared atomics and publishes it once with global atomics.  The
reference's 7-bit limbs and one-hot matmuls stood in for missing int64 and
scatter support and have no counterpart here.  A table over 48 KB of shared
memory raises; there is no fallback.  Two's-complement addition wraps the same
way in any order, so the result equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

MAX_COLS = 16
MAX_TABLE_BYTES = 48 * 1024


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
    if gids.device.type == "cpu":
        return grouped_int64_sums_plain(cols, gids, mask, num_groups)
    if gids.device.type != "cuda":
        raise ValueError(f"unsupported device {gids.device}")

    from . import cuda_build

    lib = cuda_build.library()
    out = torch.zeros(
        (num_groups, len(cols)), dtype=torch.int64, device=gids.device
    )
    col_ptrs = (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols])
    max_blocks, stream = cuda_build.launch_params(gids.device)
    code = lib.velox_grouped_int64_sums(
        ctypes.addressof(col_ptrs),
        len(cols),
        gids.data_ptr(),
        mask.data_ptr(),
        n,
        num_groups,
        out.data_ptr(),
        max_blocks,
        stream,
    )
    cuda_build.check(code, "grouped_int64_sums")
    grouped_int64_sums.launches += 1
    return tuple(out.t().contiguous().unbind(0))


grouped_int64_sums.launches = 0
