"""Fused band filter + exact wide sum over int64 columns.

Replaces the TPU kernel ``selective_sum`` of the JAX package
(``velox_tpu/ops/pallas_kernels.py``, kernel body ``_kernel``) and its XLA
twin ``selective_sum_xla``.  It is TPC-H Q6's shape (range filters, one sum);
the reference executor never calls it and neither does this one: it is an op
with its own entry point.

What it computes: a row passes when every filter column k lies in the
inclusive band ``bounds[k] = (lo, hi)``; over passing rows it returns
``sum(v >> 32)``, ``sum(v & 0xFFFFFFFF)`` and the row count as three int64
scalars.  The exact sum is ``hi * 2**32 + lo`` (the same two limbs as the wide
sums of exec/aggregates.py), so int64 products cannot wrap it.

The CUDA kernel (``csrc/kernels.cu`` ``selective_sum_kernel``) is bound by
bytes: one read of the value column and of each filter column.  Grid-stride
loads, the band test against bounds held in kernel parameters, three int64
partials per thread, a shuffle reduction per warp and one per block, and one
global atomic per block and output.  The ragged edge is masked by index, so
nothing is padded and no sentinel is needed.  Integer addition is associative,
so the result equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

MAX_FILTERS = 3


def selective_sum_plain(
    values: torch.Tensor,
    filters: Sequence[torch.Tensor],
    bounds: Sequence[Tuple[int, int]],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: masks and three ``sum`` reductions."""
    v = values.to(torch.int64)
    mask = None
    for f, (lo_b, hi_b) in zip(filters, bounds):
        m = (f >= lo_b) & (f <= hi_b)
        mask = m if mask is None else (mask & m)
    if mask is None:
        sel = v
        count = torch.tensor(v.shape[0], dtype=torch.int64, device=v.device)
    else:
        sel = torch.where(mask, v, torch.zeros_like(v))
        count = mask.sum()
    return (sel >> 32).sum(), (sel & 0xFFFFFFFF).sum(), count


def selective_sum(
    values: torch.Tensor,
    filters: Sequence[torch.Tensor],
    bounds: Sequence[Tuple[int, int]],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """sum/count of ``values`` rows where every filters[k] is within bounds[k].

    Returns (hi_limb, lo_limb, count) as 0-d int64 tensors; exact value =
    hi * 2**32 + lo.  Integer inputs of any width are widened to int64 first.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    filters = tuple(filters)
    bounds = [(int(lo), int(hi)) for lo, hi in bounds]
    if len(filters) != len(bounds):
        raise ValueError("one (lo, hi) band per filter column")
    if len(filters) > MAX_FILTERS:
        raise ValueError(f"at most {MAX_FILTERS} filter columns")
    for t in (values, *filters):
        if t.dim() != 1 or t.shape[0] != values.shape[0]:
            raise ValueError("all operands must be 1-D of one length")
        if t.device != values.device:
            raise ValueError("all operands must lie on one device")
        if t.dtype not in (torch.int8, torch.int16, torch.int32, torch.int64):
            raise TypeError(f"operands must be signed integers, got {t.dtype}")
    if values.device.type == "cpu":
        return selective_sum_plain(values, filters, bounds)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")

    from . import cuda_build

    lib = cuda_build.library()
    v = values.to(torch.int64).contiguous()
    fs = [f.to(torch.int64).contiguous() for f in filters]
    out = torch.zeros((3,), dtype=torch.int64, device=v.device)
    k = max(len(fs), 1)
    f_ptrs = (ctypes.c_void_p * k)(*[f.data_ptr() for f in fs])
    lo = (ctypes.c_longlong * k)(*[b[0] for b in bounds])
    hi = (ctypes.c_longlong * k)(*[b[1] for b in bounds])
    max_blocks, stream = cuda_build.launch_params(v.device)
    code = lib.velox_selective_sum(
        v.data_ptr(),
        ctypes.addressof(f_ptrs),
        ctypes.addressof(lo),
        ctypes.addressof(hi),
        len(fs),
        v.shape[0],
        out.data_ptr(),
        max_blocks,
        stream,
    )
    cuda_build.check(code, "selective_sum")
    cuda_build.count_launch(selective_sum)
    return out[0], out[1], out[2]


selective_sum.launches = 0
