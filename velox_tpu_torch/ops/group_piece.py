"""Exact grouped sums of affine products over NARROW columns in one pass.

Replaces the TPU kernel ``grouped_piece_sums`` of the JAX package
(``velox_tpu/ops/pallas_group_piece.py``, kernel body ``_make_kernel``) and
its XLA twin ``grouped_piece_sums_xla``, which is what the reference executor
calls from ``AggExecutor._piece_update``.

What it computes: for every ``SpecPlan``, per group g,
``sum over rows with gid == g of prod_f (scale_f * col_f + offset_f)`` as an
exact int64; the empty spec counts live rows; ``gid < 0`` marks a dead row.
The columns are the raw scan columns at the width they were uploaded with
(int8 / int16 / int32), so a whole array-mode aggregation reads each scanned
byte once.

The CUDA kernel (``csrc/grouped_piece_sums.cu``, shared parts in
``csrc/grouped_common.cuh``) moves few bytes (TPC-H Q1: 9 a row), so it is
built to spend as little as possible on each of them:

* the aligned body of the rows reaches shared memory by bulk asynchronous
  copies into a ring of stages, each input byte read from device memory once,
  the next chunks in flight while this one is summed; an unaligned head and a
  tail of fewer than 16 rows take a scalar path inside the same launch;
* a thread holds 8 rows at a time and walks spec by spec, factor by factor,
  rows innermost: the products are native 64-bit multiply-adds in registers,
  and a column named by several factors is re-read from shared memory only;
* the accumulator table ``[G][n_specs]`` is privatised: ``R`` copies with the
  copy index fastest, one per lane at ``R = 32``, so that no two lanes of a
  warp add to one address; the warps of a block share the copies and add with
  native 32-bit shared atomics and a carry (the 64-bit shared ``atomicAdd`` is
  a compare-and-swap loop on this card); at the table limit ``R`` is 1;
* a spec whose factors begin with all the factors of the spec before it goes
  on from that spec's product;
* the block sums its copies and publishes each non-zero cell with one global
  atomic into a ``[n_specs][G]`` output, which the wrapper returns unbound.

``ops/launch_geometry.py plan_launch`` chooses all of that (row split, chunk
rows, stages, ``R``, shared memory, blocks) from what the wrapper observes;
the kernel only checks it.  The specs travel as kernel parameters, so one
compiled kernel serves every plan.  The reference's piece machinery (chunked
<= 17-bit pieces, hi/lo int32 scratch, one-hot matmuls) exists because its
target had neither int64 nor cheap scatter; none of it is needed here, and
``plan_spec``'s chunking fields are only read by the planner's gates
(``AggExecutor.try_enable_piece_path``).

Integer addition wraps and is associative, so kernel and plain version agree
bit for bit whatever the order of the additions.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.trace import span
from . import launch_geometry

PIECE_MAX = (1 << 17) - 1
PIECE_MAX_PALLAS = (1 << 14) - 1  # the reference kernel's own piece bound
_I32_MAX = (1 << 31) - 1

MAX_COLS = 16
MAX_SPECS = 16
MAX_FACTORS = 48
MAX_TABLE_BYTES = launch_geometry.MAX_TABLE_BYTES
_WIDTHS = {torch.int8: 1, torch.int16: 2, torch.int32: 4, torch.int64: 8}


@dataclasses.dataclass(frozen=True)
class Factor:
    """One affine factor scale*col + offset with proven value bounds."""

    col: int  # index into the kernel's column operands
    scale: int
    offset: int
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class SpecPlan:
    """Piece decomposition of sum(prod of factors) for one accumulator.

    The first ``n_prefix`` factors multiply into an int32 prefix (every
    cumulative bound < 2^31); the rest multiply into an int32 ``rest``
    term.  If the full product exceeds the piece bound the prefix is split
    into ``n_chunks`` chunks of ``chunk_w`` bits, each multiplied by ``rest``.
    An empty factor list is the count spec (piece = 1 per live row).

    The planner's gates read these fields (a spec that cannot be planned
    keeps the aggregation off this path, as in the reference); the kernel
    here multiplies in int64 and needs only ``factors``."""

    factors: Tuple[Factor, ...]
    n_prefix: int
    chunk_w: int
    n_chunks: int
    piece_bound: int = PIECE_MAX  # max value of any one piece


def plan_spec(
    factors: Sequence[Factor], piece_max: int = PIECE_MAX
) -> Optional[SpecPlan]:
    """Decompose one sum spec; None when the bounds cannot prove an exact
    int32 lowering (negative values, > 2^31 partials, chunk width < 1)."""
    if not factors:
        return SpecPlan((), 0, 0, 1, 1)
    for f in factors:
        if f.lo < 0 or f.hi < 0 or f.hi > _I32_MAX:
            return None
    prefix_bound, k = 1, 0
    for f in factors:
        nxt = prefix_bound * max(f.hi, 1)
        if nxt > _I32_MAX and k > 0:
            break
        if nxt > _I32_MAX:
            return None  # a single factor overflowing int32
        prefix_bound, k = nxt, k + 1
    rest_bound = 1
    for f in factors[k:]:
        rest_bound *= max(f.hi, 1)
        if rest_bound > _I32_MAX:
            return None
    if prefix_bound * rest_bound <= piece_max:
        return SpecPlan(tuple(factors), k, 0, 1, prefix_bound * rest_bound)
    w = int(np.floor(np.log2(piece_max / max(rest_bound, 1))))
    if w < 1:
        return None
    n_chunks = (int(prefix_bound).bit_length() + w - 1) // w
    return SpecPlan(tuple(factors), k, w, n_chunks, ((1 << w) - 1) * rest_bound)


def grouped_piece_sums_plain(
    cols: Sequence[torch.Tensor],
    gid_live: torch.Tensor,
    plans: Sequence[SpecPlan],
    num_groups: int,
) -> List[torch.Tensor]:
    """The plain PyTorch version: int64 products and ``index_add_``."""
    device = gid_live.device
    gid = gid_live.to(torch.int64)
    live = (gid >= 0) & (gid < num_groups)
    index = torch.where(live, gid, torch.zeros_like(gid))
    wide = [c.to(torch.int64) for c in cols]
    out = []
    for plan in plans:
        value = live.to(torch.int64)
        for f in plan.factors:
            value = value * (wide[f.col] * f.scale + f.offset)
        total = torch.zeros((num_groups,), dtype=torch.int64, device=device)
        out.append(total.index_add_(0, index, value))
    return out


def _check_inputs(cols, gid_live, plans, num_groups):
    n = gid_live.shape[0]
    if gid_live.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"gid_live must be int8 or int32, got {gid_live.dtype}")
    if not 1 <= num_groups:
        raise ValueError(f"num_groups must be positive, got {num_groups}")
    if len(cols) > MAX_COLS:
        raise ValueError(f"at most {MAX_COLS} columns, got {len(cols)}")
    if not 1 <= len(plans) <= MAX_SPECS:
        raise ValueError(f"1..{MAX_SPECS} specs, got {len(plans)}")
    if sum(len(p.factors) for p in plans) > MAX_FACTORS:
        raise ValueError(f"at most {MAX_FACTORS} factors over all specs")
    if num_groups * len(plans) * 8 > MAX_TABLE_BYTES:
        raise ValueError(
            f"{num_groups} groups x {len(plans)} specs exceed the "
            f"{MAX_TABLE_BYTES}-byte shared-memory table"
        )
    for t in (*cols, gid_live):
        if t.device != gid_live.device:
            raise ValueError("all operands must lie on one device")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError("all operands must be 1-D of one length")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    for c in cols:
        if c.dtype not in _WIDTHS:
            raise TypeError(f"columns must be int8/16/32/64, got {c.dtype}")
    for p in plans:
        for f in p.factors:
            if not 0 <= f.col < len(cols):
                raise ValueError(f"factor column {f.col} out of range")


def grouped_piece_sums(
    cols: Sequence[torch.Tensor],
    gid_live: torch.Tensor,
    plans: Sequence[SpecPlan],
    num_groups: int,
) -> List[torch.Tensor]:
    """Per-group int64 sums for every spec in ``plans``.

    cols: narrow integer columns (any of int8/16/32/64), shape (N,).
    gid_live: int8/int32 group id per row, negative for dead rows (the live
    mask folded in).  Returns one (num_groups,) int64 tensor per spec.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    cols = tuple(cols)
    plans = tuple(plans)
    _check_inputs(cols, gid_live, plans, num_groups)
    # the operands that set the bytes a launch moves, in the trace
    operands = lambda: dict(  # noqa: E731
        rows=gid_live.shape[0], widths=[t.element_size() for t in (*cols, gid_live)],
        specs=len(plans), groups=num_groups,
    )
    with span("k2", operands):
        if gid_live.device.type == "cpu":
            return grouped_piece_sums_plain(cols, gid_live, plans, num_groups)
        if gid_live.device.type != "cuda":
            raise ValueError(f"unsupported device {gid_live.device}")
        return _launch(cols, gid_live, plans, num_groups)


def _launch(cols, gid_live, plans, num_groups) -> List[torch.Tensor]:
    """One launch of the CUDA kernel over checked operands."""
    from . import cuda_build

    lib = cuda_build.library()
    n_specs = len(plans)
    arrays = (*cols, gid_live)  # the kernel takes the group ids last
    sm_count, stream = cuda_build.sm_count_and_stream(gid_live.device)
    geometry = launch_geometry.plan_launch(
        gid_live.shape[0],
        [_WIDTHS[t.dtype] for t in arrays],
        [t.data_ptr() % 16 for t in arrays],
        num_groups,
        n_specs,
        sm_count,
    )
    out = torch.zeros(
        (n_specs, num_groups), dtype=torch.int64, device=gid_live.device
    )
    spec_start, f_col, f_scale, f_offset = [0], [], [], []
    for p in plans:
        for f in p.factors:
            f_col.append(f.col)
            f_scale.append(f.scale)
            f_offset.append(f.offset)
        spec_start.append(len(f_col))
    nf = max(len(f_col), 1)
    na = len(arrays)
    ptrs = (ctypes.c_void_p * na)(*[t.data_ptr() for t in arrays])
    widths = (ctypes.c_int * na)(*[_WIDTHS[t.dtype] for t in arrays])
    stage_off = (ctypes.c_int * na)(*geometry.stage_offsets)
    geom = (ctypes.c_longlong * len(geometry.as_c()))(*geometry.as_c())
    starts = (ctypes.c_int * (n_specs + 1))(*spec_start)
    fcols = (ctypes.c_int * nf)(*f_col)
    fscales = (ctypes.c_longlong * nf)(*f_scale)
    foffsets = (ctypes.c_longlong * nf)(*f_offset)
    code = lib.velox_grouped_piece_sums(
        ctypes.addressof(ptrs),
        ctypes.addressof(widths),
        ctypes.addressof(stage_off),
        na,
        ctypes.addressof(geom),
        ctypes.addressof(starts),
        n_specs,
        ctypes.addressof(fcols),
        ctypes.addressof(fscales),
        ctypes.addressof(foffsets),
        num_groups,
        out.data_ptr(),
        stream,
    )
    cuda_build.check(code, "grouped_piece_sums")
    cuda_build.count_launch(grouped_piece_sums)
    grouped_piece_sums.last_geometry = geometry
    return list(out.unbind(0))


grouped_piece_sums.launches = 0
grouped_piece_sums.last_geometry = None  # the Geometry of the newest launch
