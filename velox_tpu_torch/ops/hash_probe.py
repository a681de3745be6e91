"""A hash-table probe for a unique-key join, on the card (K5).

Replaces no TPU kernel: the JAX package probes a unique-key join by a merge
sort of the build keys with every probe tile (``velox_tpu/exec/joins.py:1295
_probe_fused``, which is no Pallas kernel), and so does this package's
``exec/joins.py HashJoinExec._probe_fused``.  Where no consumer reads the
join's key order, ``HashJoinExec`` looks each probe row up here instead: the
reference probes a hash table too (velox/exec/HashTable.cpp:360).

What it computes: for probe row i, the slot id (the position among the
build's sorted, unique, valid keys) whose key equals ``keys[i]``, or -1 when
the row is dead, its key is NULL or outside ``[kmin, kmax]``, or no build key
equals it.  ``build_hash_table`` inserts the keys once an executor into an
open-addressing table of int32 slot ids (linear probing from a Fibonacci
hash, at least twice as many slots as keys); ``hash_probe`` is one launch a
probe batch.

The CUDA kernels (``csrc/hash_probe.cu``) are bound by bytes: a probe row
costs its selection byte, its validity byte and 4 bytes out, a live one its
key in its stored width too, and only a live row with a key in range reads
the table.  Each ``hash_probe`` call is one
``velox.hprobe[rows=,slots=,build_rows=]`` span (``utils/trace.py``) while a
profiler records: the probe rows, the table's slots and the build keys, all
known on the host.  On the CPU the plain version runs: a binary search of the
sorted keys, which gives the same slot ids because the keys are unique.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..utils.trace import span


def table_log2(n: int) -> int:
    """log2 of the table's slots for ``n`` keys: the power of two at least
    2 n, and at least 2."""
    return max(1, (2 * n - 1).bit_length())


@dataclasses.dataclass
class HashTable:
    """The build side of a hashed probe: ``keys`` the sorted unique int64
    keys, ``slots`` their table on the card (None on the CPU), every key in
    ``[kmin, kmax]``."""

    keys: torch.Tensor
    slots: Optional[torch.Tensor]
    log2cap: int
    kmin: int
    kmax: int

    @property
    def capacity(self) -> int:
        return 1 << self.log2cap

    @staticmethod
    def nbytes(n: int) -> int:
        """Device bytes of the table for ``n`` keys (the keys are the build's)."""
        return 4 << table_log2(n)


def build_hash_table(keys: torch.Tensor, kmin: int, kmax: int) -> HashTable:
    """The table over ``keys`` (1-D int64, sorted, unique, within
    ``[kmin, kmax]``): one launch of the build kernel on a CUDA device."""
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise TypeError("keys must be 1-D contiguous int64")
    n = keys.shape[0]
    log2cap = table_log2(n)
    if keys.device.type == "cpu":
        return HashTable(keys, None, log2cap, kmin, kmax)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    from . import cuda_build

    slots = torch.full((1 << log2cap,), -1, dtype=torch.int32, device=keys.device)
    max_blocks, stream = cuda_build.launch_params(keys.device)
    code = cuda_build.library().velox_hash_build(
        keys.data_ptr(), n, slots.data_ptr(), log2cap, max_blocks, stream
    )
    cuda_build.check(code, "hash_build")
    cuda_build.count_launch(build_hash_table)
    return HashTable(keys, slots, log2cap, kmin, kmax)


def _live(keys, length, selection, validity) -> torch.Tensor:
    live = torch.arange(keys.shape[0], device=keys.device) < length
    for mask in (selection, validity):
        if mask is not None:
            live = live & mask
    return live


def hash_probe_plain(
    table: HashTable,
    keys: torch.Tensor,
    length: torch.Tensor,
    selection: Optional[torch.Tensor] = None,
    validity: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version: ``searchsorted`` over the sorted keys and
    an equality test.  It runs wherever its operands lie."""
    k = keys.to(torch.int64)
    n = table.keys.shape[0]
    ok = _live(k, length, selection, validity) & (k >= table.kmin) & (k <= table.kmax)
    if n == 0:
        return torch.full(k.shape, -1, dtype=torch.int32, device=k.device)
    pos = torch.searchsorted(table.keys, k).clamp(max=n - 1)
    hit = ok & (table.keys.index_select(0, pos) == k)
    return torch.where(hit, pos, torch.full_like(pos, -1)).to(torch.int32)


def hash_probe(
    table: HashTable,
    keys: torch.Tensor,
    length: torch.Tensor,
    selection: Optional[torch.Tensor] = None,
    validity: Optional[torch.Tensor] = None,
    walk: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[rows] int32 build slot ids (-1: no match) of the probe ``keys``.

    keys: 1-D integers of 1, 2, 4 or 8 bytes; length: 0-d int32, the rows
    below it live; selection and validity: bool masks or None.  ``walk``, a
    one-element int32 tensor on the card, takes the longest walk (slots read
    by one row) where it is larger.  CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version."""
    rows = keys.shape[0]
    if keys.dim() != 1 or keys.dtype.is_floating_point or keys.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"keys must be 1-D integers, got {keys.dtype}")
    for mask in (selection, validity):
        if mask is not None and (mask.dtype != torch.bool or mask.shape != (rows,)):
            raise ValueError("selection and validity must be bool of the keys' length")
    operands = lambda: dict(  # noqa: E731
        rows=rows, slots=table.capacity, build_rows=table.keys.shape[0])
    with span("hprobe", operands):
        if keys.device.type == "cpu":
            return hash_probe_plain(table, keys, length, selection, validity)
        if keys.device.type != "cuda":
            raise ValueError(f"unsupported device {keys.device}")
        return _launch(table, keys, length, selection, validity, walk)


def _launch(table, keys, length, selection, validity, walk) -> torch.Tensor:
    """One launch of the probe kernel over checked operands."""
    from . import cuda_build

    for t in (keys, length, selection, validity, walk, table.slots):
        if t is not None and (t.device != keys.device or not t.is_contiguous()):
            raise ValueError("operands must be contiguous and on the keys' device")
    if length.dtype != torch.int32 or length.numel() != 1:
        raise TypeError("length must be one int32")
    if walk is not None and (walk.dtype != torch.int32 or walk.numel() != 1):
        raise TypeError("walk must be one int32")
    out = torch.empty((keys.shape[0],), dtype=torch.int32, device=keys.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    max_blocks, stream = cuda_build.launch_params(keys.device)
    code = cuda_build.library().velox_hash_probe(
        keys.data_ptr(), keys.element_size(), length.data_ptr(),
        ptr(selection), ptr(validity), keys.shape[0],
        table.keys.data_ptr(), table.slots.data_ptr(), table.log2cap,
        table.kmin, table.kmax, out.data_ptr(), ptr(walk), max_blocks, stream,
    )
    cuda_build.check(code, "hash_probe")
    cuda_build.count_launch(hash_probe)
    return out


hash_probe.launches = 0
build_hash_table.launches = 0
