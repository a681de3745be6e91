"""SQL ``LIKE`` over every entry of a string dictionary, on the card.

Replaces no TPU kernel: the JAX package evaluates ``like`` once per
dictionary entry in host Python while the plan is bound
(``expr/binding.py _bind_like``), and so did this package.  That costs about
0.7 us an entry, some 10 s for the 15 M distinct ``o_comment`` values of
TPC-H at SF 10, and it repeats for every plan because each query brings its
own pattern.  Here a pattern made only of literal text and ``%`` becomes a
``LikePattern``; ``expr/ir.py LikeTable`` runs it through ``dict_like`` the
first time the executor evaluates the node, and the device gathers the row
results through the entry results as before.  Patterns with ``_`` or an
ESCAPE keep the bind-time path.

What it computes: for entry i, the UTF-8 bytes ``data[offsets[i]:offsets[i+1]]``,
whether the pattern matches.  Such a pattern is ``prefix % m1 % ... % mk %
suffix`` (or, with no ``%``, one literal the entry must equal).  The entry
must start with ``prefix``, end with ``suffix`` with the two not overlapping,
and hold ``m1 .. mk`` in order between them; taking each middle segment at
its leftmost place after the previous one is exact, and on bytes it is exact
for any UTF-8 text, because a valid UTF-8 segment can only match at a
character boundary.

The CUDA kernel (``csrc/dict_like.cu``) is bound by bytes: it reads every
entry's bytes and offsets once and writes one byte an entry.  A block of the
one-pass grid stages the bytes of its 256 entries into shared memory with
16-byte loads that neighbouring threads take from neighbouring addresses,
then each thread matches its own entry there, eight bytes a step.  The bytes
and offsets lie in the card's memory, uploaded once a dictionary
(``vector/string_table.py StringTable.byte_arrays``).  Each call is one
``velox.like[entries=,bytes=]`` span (``utils/trace.py``) while a profiler
records: ``bytes`` is what the launch must move, the entries' bytes, the
offsets and one result byte an entry.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from ..utils.trace import span

# what the kernel's parameter block holds (csrc/dict_like.cu kMaxPatternBytes,
# kMaxSegments); a longer pattern keeps the bind-time path
MAX_PATTERN_BYTES = 1024
MAX_SEGMENTS = 32


@dataclasses.dataclass(frozen=True)
class LikePattern:
    """``prefix % middle[0] % ... % suffix`` as UTF-8 bytes; ``exact``: the
    pattern has no ``%`` and the entry must equal ``prefix``."""

    prefix: bytes
    middle: Tuple[bytes, ...]
    suffix: bytes
    exact: bool

    def text(self) -> bytes:
        return self.prefix + b"".join(self.middle) + self.suffix


def _utf8(s: str) -> bytes:
    return s.encode("utf-8", "surrogatepass")


def parse_like(pattern: str) -> Optional[LikePattern]:
    """The pattern's segments, or None when it needs the bind-time path: it
    has ``_`` or more than the kernel's parameter block holds."""
    if "_" in pattern:
        return None
    parts = pattern.split("%")
    if len(parts) == 1:
        out = LikePattern(_utf8(pattern), (), b"", True)
    else:
        middle = tuple(_utf8(p) for p in parts[1:-1] if p)
        out = LikePattern(_utf8(parts[0]), middle, _utf8(parts[-1]), False)
    if len(out.text()) > MAX_PATTERN_BYTES or len(out.middle) > MAX_SEGMENTS:
        return None
    return out


def launch_bytes(total_bytes: int, entries: int, offset_width: int = 4) -> int:
    """Bytes one launch must move: every entry's bytes and the offsets read
    once, one result byte an entry written once."""
    return total_bytes + offset_width * (entries + 1) + entries


def _hits(data: torch.Tensor, seg: bytes) -> torch.Tensor:
    """[B + 1] bool: ``seg`` starts at byte p (p = B never)."""
    n = data.shape[0]
    out = torch.zeros(n + 1, dtype=torch.bool, device=data.device)
    k = len(seg)
    if n >= k:
        m = data[: n - k + 1] == seg[0]
        for t in range(1, k):
            m &= data[t : n - k + 1 + t] == seg[t]
        out[: n - k + 1] = m
    return out


def dict_like_plain(data: torch.Tensor, offsets: torch.Tensor, pattern: LikePattern) -> torch.Tensor:
    """The plain PyTorch version, over the flat bytes: where each segment
    starts, and for the middle ones the next start at or after each byte.
    It runs wherever its operands lie (the card's tests run it there)."""
    starts, ends = offsets[:-1].long(), offsets[1:].long()
    lens = ends - starts
    n_bytes = data.shape[0]
    p, s = len(pattern.prefix), len(pattern.suffix)
    ok = lens == p if pattern.exact else lens >= p + s
    if p:
        ok &= _hits(data, pattern.prefix)[starts.clamp(max=n_bytes)]
    if s:
        ok &= _hits(data, pattern.suffix)[(ends - s).clamp(min=0)]
    pos, limit = starts + p, ends - s
    never = n_bytes + 1
    for seg in pattern.middle:
        hit = _hits(data, seg)
        at = torch.where(hit, torch.arange(n_bytes + 1, device=data.device), never)
        following = at.flip(0).cummin(0).values.flip(0)  # next start at or after each byte
        found = following[pos.clamp(max=n_bytes)]
        ok &= found + len(seg) <= limit
        pos = (found + len(seg)).clamp(max=n_bytes)
    return ok


def dict_like(data: torch.Tensor, offsets: torch.Tensor, pattern: LikePattern, device) -> torch.Tensor:
    """[entries] bool on ``device``: whether each dictionary entry matches.

    data: uint8 bytes of every entry, end to end; offsets: int32 or int64,
    entries + 1 of them, both on ``device``.  On the CPU the plain version
    runs; on a CUDA device the kernel launches (or raises)."""
    device = torch.device(device)
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError("data must be 1-D uint8")
    if offsets.dtype not in (torch.int32, torch.int64) or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise TypeError("offsets must be 1-D int32 or int64 with one more element than entries")
    entries = offsets.shape[0] - 1
    operands = lambda: dict(  # noqa: E731
        entries=entries, bytes=launch_bytes(data.shape[0], entries, offsets.element_size()))
    with span("like", operands):
        if device.type == "cpu":
            return dict_like_plain(data.cpu(), offsets.cpu(), pattern)
        if device.type != "cuda":
            raise ValueError(f"unsupported device {device}")
        return _launch(data, offsets, pattern, device)


def _launch(data, offsets, pattern: LikePattern, device) -> torch.Tensor:
    """One launch of the CUDA kernel over checked operands."""
    from . import cuda_build

    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    entries = offsets.shape[0] - 1
    out = torch.empty((entries,), dtype=torch.bool, device=device)
    if entries == 0:
        return out
    for t in (data, offsets):
        if t.device != device:
            raise ValueError(f"operand on {t.device}, launch on {device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    lib = cuda_build.library()
    text = pattern.text()
    seg_lens = [len(pattern.prefix), *(len(m) for m in pattern.middle), len(pattern.suffix)]
    lens = (ctypes.c_int * len(seg_lens))(*seg_lens)
    buf = ctypes.create_string_buffer(text, max(len(text), 1))
    stream = torch.cuda.current_stream(device).cuda_stream
    code = lib.velox_dict_like(
        data.data_ptr(),
        offsets.data_ptr(),
        1 if offsets.dtype == torch.int64 else 0,
        entries,
        ctypes.addressof(buf),
        len(text),
        ctypes.addressof(lens),
        len(pattern.middle),
        1 if pattern.exact else 0,
        out.data_ptr(),
        stream,
    )
    cuda_build.check(code, "dict_like")
    cuda_build.count_launch(dict_like)
    return out


dict_like.launches = 0
