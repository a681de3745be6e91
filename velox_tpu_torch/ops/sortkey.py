"""Normalized sort-key packing: many sort operands -> one int64 operand.

Counterpart of the JAX package's ``ops/sortkey.py``.  Reference:
velox/exec/VectorHasher.h:118 (range-mode value ids) and
velox/exec/HashTable.h:74 (kNormalizedKey) — the reference packs multi-column
keys into one 64-bit normalized key so its hash table can compare single
words.  Here the same trick feeds ``torch.sort``, which takes ONE tensor:
packing (liveness, key columns, payload row-id) into one int64 turns a
several-key sort into a single radix sort, and the row id in the low bits
makes every word unique, so the carried operands follow through the returned
permutation.

The pack is purely order-preserving arithmetic: each field occupies a fixed
bit span sized from *host-known inclusive bounds* (``fit`` below).  Bounds come
from table column stats (io/table.py Table.column_bounds) resolved through the
plan (exec/runner.py resolve_column_bounds) or from join build sides
(exec/joins.py _NormalizedKey).  When the total width exceeds 63 bits the
caller falls back to the several-key sort (``sort_operands``) — exactly the
reference's kNormalizedKey -> kHash degradation (HashTable.cpp decideHashMode).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


def sort_operands(
    operands: Sequence[torch.Tensor], num_keys: int = 1
) -> List[torch.Tensor]:
    """Sort same-length tensors together by the first ``num_keys`` of them,
    lexicographically and stably (the JAX package's
    ``jax.lax.sort(operands, num_keys=...)``).

    ``torch.sort`` takes one tensor and there is no lexsort, so the keys are
    sorted from the last to the first with ``stable=True``, composing the
    permutations; every operand then moves through the final permutation with
    one ``index_select``.  Boolean keys sort as uint8 (False first)."""
    perm = None
    for k in reversed(range(num_keys)):
        key = operands[k]
        if key.dtype == torch.bool:
            key = key.to(torch.uint8)
        if perm is not None:
            key = key.index_select(0, perm)
        step = torch.sort(key, stable=True).indices
        perm = step if perm is None else perm.index_select(0, step)
    return [op.index_select(0, perm) for op in operands]


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """A static layout packing ordered integer fields into one int64.

    Fields are listed most-significant first; ``spare`` codes above each
    field's range are available for sentinels (a field with range R gets
    ``2**bits - R - 1`` spare codes that sort after every real value).
    """

    los: Tuple[int, ...]
    bits: Tuple[int, ...]
    shifts: Tuple[int, ...]
    total_bits: int
    # per-field NULL code (hi - lo + 1, one past the real range) for fields
    # declared nullable at fit time; None = field cannot hold NULL.  SQL
    # grouping treats NULL keys as ONE group (reference: VectorHasher reserves
    # value-id 0 for null, velox/exec/VectorHasher.h) — here null sorts last.
    null_codes: Tuple[Optional[int], ...] = ()

    @staticmethod
    def fit(
        bounds: Sequence[Tuple[int, int]],
        extra_bits: int = 0,
        sentinel_fields: Sequence[int] = (),
        null_fields: Sequence[int] = (),
    ) -> Optional["PackPlan"]:
        """Layout for fields with inclusive ``bounds``, high-to-low order.

        ``extra_bits`` reserves low bits (e.g. a payload row-id); fields in
        ``sentinel_fields`` get one extra code above their range for an
        out-of-band marker; fields in ``null_fields`` get a dedicated NULL
        code (hi - lo + 1).  A field in both gets two extra codes, so the
        sentinel (all-ones, used for dead rows) stays strictly above the NULL
        code.  Returns None if > 63 bits total.
        """
        los, bits, null_codes = [], [], []
        for i, (lo, hi) in enumerate(bounds):
            lo, hi = int(lo), max(int(lo), int(hi))
            extra = (1 if i in sentinel_fields else 0) + (
                1 if i in null_fields else 0
            )
            span = hi - lo + extra
            los.append(lo)
            bits.append(max(1, int(span).bit_length()))
            null_codes.append(hi - lo + 1 if i in null_fields else None)
        total = sum(bits) + extra_bits
        if total > 63:
            return None
        shifts = []
        acc = extra_bits
        for b in reversed(bits):
            shifts.append(acc)
            acc += b
        shifts.reverse()
        return PackPlan(
            tuple(los), tuple(bits), tuple(shifts), total, tuple(null_codes)
        )

    def sentinel_code(self, i: int) -> int:
        """The out-of-band code for field i (one past its largest value)."""
        return (1 << self.bits[i]) - 1

    @property
    def low_bits(self) -> int:
        """Width of the payload below the least significant field."""
        return self.shifts[-1] if self.shifts else 0

    def pack(
        self,
        values: Sequence[torch.Tensor],
        validities: Optional[Sequence[Optional[torch.Tensor]]] = None,
    ) -> torch.Tensor:
        """Pack field columns (device tensors) into one int64 tensor.

        ``validities`` (when given) maps NULL rows of nullable fields to the
        field's dedicated NULL code — values already AT the null code (e.g. a
        carry whose group key was extracted from a null group) pack
        identically, so re-packing is stable across merge rounds."""
        out = None
        for i, (v, lo, sh) in enumerate(zip(values, self.los, self.shifts)):
            code = v.to(torch.int64) - lo
            valid = validities[i] if validities is not None else None
            if valid is not None:
                nc = self.null_codes[i]
                assert nc is not None, (
                    f"field {i} holds NULLs but was not fitted as nullable"
                )
                code = torch.where(valid, code, torch.full_like(code, nc))
            term = code << sh
            out = term if out is None else out + term
        assert out is not None
        return out

    def pack_with_sentinel(
        self,
        values: Sequence[torch.Tensor],
        dead: torch.Tensor,
        validities: Optional[Sequence[Optional[torch.Tensor]]] = None,
    ) -> torch.Tensor:
        """Pack, but rows where ``dead`` holds get every field's sentinel code
        (the packed value sorts after all live rows)."""
        packed = self.pack(values, validities)
        sentinel = 0
        for b, sh in zip(self.bits, self.shifts):
            sentinel |= ((1 << b) - 1) << sh
        return torch.where(dead, torch.full_like(packed, sentinel), packed)

    def unpack(self, packed: torch.Tensor, i: int) -> torch.Tensor:
        """Extract field i (as int64, bounds offset restored).  Packed words
        use at most 63 bits, so the arithmetic shift of a non-negative word
        equals the logical one."""
        mask = (1 << self.bits[i]) - 1
        return ((packed >> self.shifts[i]) & mask) + self.los[i]

    def null_value(self, i: int) -> Optional[int]:
        """The unpacked value a NULL in field i lands on (hi + 1); None for
        non-nullable fields.  ``unpack`` of a null group returns this."""
        nc = self.null_codes[i] if i < len(self.null_codes) else None
        return None if nc is None else self.los[i] + nc

    def key_part(self, packed: torch.Tensor) -> torch.Tensor:
        """The packed value with the low ``extra_bits`` payload cleared —
        equal key tuples compare equal on this."""
        return packed >> self.low_bits


def packed_sort_with_index(
    plan: PackPlan,
    values: Sequence[torch.Tensor],
    dead: Optional[torch.Tensor],
    n: int,
    validities: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort rows by (liveness, fields...) carrying the row index in the low
    bits.  Returns (packed_sorted, key_codes_sorted, perm) where ``perm`` is
    the gather permutation (original row index per sorted slot, int64) and
    ``key_codes_sorted`` is the packed key with the index bits stripped.

    ``plan`` must have been fitted with ``extra_bits >= ceil(log2(n))`` and
    every field in ``sentinel_fields`` so dead rows sort last.
    """
    idx = torch.arange(n, dtype=torch.int64, device=values[0].device)
    if dead is None:
        packed = plan.pack(values, validities)
    else:
        packed = plan.pack_with_sentinel(values, dead, validities)
    s = torch.sort(packed | idx, stable=True).values
    low = plan.low_bits
    return s, s >> low, s & ((1 << low) - 1)


def index_bits(n: int) -> int:
    """Bits needed to carry a row index in [0, n)."""
    return max(1, int(n - 1).bit_length()) if n > 1 else 1
