"""Mask -> dense compaction (the device form of filter result materialization).

Counterpart of the JAX package's ``ops/compact.py``.  Reference: the reference
produces dictionary-wrapped vectors after filters
(velox/exec/FilterProject.cpp); here filters narrow a boolean selection mask
and this module produces the dense permutation when an operator boundary needs
density (join build, collect output).

A stable dense gather: indices of selected rows first (in order), padding rows
after.  It is a stable argsort of the inverted mask, so the result keeps the
tile's static capacity and the live count stays on the device.  The
split-dispatch halves of the reference (``compaction_word``,
``compact_from_sorted_word``) exist for its compiler and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..vector.column import Batch


def compaction_indices(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (perm, count): perm (int64) is a stable permutation putting
    selected rows first; count (0-d int32) is the number selected."""
    # stable argsort of ~mask: 0 (selected) sorts before 1, order kept
    perm = torch.argsort((~mask).to(torch.uint8), stable=True)
    return perm, mask.sum().to(torch.int32)


def compact(batch: Batch) -> Batch:
    """Densify a batch: live rows first, selection cleared, length=num_active."""
    mask = batch.active_mask()
    perm, count = compaction_indices(mask)
    cols = tuple(c.gather(perm).flatten(batch.capacity) for c in batch.columns)
    return dataclasses.replace(batch, columns=cols, length=count, selection=None)
