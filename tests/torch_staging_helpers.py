"""The staging seam of ``velox_tpu_torch/io/table.py`` on the CPU.

A scan to CUDA stages each numeric column in page-locked memory
(``_stages``, ``_page_locked``), and the streaming scan keeps it.  CPU-only
torch has no page-locked memory, so ``plain_staging`` makes scans to the CPU
take that path with plain blocks instead: everything but the upload runs as
on the card.  Each block starts as 0x55 bytes, so a row the staging did not
write shows."""

import numpy as np
import torch

from velox_tpu_torch.io import table as table_mod


def plain_staging(monkeypatch, refuse=lambda shape, np_dtype: False):
    """Install the seam; returns the list of (shape, dtype) of every block
    allocated.  ``refuse(shape, np_dtype)`` True makes that allocation raise,
    as a refused page-locked allocation does."""
    blocks = []

    def block(shape, np_dtype):
        if refuse(shape, np_dtype):
            raise RuntimeError("page-locked memory refused")
        blocks.append((tuple(shape), np.dtype(np_dtype)))
        out = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype)
        out.numpy().view(np.uint8).fill(0x55)
        return out

    monkeypatch.setattr(table_mod, "_stages", lambda device: True)
    monkeypatch.setattr(table_mod, "_page_locked", block)
    return blocks
