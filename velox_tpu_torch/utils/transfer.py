"""Device->host transfer discipline.

Counterpart of the JAX package's ``utils/transfer.py``.  Every host read of the
engine goes through here, so that a result is fetched once, at the end, and
result-sized: nothing is read back per tile on the aggregation paths (a
device->host copy synchronises the stream).
"""

from __future__ import annotations

import torch

from .trace import span, spanned


def fetch_tree(tree):
    """Fetch every tensor in a nested tuple/list/dict as a numpy array; other
    leaves pass through.  The first copy waits for the stream; the rest are
    already complete."""
    with span("fetch"):
        return _fetch(tree)


def _fetch(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple):
        return tuple(_fetch(t) for t in tree)
    if isinstance(tree, list):
        return [_fetch(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _fetch(v) for k, v in tree.items()}
    return tree


def bucket_of(n: int) -> int:
    """The next power of two >= n (result-prefix buckets)."""
    b = 1
    while b < n:
        b <<= 1
    return b


@spanned("fetch")
def fetch_prefix(arrays, n: int):
    """Fetch the first ``n`` rows of same-length device tensors as numpy
    arrays: the slice is cut on the device, so the bytes copied scale with
    the result and not with the static tile capacity.  (The JAX package cuts
    to a power-of-two bucket first so that its compiled slicers are few; an
    eager slice needs no bucket.)"""
    n = max(int(n), 0)
    return [_fetch(a[:n]) for a in arrays]
