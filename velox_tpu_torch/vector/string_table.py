"""Host-side string dictionaries backing device VARCHAR columns.

The reference stores strings in columnar memory as 16-byte StringViews
(velox/type/StringView.h:46) with out-of-line bodies.  Variable-width data is hostile
to a vector machine, so the engine commits to what the reference's scan layer
already prefers for low-cardinality strings (dwrf string-dictionary readers): on
device, a VARCHAR column is **always** an int32 code vector; the code→bytes mapping
lives here, on the host, and is only consulted at ingest (literal → code) and egress
(codes → strings).  High-cardinality strings keep a per-column table built at ingest.

``byte_matrix`` gives a padded uint8 form for device-side string compute that
cannot be expressed over codes; ``byte_arrays`` gives every entry's UTF-8
bytes end to end with their offsets, made once a table, which
``ops/dict_like.py`` reads to match LIKE patterns against every entry.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class StringTable:
    """An append-only, deduplicating mapping code <-> python bytes/str.

    Hashable by identity so it can ride along as static metadata of columns and
    expressions.  Code 0 is reserved for the canonical empty string so that
    zero-initialized device buffers decode to '' rather than garbage.
    """

    __slots__ = ("_values", "_index", "frozen", "_arrays")

    def __init__(self, values: Optional[Iterable[str]] = None):
        self._values: List[str] = [""]
        self._index: Dict[str, int] = {"": 0}
        self.frozen = False
        self._arrays: Dict[str, tuple] = {}
        if values is not None:
            for v in values:
                self.intern(v)

    def __len__(self) -> int:
        return len(self._values)

    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other) -> bool:
        return self is other

    @classmethod
    def from_values(cls, values: Sequence[str]) -> "StringTable":
        """Adopt a pre-deduplicated value list; values[0] must be ''."""
        st = cls()
        vals = list(values)
        assert vals and vals[0] == ""
        st._values = vals
        st._index = {v: i for i, v in enumerate(vals)}
        return st

    def intern(self, value: str) -> int:
        code = self._index.get(value)
        if code is None:
            if self.frozen:
                raise KeyError(f"string table frozen; {value!r} not present")
            code = len(self._values)
            self._values.append(value)
            self._index[value] = code
        return code

    def lookup(self, value: str) -> Optional[int]:
        """Code for value, or None if absent (useful for filter rewriting)."""
        return self._index.get(value)

    def intern_all(self, values: Sequence[str]) -> np.ndarray:
        if self.frozen:
            return np.asarray([self.intern(v) for v in values], dtype=np.int32)
        # ``intern`` in bulk: a new value's code is the count of values before it
        index = self._index
        first_new = len(index)
        codes = np.fromiter(
            (index.setdefault(v, len(index)) for v in values), dtype=np.int32, count=len(values)
        )
        self._values.extend(itertools.islice(index, first_new, None))
        return codes

    def value(self, code: int) -> str:
        return self._values[code]

    def values(self) -> List[str]:
        return list(self._values)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """codes (any int dtype) → numpy object array of str."""
        arr = np.asarray(self._values, dtype=object)
        return arr[np.asarray(codes, dtype=np.int64)]

    def sort_permutation(self) -> np.ndarray:
        """perm such that perm[code] = rank of the string in lexicographic order.

        Lets ORDER BY on a dictionary column run entirely on device: map codes
        through this int32 array and sort the ranks.
        """
        order = np.argsort(np.asarray(self._values, dtype=object), kind="stable")
        ranks = np.empty(len(self._values), dtype=np.int32)
        ranks[order] = np.arange(len(self._values), dtype=np.int32)
        return ranks

    def byte_arrays(self, device=None):
        """(uint8 bytes of every entry end to end, their offsets) on ``device``
        (the CPU by default).  Offsets are int32 while the bytes stay under
        2**31, else int64.  Made once a table and device, and kept there
        (again only if the table has grown since): on a card they stay
        resident for every later query."""
        import torch

        device = torch.device("cpu" if device is None else device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        hit = self._arrays.get(key)
        if hit is not None and hit[0] == len(self._values):
            return hit[1], hit[2]
        if device.type != "cpu":
            data, offsets = self.byte_arrays()
            out = (len(self._values), data.to(device), offsets.to(device))
            self._arrays[key] = out
            return out[1], out[2]
        values = self._values
        joined = "".join(values)
        data = joined.encode("utf-8", "surrogatepass")
        if len(data) == len(joined):  # ASCII: a character is a byte
            lengths = np.fromiter(map(len, values), dtype=np.int64, count=len(values))
        else:
            lengths = np.fromiter(
                (len(v.encode("utf-8", "surrogatepass")) for v in values),
                dtype=np.int64, count=len(values),
            )
        offsets = np.zeros(len(values) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        if offsets[-1] < 2**31:
            offsets = offsets.astype(np.int32)
        out = (len(values), torch.from_numpy(np.frombuffer(bytearray(data), dtype=np.uint8)),
               torch.from_numpy(offsets))
        self._arrays[key] = out
        return out[1], out[2]

    def byte_matrix(self, max_len: Optional[int] = None) -> np.ndarray:
        """Padded uint8 matrix [num_strings, max_len] of UTF-8 bytes (0-padded)."""
        encoded = [v.encode("utf-8") for v in self._values]
        width = max_len if max_len is not None else max((len(b) for b in encoded), default=1)
        width = max(width, 1)
        out = np.zeros((len(encoded), width), dtype=np.uint8)
        for i, b in enumerate(encoded):
            trunc = b[:width]
            out[i, : len(trunc)] = np.frombuffer(trunc, dtype=np.uint8)
        return out
