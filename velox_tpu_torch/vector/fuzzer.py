"""Random vector/batch generation for fuzz testing.

Counterpart of the JAX package's ``vector/fuzzer.py``.  Reference:
velox/vector/fuzzer/VectorFuzzer.h:81 — random vectors of any type with
nested encodings; the backbone of the reference's nightly fuzzers
(velox/docs/develop/testing/fuzzer.rst).

Generates Columns in any of the five encodings with controllable null ratio,
plus whole Batches over random or given schemas.  Deterministic per seed: the
draws come from ``np.random.default_rng(seed)`` in the JAX package's order,
so one seed gives the same vectors in both packages.  The tensors are placed
on ``device`` (None = the CUDA device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import (
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    REAL,
    RowType,
    SMALLINT,
    TINYINT,
    DataType,
    TypeKind,
    VARCHAR,
    decimal,
)
from .column import Batch, Column
from .string_table import StringTable

SCALAR_TYPES = [
    BOOLEAN,
    TINYINT,
    SMALLINT,
    INTEGER,
    BIGINT,
    REAL,
    DOUBLE,
    DATE,
    VARCHAR,
    decimal(12, 2),
    decimal(9, 4),
]

_WORDS = (
    "apple banana cherry dog elephant fox grape hotel igloo jungle kiwi lemon "
    "mango night ocean piano queen river stone tiger umbrella violet whale xylophone "
    "yellow zebra"
).split()


@dataclasses.dataclass
class FuzzerOptions:
    null_ratio: float = 0.1
    dictionary_ratio: float = 0.3  # chance a column is dictionary-encoded
    constant_ratio: float = 0.1
    sequence_ratio: float = 0.0  # chance a column is run-length encoded
    bias_ratio: float = 0.0  # chance an int64 column is bias-encoded
    string_pool_size: int = 24


class VectorFuzzer:
    def __init__(self, seed: int = 0, options: Optional[FuzzerOptions] = None, device=None):
        self.rng = np.random.default_rng(seed)
        self.opts = options or FuzzerOptions()
        self.device = resolve_device(device)

    def _tensor(self, arr, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=self.device)

    def _flat(self, values, dtype: DataType, validity, table) -> Column:
        return Column.flat(
            self._tensor(np.asarray(values).astype(dtype.numpy_dtype, copy=False)),
            dtype,
            None if validity is None else self._tensor(validity),
            table,
        )

    # ---- values ----------------------------------------------------------
    def _values(self, dtype: DataType, n: int):
        r = self.rng
        k = dtype.kind
        if k == TypeKind.BOOLEAN:
            return r.integers(0, 2, n).astype(bool), None
        if k in (TypeKind.TINYINT, TypeKind.SMALLINT, TypeKind.INTEGER, TypeKind.BIGINT):
            info = {
                TypeKind.TINYINT: (-128, 127),
                TypeKind.SMALLINT: (-(2**15), 2**15 - 1),
                TypeKind.INTEGER: (-(2**31), 2**31 - 1),
                TypeKind.BIGINT: (-(2**40), 2**40),
            }[k]
            return r.integers(info[0], info[1], n, dtype=np.int64), None
        if k == TypeKind.REAL:
            return (r.standard_normal(n) * 100).astype(np.float32), None
        if k == TypeKind.DOUBLE:
            return r.standard_normal(n) * 1e4, None
        if k == TypeKind.DATE:
            return r.integers(0, 20000, n).astype(np.int32), None
        if k == TypeKind.TIMESTAMP:
            return r.integers(0, 2**41, n), None
        if k == TypeKind.DECIMAL:
            hi = 10 ** min(dtype.precision, 15)
            return r.integers(-hi, hi, n), None
        if k in (TypeKind.VARCHAR, TypeKind.VARBINARY):
            pool = list(r.choice(_WORDS, self.opts.string_pool_size))
            table = StringTable(pool)
            codes = r.integers(1, len(table), n).astype(np.int32)
            return codes, table
        raise TypeError(f"fuzzer cannot generate {dtype}")

    def _validity(self, n: int) -> Optional[np.ndarray]:
        if self.opts.null_ratio <= 0:
            return None
        v = self.rng.random(n) >= self.opts.null_ratio
        return v if not v.all() else None

    # ---- columns ---------------------------------------------------------
    def column(self, dtype: DataType, capacity: int) -> Column:
        roll = self.rng.random()
        if roll < self.opts.constant_ratio:
            values, table = self._values(dtype, 1)
            is_null = self.rng.random() < self.opts.null_ratio
            return Column.constant(
                values[0], dtype, is_null=is_null, strings=table, device=self.device
            )
        if roll < self.opts.constant_ratio + self.opts.dictionary_ratio:
            base_n = max(1, capacity // 2)
            values, table = self._values(dtype, base_n)
            base = self._flat(values, dtype, self._validity(base_n), table)
            idx = self.rng.integers(0, base_n, capacity).astype(np.int32)
            validity = self._validity(capacity)
            return Column.dictionary(
                self._tensor(idx),
                base,
                None if validity is None else self._tensor(validity),
            )
        roll -= self.opts.constant_ratio + self.opts.dictionary_ratio
        if roll < self.opts.sequence_ratio:
            # run-length: lengths summing to capacity
            n_runs = int(self.rng.integers(1, max(2, capacity // 4)))
            if n_runs > 1:
                cuts = np.sort(self.rng.choice(capacity - 1, n_runs - 1, replace=False)) + 1
            else:
                cuts = np.array([], dtype=np.int64)
            bounds = np.concatenate([[0], cuts, [capacity]])
            lengths = np.diff(bounds).astype(np.int32)
            values, table = self._values(dtype, n_runs)
            base = self._flat(values, dtype, self._validity(n_runs), table)
            return Column.sequence(base, self._tensor(lengths), capacity)
        roll -= self.opts.sequence_ratio
        wide = dtype.numpy_dtype
        if (
            roll < self.opts.bias_ratio
            and wide.kind == "i"
            and wide.itemsize == 8
            and not dtype.is_string
        ):
            bias = int(self.rng.integers(-(1 << 40), 1 << 40))
            deltas = self.rng.integers(-128, 128, capacity).astype(np.int8)
            validity = self._validity(capacity)
            return Column.bias(
                bias,
                self._tensor(deltas),
                dtype,
                None if validity is None else self._tensor(validity),
            )
        values, table = self._values(dtype, capacity)
        return self._flat(values, dtype, self._validity(capacity), table)

    def flat_copy(self, col: Column, capacity: int) -> Column:
        """The same logical column, flattened — for encoding-equivalence checks."""
        values, validity = col.decode(capacity)
        return Column.flat(values, col.dtype, validity, col.strings)

    # ---- batches ---------------------------------------------------------
    def schema(self, num_cols: int) -> RowType:
        types = [
            SCALAR_TYPES[self.rng.integers(0, len(SCALAR_TYPES))]
            for _ in range(num_cols)
        ]
        return RowType([f"c{i}" for i in range(num_cols)], types)

    def batch(self, schema: RowType, capacity: int, length: Optional[int] = None) -> Batch:
        cols = [self.column(t, capacity) for t in schema.types]
        n = length if length is not None else int(self.rng.integers(1, capacity + 1))
        return Batch.make(schema, cols, n, capacity=capacity, device=self.device)
