"""Logical type system of the PyTorch/CUDA engine.

Counterpart of the JAX package's ``dtypes.py`` (reference: velox/type/Type.h:62
``TypeKind``, velox/type/Type.h:438 ``class Type``).  Every logical type maps to a
*fixed-width device representation*:

* integer / floating kinds map 1:1 to torch dtypes;
* DATE is int32 days since the Unix epoch (reference: velox/type/Type.h:1248);
* TIMESTAMP is int64 microseconds since the epoch (the reference stores seconds+nanos,
  velox/type/Timestamp.h — micros in a single int64 is the device-friendly layout);
* short DECIMAL(p<=18, s) is int64 fixed-point scaled by 10**s
  (reference: velox/type/Type.h:665-744) — exact arithmetic without float64 emulation;
* VARCHAR / VARBINARY have no direct device representation: on device they always
  travel dictionary-encoded (int32 codes into a host-side `StringTable`), mirroring the
  reference's aggressive dictionary encoding of strings in scan
  (velox/dwio/dwrf string-dictionary readers).

Complex kinds (ARRAY/MAP/ROW) are represented columnar-offset-style at the Batch layer.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Optional, Tuple

import numpy as np
import torch


class TypeKind(str, Enum):
    """Mirrors the reference TypeKind enum (velox/type/Type.h:62-84)."""

    BOOLEAN = "BOOLEAN"
    TINYINT = "TINYINT"
    SMALLINT = "SMALLINT"
    INTEGER = "INTEGER"
    BIGINT = "BIGINT"
    HUGEINT = "HUGEINT"
    REAL = "REAL"
    DOUBLE = "DOUBLE"
    VARCHAR = "VARCHAR"
    VARBINARY = "VARBINARY"
    TIMESTAMP = "TIMESTAMP"
    DATE = "DATE"
    DECIMAL = "DECIMAL"
    ARRAY = "ARRAY"
    MAP = "MAP"
    ROW = "ROW"
    UNKNOWN = "UNKNOWN"

    def __repr__(self) -> str:  # pragma: no cover
        return f"TypeKind.{self.name}"


_FIXED_DEVICE_DTYPES = {
    TypeKind.BOOLEAN: torch.bool,
    TypeKind.TINYINT: torch.int8,
    TypeKind.SMALLINT: torch.int16,
    TypeKind.INTEGER: torch.int32,
    TypeKind.BIGINT: torch.int64,
    TypeKind.REAL: torch.float32,
    TypeKind.DOUBLE: torch.float64,
    TypeKind.TIMESTAMP: torch.int64,
    TypeKind.DATE: torch.int32,
    TypeKind.DECIMAL: torch.int64,
    # Strings travel as dictionary codes on device.
    TypeKind.VARCHAR: torch.int32,
    TypeKind.VARBINARY: torch.int32,
    TypeKind.UNKNOWN: torch.bool,
}

NUMPY_OF_TORCH = {
    torch.bool: np.dtype(np.bool_),
    torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16),
    torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64),
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}

_NUMERIC_KINDS = {
    TypeKind.TINYINT,
    TypeKind.SMALLINT,
    TypeKind.INTEGER,
    TypeKind.BIGINT,
    TypeKind.REAL,
    TypeKind.DOUBLE,
    TypeKind.DECIMAL,
}

_INTEGER_KINDS = {
    TypeKind.TINYINT,
    TypeKind.SMALLINT,
    TypeKind.INTEGER,
    TypeKind.BIGINT,
}


@dataclasses.dataclass(frozen=True)
class DataType:
    """An immutable logical type node.

    Unlike the reference's shared-pointer Type tree, these are hashable frozen
    dataclasses, so plans and expressions can key caches on them.
    """

    kind: TypeKind
    # DECIMAL parameters.
    precision: Optional[int] = None
    scale: Optional[int] = None
    # ARRAY element / MAP key+value / ROW children.
    children: Tuple["DataType", ...] = ()
    # ROW field names.
    names: Tuple[str, ...] = ()

    # ---- classification ------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self.kind in _NUMERIC_KINDS

    @property
    def is_integer(self) -> bool:
        return self.kind in _INTEGER_KINDS

    @property
    def is_floating(self) -> bool:
        return self.kind in (TypeKind.REAL, TypeKind.DOUBLE)

    @property
    def is_string(self) -> bool:
        return self.kind in (TypeKind.VARCHAR, TypeKind.VARBINARY)

    @property
    def is_complex(self) -> bool:
        return self.kind in (TypeKind.ARRAY, TypeKind.MAP, TypeKind.ROW)

    @property
    def is_long_decimal(self) -> bool:
        """DECIMAL backed by 128-bit storage (reference: Type.h:665 HUGEINT
        backing DecimalType<p> for p > 18).  Device representation: TWO int64
        limb columns (lo unsigned, hi signed); not executed by this package yet."""
        return (
            self.kind == TypeKind.DECIMAL
            and self.precision is not None
            and self.precision > 18
        )

    @property
    def is_orderable(self) -> bool:
        return not self.is_complex and self.kind != TypeKind.UNKNOWN

    # ---- device mapping -------------------------------------------------
    @property
    def device_dtype(self):
        """The torch dtype of this type's device column."""
        if self.kind in _FIXED_DEVICE_DTYPES:
            return _FIXED_DEVICE_DTYPES[self.kind]
        raise TypeError(f"{self.kind} has no single device dtype")

    @property
    def numpy_dtype(self) -> np.dtype:
        """The host (numpy) dtype matching ``device_dtype``."""
        return NUMPY_OF_TORCH[self.device_dtype]

    # ---- structure ------------------------------------------------------
    @property
    def element(self) -> "DataType":
        assert self.kind == TypeKind.ARRAY
        return self.children[0]

    @property
    def key_type(self) -> "DataType":
        assert self.kind == TypeKind.MAP
        return self.children[0]

    @property
    def value_type(self) -> "DataType":
        assert self.kind == TypeKind.MAP
        return self.children[1]

    def child(self, name: str) -> "DataType":
        assert self.kind == TypeKind.ROW
        return self.children[self.names.index(name)]

    def equivalent(self, other: "DataType") -> bool:
        """Type equality ignoring ROW field names (reference Type::equivalent)."""
        if self.kind != other.kind:
            return False
        if self.kind == TypeKind.DECIMAL and (
            self.precision != other.precision or self.scale != other.scale
        ):
            return False
        if len(self.children) != len(other.children):
            return False
        return all(a.equivalent(b) for a, b in zip(self.children, other.children))

    # ---- serde ----------------------------------------------------------
    def to_json(self) -> Any:
        out: dict = {"kind": self.kind.value}
        if self.kind == TypeKind.DECIMAL:
            out["precision"] = self.precision
            out["scale"] = self.scale
        if self.children:
            out["children"] = [c.to_json() for c in self.children]
        if self.names:
            out["names"] = list(self.names)
        return out

    @staticmethod
    def from_json(obj: Any) -> "DataType":
        kind = TypeKind(obj["kind"])
        return DataType(
            kind=kind,
            precision=obj.get("precision"),
            scale=obj.get("scale"),
            children=tuple(DataType.from_json(c) for c in obj.get("children", ())),
            names=tuple(obj.get("names", ())),
        )

    def __str__(self) -> str:
        if self.kind == TypeKind.DECIMAL:
            return f"DECIMAL({self.precision},{self.scale})"
        if self.kind == TypeKind.ARRAY:
            return f"ARRAY<{self.element}>"
        if self.kind == TypeKind.MAP:
            return f"MAP<{self.key_type},{self.value_type}>"
        if self.kind == TypeKind.ROW:
            inner = ",".join(f"{n}:{c}" for n, c in zip(self.names, self.children))
            return f"ROW<{inner}>"
        return self.kind.value


# ---- singletons / constructors ------------------------------------------

BOOLEAN = DataType(TypeKind.BOOLEAN)
TINYINT = DataType(TypeKind.TINYINT)
SMALLINT = DataType(TypeKind.SMALLINT)
INTEGER = DataType(TypeKind.INTEGER)
BIGINT = DataType(TypeKind.BIGINT)
REAL = DataType(TypeKind.REAL)
DOUBLE = DataType(TypeKind.DOUBLE)
VARCHAR = DataType(TypeKind.VARCHAR)
VARBINARY = DataType(TypeKind.VARBINARY)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)
DATE = DataType(TypeKind.DATE)
UNKNOWN = DataType(TypeKind.UNKNOWN)


def decimal(precision: int, scale: int) -> DataType:
    """DECIMAL(p, s): int64 fixed-point for p <= 18; two int64 limbs
    (hugeint, reference Type.h:665) for 18 < p <= 38."""
    if not (0 < precision <= 38):
        raise ValueError(f"bad decimal precision {precision} (max 38)")
    if not (0 <= scale <= precision):
        raise ValueError(f"bad decimal scale {scale} for precision {precision}")
    return DataType(TypeKind.DECIMAL, precision=precision, scale=scale)


def array(element: DataType) -> DataType:
    return DataType(TypeKind.ARRAY, children=(element,))


def map_(key: DataType, value: DataType) -> DataType:
    return DataType(TypeKind.MAP, children=(key, value))


def row(names, types) -> DataType:
    names = tuple(names)
    types = tuple(types)
    assert len(names) == len(types)
    return DataType(TypeKind.ROW, children=types, names=names)


class RowType:
    """Convenience wrapper for a ROW DataType used as a relation schema."""

    def __init__(self, names, types):
        self.dtype = row(names, types)

    @property
    def names(self) -> Tuple[str, ...]:
        return self.dtype.names

    @property
    def types(self) -> Tuple[DataType, ...]:
        return self.dtype.children

    def __len__(self) -> int:
        return len(self.dtype.names)

    def index_of(self, name: str) -> int:
        return self.dtype.names.index(name)

    def type_of(self, name: str) -> DataType:
        return self.dtype.child(name)

    def __contains__(self, name: str) -> bool:
        return name in self.dtype.names

    def __eq__(self, other) -> bool:
        return isinstance(other, RowType) and self.dtype == other.dtype

    def __hash__(self) -> int:
        return hash(self.dtype)

    def __repr__(self) -> str:
        return str(self.dtype)


# Widening order used by binary-op type resolution (smallest common super type).
_WIDEN_ORDER = [
    TypeKind.TINYINT,
    TypeKind.SMALLINT,
    TypeKind.INTEGER,
    TypeKind.BIGINT,
    TypeKind.REAL,
    TypeKind.DOUBLE,
]


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Smallest common numeric super-type, Presto-style."""
    if a == b:
        return a
    if a.kind == TypeKind.DECIMAL or b.kind == TypeKind.DECIMAL:
        if a.kind == b.kind == TypeKind.DECIMAL:
            scale = max(a.scale, b.scale)
            ip = max(a.precision - a.scale, b.precision - b.scale)
            # long-decimal operands keep 128-bit width
            cap = 38 if (a.is_long_decimal or b.is_long_decimal) else 18
            return decimal(min(cap, ip + scale), scale)
        other = b if a.kind == TypeKind.DECIMAL else a
        if other.is_integer:
            return a if a.kind == TypeKind.DECIMAL else b
        return DOUBLE
    if not a.is_numeric or not b.is_numeric:
        raise TypeError(f"no common numeric type for {a} and {b}")
    return DataType(_WIDEN_ORDER[max(_WIDEN_ORDER.index(a.kind), _WIDEN_ORDER.index(b.kind))])
