"""Serializers: columnar page + row formats with a named registry.

Counterpart of the JAX package's ``serde/``: the same bytes for the same
table, so either package decodes the other's pages and rows.  Reference: velox/vector/VectorStream.h:63 (VectorSerde registry: PrestoPage /
UnsafeRow / CompactRow).
"""

from .page import deserialize_page, serialize_page
from .rows import (
    decode_compactrow,
    decode_unsaferow,
    deserialize_unsaferow_stream,
    encode_compactrow,
    encode_unsaferow,
    serialize_unsaferow_stream,
)

SERDES = {
    "page": (serialize_page, deserialize_page),
    "unsaferow": (encode_unsaferow, decode_unsaferow),
    "compactrow": (encode_compactrow, decode_compactrow),
}

__all__ = [
    "SERDES",
    "serialize_page",
    "deserialize_page",
    "encode_unsaferow",
    "decode_unsaferow",
    "encode_compactrow",
    "decode_compactrow",
    "serialize_unsaferow_stream",
    "deserialize_unsaferow_stream",
]
