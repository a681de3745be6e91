from .column import Batch, Column, Encoding
from .string_table import StringTable

__all__ = ["Batch", "Column", "Encoding", "StringTable"]
