"""Q3's reference."""

from portbench.reference.q3 import answer  # noqa: F401
