"""orders_text.o_custkey: the ``orders.o_custkey`` column, from the same
stream, so the two tables hold the same customers."""

from ..orders.o_custkey import CATEGORIES, TYPE, make  # noqa: F401
