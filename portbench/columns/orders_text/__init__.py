"""TPC-H orders with their free text ``o_comment``: 1 500 000 x SF rows.  A
table of its own so that the other cells' ``orders`` stay as they are; its
``o_custkey`` is the ``orders`` column, drawn from the same stream."""
