"""TPC-H orders: 1 500 000 x SF rows."""
