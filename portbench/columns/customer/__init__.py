"""TPC-H customer: 150 000 x SF rows."""
