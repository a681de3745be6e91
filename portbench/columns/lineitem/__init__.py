"""TPC-H lineitem: 1 to 7 lines an order."""
