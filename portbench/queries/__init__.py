"""One module a TPC-H query kind: its plan with parameters (``build``) and
the columns it reads by table (``TABLES``).  The table its last pipeline
scans is uploaded once as resident tiles; the others are scanned from host
tables while each executor is constructed.  Its reference is
``portbench/reference/<same name>.py``."""
