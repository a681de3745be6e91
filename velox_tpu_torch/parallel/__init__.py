"""Distributed execution across the ranks of a ``torch.distributed`` process
group: the row exchange (``exchange``), ranks and collectives
(``distributed``), shuffle joins (``shuffle_join``) and the distributed plan
executor (``runner``).

Counterpart of the JAX package's ``parallel/``; there one process drives a
device mesh, here every rank runs the same code (SPMD) and returns the same
result.  ``testing/world.py`` starts a world of ranks on one host."""
