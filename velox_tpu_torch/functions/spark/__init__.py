"""Spark-semantic function package.

Importing registers the Spark-specific scalar functions into the default
registry (reference: velox/functions/sparksql/Register.cpp), in the JAX
package's order.  Functions whose semantics match the Presto package (abs,
length, concat, ...) are shared, as the reference reuses lib/
implementations across packages.
"""

from . import scalar  # noqa: F401

scalar.register_all()
