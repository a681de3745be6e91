"""Presto-semantic function package.

Importing this module registers the scalar, time-zone and array / map /
lambda functions into the default registry (reference:
velox/functions/prestosql/registration/), in the JAX package's order.
"""

from . import scalar  # noqa: F401
from . import complex  # noqa: F401,A004
from . import tzfuncs  # noqa: F401

scalar.register_all()
tzfuncs.register_stubs()
