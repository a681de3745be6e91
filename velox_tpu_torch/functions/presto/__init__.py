"""Presto-semantic function package.

Importing this module registers the scalar and time-zone functions into the
default registry (reference: velox/functions/prestosql/registration/).  The
array / map / lambda functions (``complex``) and the Spark package come with
later slices.
"""

from . import scalar  # noqa: F401
from . import tzfuncs  # noqa: F401

scalar.register_all()
tzfuncs.register_stubs()
