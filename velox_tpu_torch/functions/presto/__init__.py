"""Presto-semantic function package.

Importing this module registers the scalar functions into the default registry
(reference: velox/functions/prestosql/registration/).
"""

from . import scalar  # noqa: F401
