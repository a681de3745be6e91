"""Substrait interchange: PlanNode tree <-> Substrait plan messages.

Counterpart of the JAX package's ``substrait`` package.  Reference:
velox/substrait/SubstraitToVeloxPlan.h:31 and VeloxToSubstraitPlan.h
(bidirectional converters used by Gluten).  The reference converts protobuf
messages; this package speaks the **protobuf JSON mapping** of the same
Substrait messages (camelCase fields, anchors / extension-function
declarations, emit mappings), so plans serialize to plain JSON that any
Substrait implementation's JSON codec can consume.

Scope: ReadRel(namedTable) / FilterRel / ProjectRel(emit) / AggregateRel /
JoinRel / SortRel / FetchRel; expressions: field selections, literals,
scalarFunction with extension anchors, cast, ifThen, singularOrList.
"""

from .convert import from_substrait, to_substrait  # noqa: F401
