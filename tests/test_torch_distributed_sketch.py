"""A sketch distributed on 4 gloo ranks on the CPU, against the JAX
package's DistributedExecutor on 4 of the conftest's virtual devices: the
distributed case of test_sketch.py, the same rows in the same order.
"""

from torch_world_helpers import check_case, world_fixture

world = world_fixture()


def test_distributed_sketch_matches_reference(world):
    """approx_distinct: the sketch rewrite's barrier aggregation runs
    distributed, its registers merged exactly."""
    check_case(world, "sketch")
