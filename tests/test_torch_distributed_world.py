"""The world of ranks the distributed tests and ``chip_smoke.py`` share
(``velox_tpu_torch/testing/world.py``): no rank imports JAX, a rank that
fails fails the call with its traceback, a collective that hangs fails the
call within the call's timeout (long before the group's own 60 s, and the
tier-1 run's limit), and the next call starts a new world.
"""

import time

import pytest

from torch_world_helpers import world_fixture
from velox_tpu_torch.testing.world import WorldError

world = world_fixture()
TASKS = "velox_tpu_torch.testing.dist_tasks"


def test_ranks_import_no_jax(world):
    assert world.run(f"{TASKS}:loaded_modules_task") == []


def test_failed_rank_fails_the_call_and_the_world_restarts(world):
    with pytest.raises(WorldError, match="rank 1 fails on purpose"):
        world.run(f"{TASKS}:fail_task")
    assert world.run(f"{TASKS}:loaded_modules_task") == []


def test_hung_collective_fails_within_its_timeout(world):
    """Rank 0 waits in an all-reduce nobody joins: the call raises after its
    timeout (the world is killed), long before the group's own 60 s."""
    t0 = time.monotonic()
    with pytest.raises(WorldError, match="did not answer"):
        world.run(f"{TASKS}:hang_task", timeout=3)
    assert time.monotonic() - t0 < 30
    assert world.run(f"{TASKS}:loaded_modules_task") == []
