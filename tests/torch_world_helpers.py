"""Shared by the port's distributed tests (tests/test_torch_distributed*.py):
a world of 4 gloo ranks on the CPU, one a test process, and the comparison
of a case run by the port's ranks with the same case run by the JAX
package's DistributedExecutor on 4 of the conftest's virtual devices."""

import atexit

import pytest

import velox_tpu
from velox_tpu.parallel.runner import DistributedExecutor as RefExecutor
from velox_tpu.parallel.runner import make_mesh as ref_make_mesh
from velox_tpu_torch.testing import assert_same_rows
from velox_tpu_torch.testing.dist_tasks import CASES, api, report
from velox_tpu_torch.testing.world import World

RANKS = 4
# seconds one task may take before its world is killed and the test fails
TASK_TIMEOUT_S = 120.0
RUN_CASE = "velox_tpu_torch.testing.dist_tasks:run_case"
RUN_TPCH = "velox_tpu_torch.testing.dist_tasks:run_tpch"


_WORLD = []


def _shared_world() -> World:
    """This test process's world, started once and closed at its exit.
    Starting a world costs each of its 4 ranks an import of torch (about
    4 s of CPU each here); one world a file made the whole tier-1 run
    about 300 s longer on 8 cores, one a process does not (a failed or hung
    call kills the world, and the next call starts a new one)."""
    if not _WORLD:
        w = World(RANKS, "gloo", "cpu", threads=1, task_timeout_s=TASK_TIMEOUT_S)
        w.launch()  # the ranks start while the first test computes its JAX rows
        atexit.register(w.close)
        _WORLD.append(w)
    return _WORLD[0]


def world_fixture():
    """A module fixture: the test process's world (``_shared_world``)."""

    @pytest.fixture(scope="module")
    def world():
        return _shared_world()

    return world


def ref_mesh():
    return ref_make_mesh(RANKS)


def check_case(world, name: str):
    """Run case ``name`` through both packages: the same rows in the same
    order (integers, dates and strings exactly, DOUBLE to rtol 1e-9), and the
    same shuffle-join buckets, output capacities and carry slots before and
    after the run.  Returns (port's task result, JAX executor)."""
    plan, per_dev, config = CASES[name](api(velox_tpu))
    kwargs = {} if per_dev is None else {"per_device_rows": per_dev}
    task = world.submit(RUN_CASE, name)  # the ranks run while JAX computes
    ref = RefExecutor(plan, ref_mesh(), config=config, **kwargs)
    before = report(ref)
    want = ref.run()
    got = task.result()
    assert_same_rows(got["result"], want)
    assert got["before"] == before
    assert got["after"] == report(ref)
    return got, ref


def check_tpch(world, num: int, per_device_rows: int = 1 << 11):
    """TPC-H plan ``num`` at SF 0.01: the port's distributed rows (the
    port's tables, shared with the ranks as files) against the JAX
    package's LocalExecutor rows on its own tables, in order."""
    from velox_tpu.connectors.tpch import plans as ref_plans
    from velox_tpu.exec.runner import LocalExecutor as RefLocal
    from velox_tpu_torch.connectors.tpch import plans

    sf = 0.01
    handle = world.share_tables(plans.load_query_tables(num, sf))
    task = world.submit(RUN_TPCH, num, handle, per_device_rows)
    want = RefLocal(ref_plans.build_query(num, ref_plans.load_query_tables(num, sf)),
                    tile_rows=1 << 13).run()
    got = task.result()
    assert_same_rows(got["result"], want)
    return got
