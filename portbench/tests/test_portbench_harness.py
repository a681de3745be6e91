"""Short runs of the harness on the CPU: the result line's shape, the
refusal without a card, and the check refusing the control and each fault
a cell can have (a query that returns its first answer again, half of the
tiles left out, an answer altered where it is produced, a DOUBLE answer
that is NaN)."""

import json
import os
import subprocess
import sys
import types

import pytest
from portbench_testing import CELLS, SF, TILE_ROWS

from portbench import compare, harness
from portbench.control import control_readings

ROOT = harness.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def seconds(cell, trace=0):
    """A window that holds a few queries on a busy CPU (Q12 takes up to 1.6 s
    there), and with ``trace`` the profiler's warm-up queries and some to
    record."""
    slow = "q12" in cell
    return (10 if slow else 4) if trace else (5 if slow else 1.5)


def rehearse(cell, seed, seconds, trace=0):
    done = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "rehearse.py"), "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
         "--scale-factor", str(SF), "--tile-rows", str(TILE_ROWS)],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
    )
    assert done.returncode == 0, done.stderr[-3000:]
    return done


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["sf1-q1-q6", "sf10-q3-q12"])
def test_last_line(cell, trace):
    done = rehearse(cell, 2**31 + 9, seconds(cell, trace), trace)
    line = json.loads(done.stdout.strip().splitlines()[-1])
    extra = ["breakdown"] if "breakdown" in line else []
    assert list(line) == KEYS + extra + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    wanted = {m["name"] for m in harness.benchmark()["per_layer" if trace else "end_to_end"]
              if cell in m.get("workloads", [cell])}
    device_only = {"device_peak_gib", "device_idle_share", "k2_roofline_share"}
    assert set(line["metrics"]) == wanted - device_only
    checks = done.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [c.split()[1] for c in checks] == list(line["checks"])


def test_no_card_no_result():
    done = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert done.returncode != 0 and done.stdout.strip() == ""


def run_with(monkeypatch, cell, fault):
    from velox_tpu_torch.exec.runner import LocalExecutor

    original = LocalExecutor.run
    monkeypatch.setattr(LocalExecutor, "run", lambda self, prefetched_tiles=None, stats=None:
                        fault(original, self, prefetched_tiles))
    return harness.run_cell(cell, 77, seconds(cell), False, device="cpu", scale_factor=SF,
                            tile_rows=TILE_ROWS)


def first_answer_again():
    first = {}

    def fault(original, ex, tiles):
        if id(tiles) not in first:
            first[id(tiles)] = original(ex, prefetched_tiles=tiles)
        return first[id(tiles)]

    return fault


def half_the_tiles(original, ex, tiles):
    return original(ex, prefetched_tiles=tiles[: len(tiles) // 2])


def altered_answer(original, ex, tiles):
    result = original(ex, prefetched_tiles=tiles)
    name = next(n for n, t in zip(result.schema.names, result.schema.types)
                if not t.is_string and len(result.columns[n]))
    changed = result.columns[name].copy()
    changed[-1] += 1
    result.columns[name] = changed
    return result


def nan_average(original, ex, tiles):
    result = original(ex, prefetched_tiles=tiles)
    for name, dtype in zip(result.schema.names, result.schema.types):
        if dtype.is_floating and len(result.columns[name]):
            changed = result.columns[name].copy()
            changed[0] = float("nan")
            result.columns[name] = changed
            break
    return result


@pytest.mark.parametrize("cell,fault", [
    (cell, fault)
    for cell in ("sf1-q1-q6", "sf1-q3-q12")
    for fault in ("first_answer_again", "half_the_tiles", "altered_answer")
] + [("sf1-q1-q6", "nan_average")])
def test_faults_are_refused(monkeypatch, cell, fault):
    make = {"first_answer_again": first_answer_again(), "half_the_tiles": half_the_tiles,
            "altered_answer": altered_answer, "nan_average": nan_average}[fault]
    out = run_with(monkeypatch, cell, make)
    assert out["attempted"] > 2
    assert out["correct"] is False, out["checks"]


def test_nan_never_passes_the_comparison():
    nan = float("nan")
    want = [("avg_qty", "double", 0, [25.5, 26.0])]
    assert compare.compare([("avg_qty", "double", 0, [nan, 26.0])], want) == (1, 0.0)
    assert compare.compare(want, [("avg_qty", "double", 0, [nan, 26.0])]) == (1, 0.0)
    assert compare.compare([("avg_qty", "double", 0, [float("inf"), 26.0])], want)[0] == 1


def test_the_k2_recorder_finds_every_holder(monkeypatch):
    from velox_tpu_torch.ops import group_piece

    original = group_piece.grouped_piece_sums
    holder = types.ModuleType("portbench_test_k2_holder")
    holder.grouped_piece_sums = original  # as a module-level import would hold it
    monkeypatch.setitem(sys.modules, holder.__name__, holder)
    recorder = harness.K2Recorder()
    recorder.install()
    try:
        assert holder.grouped_piece_sums is not original
        assert group_piece.grouped_piece_sums is holder.grouped_piece_sums
    finally:
        recorder.remove()
    assert holder.grouped_piece_sums is original and group_piece.grouped_piece_sums is original


@pytest.mark.parametrize("cell", ["sf1-q1-q6", "sf1-q3-q12"])
def test_sound_run_is_correct(cell):
    out = harness.run_cell(cell, 78, seconds(cell), False, device="cpu", scale_factor=SF,
                           tile_rows=TILE_ROWS)
    assert out["correct"] is True and out["attempted"] > 2, out["checks"]


@pytest.mark.parametrize("cell", ["sf1-q1-q6", "sf1-q3-q12"])
def test_control_is_refused(cell):
    readings = control_readings(harness.Cell(cell, scale_factor=SF), 31, 60, "cpu")
    assert any(c["value"] > c["limit"] for c in readings["checks"].values()), readings
