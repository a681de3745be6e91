"""``program_trace`` over a hand-written Chrome trace: two profiled queries
with the harness's spans, the program's spans, CUDA runtime calls and the
device intervals they launched.  Each reading has its value worked out by
hand below; the accepted benchmark's trace metrics read the same with and
without the program's spans and runtime calls in the trace."""

import json

import pytest

from portbench import harness, program_trace, trace_read
from portbench.metrics import device_idle_share, k2_roofline_share

K2 = "velox.k2[rows=1000,widths=1/2/1,specs=3,groups=4]"


def X(name, cat, ts, end, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def harness_spans(kind, start, construct_end, end):
    return [X(f"portbench.{kind}.query", "user_annotation", start, end),
            X(f"portbench.{kind}.construct", "user_annotation", start + 1, construct_end),
            X(f"portbench.{kind}.pipeline", "user_annotation", construct_end + 1, end - 1)]


def program(name, ts, end):
    return X("velox." + name, "user_annotation", ts, end)


def launch(ts, corr, kernel, name="cudaLaunchKernel", cat="kernel"):
    """A runtime call at ``ts`` and the device interval it launched."""
    return [X(name, "cuda_runtime", ts, ts + 2, corr=corr),
            X(f"k{corr}", cat, kernel[0], kernel[1], tid=7, corr=corr)]


EVENTS = (
    # query 1 (Q3-shaped): two build sides, the second a bare tile
    harness_spans("q3", 0, 400, 1000)
    + [program("construct", 10, 390), program("build", 20, 300), program("construct", 25, 40),
       program("run", 45, 290), program("tile[bytes=1048576]", 50, 150),
       program("steps", 150, 200), program("fetch", 200, 280),
       program("build", 310, 380), program("tile[bytes=524288]", 320, 370),
       program("run", 410, 990), program("tile[bytes=2097152]", 420, 500),
       program("steps", 500, 600), program("aggregate", 600, 800), X(K2, "user_annotation", 650, 700),
       program("sort", 800, 850), program("fetch", 850, 980)]
    + launch(55, 1, (60, 160), "cudaMemcpyAsync", "gpu_memcpy") + launch(160, 2, (165, 185))
    + [X("cudaStreamSynchronize", "cuda_runtime", 205, 275)]
    + launch(610, 3, (615, 700)) + launch(660, 4, (690, 720)) + launch(810, 5, (815, 840))
    + [X("cudaStreamSynchronize", "cuda_runtime", 860, 970),
       X("cudaDeviceSynchronize", "cuda_runtime", 992, 998)]  # the harness's own
    # query 2 (Q12-shaped): one build side
    + harness_spans("q12", 1200, 1400, 1800)
    + [program("construct", 1210, 1390), program("build", 1220, 1380),
       program("tile[bytes=3145728]", 1230, 1300),
       X("cudaEventSynchronize", "cuda_runtime", 1310, 1320),
       program("run", 1410, 1790), program("aggregate", 1420, 1600),
       X("aten::copy_", "cpu_op", 1305, 1330)]
    + launch(1392, 9, (1395, 1399))  # outside every program span
    + launch(1430, 6, (1440, 1590)) + launch(1700, 7, (1705, 1745), "cudaMemcpy", "gpu_memcpy")
)


def write(tmp_path, events, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


@pytest.fixture
def prog(tmp_path):
    return program_trace.load(write(tmp_path, EVENTS))


def test_the_four_readings(prog):
    # outermost builds: (280 + 70) us in query 1, 160 us in query 2
    assert prog.build_side_ms() == pytest.approx((0.350 + 0.160) / 2)
    # tiles inside builds: 1 + 0.5 MiB, then 3 MiB; the probe's 2 MiB tile is not a build's
    assert prog.build_upload_mib() == pytest.approx((1.5 + 3.0) / 2)
    # two syncs a query inside construct / run; the harness's own is outside
    assert prog.host_syncs_per_query() == 2.0
    # the union of 615-700 and 690-720, then 1440-1590
    assert prog.aggregation_device_ms() == pytest.approx((0.105 + 0.150) / 2)


def test_launches_syncs_and_idle_charged_to_program_spans(prog):
    # 454 us of device time, 4 launched outside every program span
    assert prog.launched_inside_share() == pytest.approx(100 * 450 / 454)
    assert prog.k2_operands() == [dict(rows=1000, widths=[1, 2, 1], n_specs=3, num_groups=4)]
    table = prog.by_span()
    assert table["velox.tile"]["device_ms"] == pytest.approx(0.100)
    assert table["velox.aggregate"]["device_ms"] == pytest.approx(0.085 + 0.150)
    assert table["velox.k2"]["device_ms"] == pytest.approx(0.030)
    assert table["(none)"]["device_ms"] == pytest.approx(0.004)
    assert table["velox.fetch"]["syncs"] == 2 and table["velox.build"]["syncs"] == 1
    assert table["velox.run"]["syncs"] == 1  # the blocking cudaMemcpy
    assert dict(prog.sync_sites()) == {"velox.fetch / python": 2, "velox.build / aten::copy_": 1,
                                       "velox.run / python": 1, "(none) / python": 1}
    gaps = dict(prog.idle_gaps(top=100))
    assert gaps["q3.pipeline / velox.aggregate / python"] == pytest.approx(95e-6)
    assert gaps["q12.pipeline / velox.run / python"] == pytest.approx((41 + 115 + 55) * 1e-6)
    assert gaps["between queries / python"] == pytest.approx(555e-6)
    assert sum(gaps.values()) == pytest.approx(prog.base.window_s - prog.base.busy_s())


def test_a_trace_without_program_spans_reads_none(tmp_path):
    bare = [e for e in EVENTS if not e["name"].startswith("velox.")]
    prog = program_trace.load(write(tmp_path, bare))
    assert prog.build_side_ms() is None and prog.build_upload_mib() is None
    assert prog.host_syncs_per_query() is None and prog.aggregation_device_ms() is None
    assert prog.k2_operands() == [] and prog.launched_inside_share() == 0.0


def run_of(profile):
    return harness.Run("gpu", 0.0, 1.0, [], None, profile)


@pytest.mark.parametrize("metric", [device_idle_share, k2_roofline_share])
def test_accepted_metrics_read_the_same(tmp_path, metric):
    """The program's spans and the runtime calls leave the accepted
    benchmark's trace readings as they are."""
    k2 = [dict(rows=1000, widths=[1, 2, 1], n_specs=3, num_groups=4)]
    events = EVENTS + [X("grouped_piece_sums_kernel", "kernel", 700, 705, tid=7, corr=10)]
    harness_only = [e for e in events if not e["name"].startswith("velox.")
                    and e["cat"] not in program_trace.RUNTIME_CATEGORIES]
    full = trace_read.load(write(tmp_path, events, "full.json"), k2)
    bare = trace_read.load(write(tmp_path, harness_only, "bare.json"), k2)
    assert metric.read(run_of(full)) == metric.read(run_of(bare)) is not None
    assert program_trace.load(str(tmp_path / "full.json")).base == trace_read.load(
        str(tmp_path / "full.json"), [])


def test_span_counts():
    assert program_trace.span_counts(K2) == {"rows": 1000, "widths": [1, 2, 1], "specs": 3,
                                             "groups": 4}
    assert program_trace.span_counts("velox.tile[bytes=7]") == {"bytes": 7}
    assert program_trace.span_counts("velox.run") == {}
    assert program_trace.span_kind(K2) == "velox.k2"
