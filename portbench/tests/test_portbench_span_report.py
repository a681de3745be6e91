"""``span_report.traced_run``: a traced run read through the program's spans,
rehearsed on the CPU, and on the card, where every ``velox.k2`` span's
operands must equal the launch ``harness.K2Recorder`` recorded, one for one."""

import pytest
import torch
from portbench_testing import SF, TILE_ROWS

from portbench import program_trace, span_report


def test_a_rehearsed_report_reads_the_build_sides():
    out, prog, k2 = span_report.traced_run("sf1-q3-q12", 2**31 + 21, 10, device="cpu",
                                           scale_factor=SF, tile_rows=TILE_ROWS)
    rep = span_report.report(out, prog, k2)["program"]
    assert out["correct"] and rep["profiled_queries"] == 20
    assert rep["build_side_ms"] > 0 and rep["build_upload_mib"] > 0
    # no runtime call and no device interval on the CPU
    assert rep["host_syncs_per_query"] is None and rep["aggregation_device_ms"] is None
    kinds = {program_trace.span_kind(name) for _, _, name, _ in prog.program_spans()}
    assert {"velox.construct", "velox.build", "velox.tile", "velox.run", "velox.steps",
            "velox.aggregate", "velox.fetch"} <= kinds


@pytest.mark.gpu
def test_k2_spans_are_the_recorded_launches():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card")
    out, prog, k2 = span_report.traced_run("sf1-q1-q6", 2**31 + 22, 3)
    rep = span_report.report(out, prog, k2)["program"]
    assert out["correct"] and len(k2) > 0
    assert prog.k2_operands() == k2
    assert rep["launched_inside_share"] >= 98
    assert rep["host_syncs_per_query"] > 0 and rep["aggregation_device_ms"] > 0
