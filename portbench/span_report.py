"""One traced run of a cell, read through the program's own spans.

    python3 portbench/span_report.py --workload sf1-q3-q12 --seed 5 --seconds 30

Runs the cell as ``run.py --trace 1`` does (the same harness, window and
check) and keeps the profiled stretch's Chrome trace long enough to read it
with ``program_trace`` too.  Prints one JSON object: the result line's
``correct`` and per-layer metrics, then the program's readings
(``build_side_ms``, ``build_upload_mib``, ``host_syncs_per_query``,
``aggregation_device_ms``), the share of device time launched inside a
program span, device and idle ms and synchronisations by innermost program
span, the idle gaps labelled with the program's spans, the span and host
operator each synchronisation waits in, the program spans a query opens,
and whether each ``velox.k2`` span's operands equal the launch
``harness.K2Recorder`` recorded.  ``--device cpu`` rehearses at a small
scale (``--scale-factor``, ``--tile-rows``): no device interval, so only the
host readings.
"""

import json
import os
import sys
import tempfile

if __name__ == "__main__":  # the repo root, not this folder, heads the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness, program_trace, trace_read  # noqa: E402
from portbench.run import parser, use_checkout_dirs  # noqa: E402


def traced_run(name: str, seed: int, seconds: float, **kw):
    """(the result line's object, the ``ProgramTrace`` of its stretch, the
    launches ``K2Recorder`` recorded) of one traced run."""
    kept = {}

    def read_profile(prof, k2_launches):
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            kept.update(program=program_trace.load(path), k2=list(k2_launches))
            return trace_read.load(path, k2_launches)
        finally:
            os.unlink(path)

    original, harness._read_profile = harness._read_profile, read_profile
    try:
        out = harness.run_cell(name, seed, seconds, True, **kw)
    finally:
        harness._read_profile = original
    return out, kept.get("program"), kept.get("k2", [])


def report(out: dict, prog, k2: list) -> dict:
    rep = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
           "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "device": out["device"]}
    if prog is None:
        return rep
    n = len(prog.queries)
    spans = prog.program_spans()
    rep["program"] = {
        "profiled_queries": n,
        "build_side_ms": prog.build_side_ms(),
        "build_upload_mib": prog.build_upload_mib(),
        "host_syncs_per_query": prog.host_syncs_per_query(),
        "aggregation_device_ms": prog.aggregation_device_ms(),
        "launched_inside_share": prog.launched_inside_share(),
        "spans_per_query": len(spans) / n if n else None,
        "by_span": prog.by_span(),
        "idle_gaps": prog.idle_gaps(),
        "sync_sites": prog.sync_sites(),
        "k2_spans": len(prog.k2_operands()),
        "k2_recorded": len(k2),
        "k2_operands_equal": prog.k2_operands() == k2,
    }
    return rep


def main(argv=None) -> int:
    p = parser(__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cpu to rehearse; the CUDA device by default")
    p.add_argument("--scale-factor", type=float, default=None)
    p.add_argument("--tile-rows", type=int, default=None)
    args = p.parse_args(argv)
    use_checkout_dirs()
    out, prog, k2 = traced_run(args.workload, args.seed, args.seconds, device=args.device,
                               scale_factor=args.scale_factor, tile_rows=args.tile_rows)
    print(json.dumps(report(out, prog, k2)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
