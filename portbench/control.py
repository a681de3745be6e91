"""The control of the correctness check: the reference, computed in a lower
precision, put in the program's place and judged by the harness's own check.

    python3 portbench/control.py --workload sf10-q1-q6 --seeds 11,12,13 --queries 2000

For each seed it makes the cell's columns at the cell's own size, draws the
parameters of ``--queries`` queries as a run's window draws them
(``harness.draws``), answers each with the reference in float32 (decimals and
DOUBLE alike, the nearest precision below the configuration's), and prints
one JSON line with the numbers ``harness.check_answers`` compares, beside
their limits, overall and a query kind.  The check must refuse it.  It runs nothing of the program.
"""

import argparse
import itertools
import json
import os
import sys

if __name__ == "__main__":  # the repo root, not this folder, heads the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from portbench import datagen, harness, params  # noqa: E402

PRECISION = "float32"


def control_readings(cell, seed: int, n_queries: int, device) -> dict:
    host = datagen.generate_host(cell.sf, seed, cell.columns(), device)
    data = {t: {c: torch.from_numpy(a).to(device) for c, a in cols.items()} for t, cols in host.items()}
    queries, answers, memo = [], {}, {}
    for kind, drawn in itertools.islice(harness.draws(cell, seed), n_queries):
        q = harness.Query(kind, drawn, 0)
        key = kind + params.key(q.params)
        if key not in answers:
            answers[key] = cell.references[kind].answer(data, q.params, PRECISION, memo)
        q.answer = answers[key]
        queries.append(q)
    del data, memo
    out = {"seed": seed, "precision": PRECISION, "queries": n_queries, "distinct": len(answers),
           "checks": harness.check_answers(cell, host, queries, device)}
    out["by_kind"] = {
        k: harness.check_answers(cell, host, [q for q in queries if q.kind == k], device)
        for k in cell.kinds
    }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--queries", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale-factor", type=float, default=None)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload, scale_factor=args.scale_factor)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_readings(cell, seed, args.queries, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
