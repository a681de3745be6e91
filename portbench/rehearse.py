"""Rehearse one cell on the CPU at a small scale, with the kernels' plain
versions: the same harness, set-up, window and check as ``run.py``, but no
device metric (the line says ``"platform": "cpu"``).  A rehearsal only: its
times are the CPU's.

    python3 portbench/rehearse.py --workload sf1-q1-q6 --seed 7 --seconds 2 \\
        --scale-factor 0.01 --tile-rows 16384 [--trace 1]
"""

import os
import sys

if __name__ == "__main__":  # the repo root, not this folder, heads the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness  # noqa: E402
from portbench.run import parser, report  # noqa: E402


def main(argv=None) -> int:
    p = parser(__doc__.splitlines()[0])
    p.add_argument("--scale-factor", type=float, default=0.01)
    p.add_argument("--tile-rows", type=int, default=1 << 14)
    args = p.parse_args(argv)
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               device="cpu", scale_factor=args.scale_factor,
                               tile_rows=args.tile_rows)
    except harness.ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
