"""Rehearse one cell at a small scale: the same harness, set-up, window and
check as ``run.py``, on the CPU with the kernels' plain versions (``--device
cpu``, no device metric: the line says ``"platform": "cpu"``) or on the card.
A rehearsal only: its times are not the cell's.

    python3 portbench/rehearse.py --workload sf1-q1-q6 --seed 7 --seconds 2 \\
        --scale-factor 0.01 --tile-rows 16384 [--trace 1]

``--ranks N --backend gloo`` runs it across N ranks through ``mesh.py``'s
launcher and window, on the CPU or with the ranks sharing the card; so does
a cell whose configuration has a ``mesh``.  ``--folder`` reads the cell from
another folder of ``workloads/`` and ``configs/`` under ``portbench/`` (the
tests keep cells there).
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
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    p.add_argument("--ranks", type=int, default=None)
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--folder", default=harness.HERE)
    args = p.parse_args(argv)
    folder = os.path.abspath(args.folder)
    mesh = harness.Cell(args.workload, folder=folder).mesh
    if args.ranks is not None:
        mesh = dict(mesh or {}, ranks=args.ranks, backend=args.backend)
    if mesh is not None:
        from portbench import mesh as ranks

        return ranks.launch(args.workload, args.seed, args.seconds, bool(args.trace), mesh,
                            device=args.device, scale_factor=args.scale_factor,
                            tile_rows=args.tile_rows, folder=folder)
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               device=args.device, scale_factor=args.scale_factor,
                               tile_rows=args.tile_rows, folder=folder)
    except harness.ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
