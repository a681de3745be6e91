"""Run one cell of the benchmark on this machine's CUDA device.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object on the last line of standard output, and
each number the correctness check compared, beside its limit, as the last
lines of standard error.  Exits non-zero, printing no result, when there is no
CUDA device or fewer than the cell asks for, or when the run loaded JAX or the
JAX package.  A cell whose configuration has a ``mesh`` runs across ranks,
one process a card (``mesh.py``); the configuration decides, not a flag.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    # the repo root, not this folder, heads the path: the folder's module
    # names must not hide others
    sys.path[0] = ROOT


def use_checkout_dirs() -> None:
    """Keep the program's kernel builds and any compiler cache inside the
    checkout, at fixed paths, so that only a checkout's first run builds."""
    build = os.path.join(ROOT, "build", "portbench")
    os.environ["VELOX_TORCH_BUILD_DIR"] = os.path.join(build, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def report(out: dict) -> None:
    """The checks on standard error, then the result line on standard out."""
    sys.stderr.flush()
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    use_checkout_dirs()
    import torch

    from portbench import harness

    chips = harness.cell_entry(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        return 2
    mesh = harness.Cell(args.workload).mesh
    if mesh is not None:  # one process a card (mesh.py)
        from portbench import mesh as ranks

        return ranks.launch(args.workload, args.seed, args.seconds, bool(args.trace), mesh)
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except harness.ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
