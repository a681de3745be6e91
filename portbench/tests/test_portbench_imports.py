"""No run loads JAX or the JAX package, and the reference loads nothing of
the program.  Top-level module names are compared whole:
``velox_tpu_torch`` begins with ``velox_tpu`` and is not it."""

import json
import os
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "velox_tpu"}

LOADED = """
import json, sys
sys.path[0] = {root!r}
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded_after(body: str):
    done = subprocess.run(
        [sys.executable, "-c", LOADED.format(root=ROOT, body=body)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert done.returncode == 0, done.stderr[-3000:]
    return set(json.loads(done.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    # everything run.py imports, then a traced and an untraced run of every
    # query kind, which import the queries, references and metric readers
    body = "\n".join(
        ["import portbench.run", "from portbench import harness"]
        + [f"harness.run_cell({c!r}, 3, 0.3, {t}, device='cpu', scale_factor=0.01, tile_rows=1 << 14)"
           for c in ("sf1-q1-q6", "sf1-q3-q12") for t in (False, True)]
    )
    names = loaded_after(body)
    assert "velox_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    refs = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "portbench", "reference"))
                  if f.endswith(".py"))
    body = "\n".join(f"import portbench.reference.{r}" if r != "__init__" else "import portbench.reference"
                     for r in refs)
    body += "\nimport portbench.compare, portbench.datagen, portbench.params, portbench.control"
    # the generator's column and draw modules, which make what the reference reads
    body += "\nfrom portbench import datagen"
    body += "\ndatagen.generate_host(0.001, 1, {t: datagen.table_columns(t) for t in "
    body += "('lineitem', 'orders', 'customer')}, 'cpu')"
    names = loaded_after(body)
    assert not names & (FORBIDDEN | {"velox_tpu_torch"}), names & (FORBIDDEN | {"velox_tpu_torch"})
