"""Each query kind's reference gives the port's answer, on the CPU at SF
0.01, for several parameter draws and two tile sizes."""

import numpy as np
import pytest
import torch
from portbench_testing import KINDS, SF

from portbench import compare, datagen, harness, params

CELL_OF = {"q1": "sf1-q1-q6", "q6": "sf1-q1-q6", "q3": "sf1-q3-q12", "q12": "sf1-q3-q12"}


@pytest.fixture(scope="module")
def world():
    cells = {name: harness.Cell(name, scale_factor=SF) for name in set(CELL_OF.values())}
    columns = {}
    for cell in cells.values():
        for t, cols in cell.columns().items():
            columns.setdefault(t, [])
            columns[t] += [c for c in cols if c not in columns[t]]
    host = datagen.generate_host(SF, 424242, columns, "cpu")
    data = {t: {c: torch.from_numpy(a) for c, a in cols.items()} for t, cols in host.items()}
    return cells, harness.program_tables(host), data


@pytest.mark.parametrize("tile_rows", [1 << 14, 1 << 12])
@pytest.mark.parametrize("kind", KINDS)
def test_reference_equals_the_port(world, kind, tile_rows):
    from velox_tpu_torch.exec.runner import LocalExecutor

    cells, tables, data = world
    cell = cells[CELL_OF[kind]]
    mod, ref = cell.kinds[kind], cell.references[kind]
    kind_tables = {t: tables[t].select(cols) for t, cols in mod.TABLES.items()}
    rng = np.random.default_rng(tile_rows + len(kind))
    memo = {}
    for _ in range(3):
        p = params.draw(cell.rules[kind], rng)
        got = harness.answer_of(
            LocalExecutor(mod.build(kind_tables, p), tile_rows=tile_rows, device="cpu").run()
        )
        want = ref.answer(data, p, "exact", memo)
        assert len(want[0][3]) > 0, (kind, p)
        mismatched, gap = compare.compare(got, want)
        assert mismatched == 0 and gap <= cell.config["limits"]["double_rel_gap"], (kind, p, got, want)
