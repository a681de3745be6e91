"""The complex-type slice on the card against the same calls on the CPU: the
array / map / lambda functions, Unnest and GroupId, the collect aggregates,
string construction, and the slice's TPC-H texts (``chip_smoke.py``
``COMPLEX_SQL`` and ``complex_plan``, C1-C8) at SF 0.01 against their numpy
oracles.  The CPU tests hold the same code against the JAX package; what
only a CUDA device shows is that every call exists there and gives the same
rows.  Skipped where there is no CUDA device; run with
``python -m pytest tests/test_torch_gpu_complex.py -m gpu``.

Integers, strings and array contents exact; DOUBLE rtol 1e-9."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_complex import CASES, PORT
from velox_tpu_torch.connectors.tpch import load_table
from velox_tpu_torch.exec.runner import LocalExecutor, QueryError
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.sql import plan_sql
from velox_tpu_torch.testing import assert_same_values, python_rows

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _rows(plan, device, tile_rows=1 << 20):
    try:
        return python_rows(LocalExecutor(plan, tile_rows=tile_rows, device=device).run())
    except QueryError:
        return QueryError


@pytest.mark.parametrize("name", [n for n in CASES if n != "repeat_column"])
def test_complex_case_matches_cpu(cuda, name):
    plan = CASES[name](PORT)
    got, want = _rows(plan, cuda), _rows(plan, "cpu")
    if want is QueryError:
        assert got is QueryError
        return
    for col in want:
        assert_same_values(got[col], want[col], path=col)


@pytest.mark.parametrize("name", [*cs.COMPLEX_SQL, "C7", "C8"])
def test_complex_text_matches_oracle_and_cpu(cuda, name):
    tables = {t: load_table(t, 0.01, list(c)) for t, c in cs.COMPLEX_COLUMNS[name].items()}

    def plan():
        return (plan_sql(cs.COMPLEX_SQL[name], tables) if name in cs.COMPLEX_SQL
                else cs.complex_plan(name, PlanBuilder, tables))

    got = LocalExecutor(plan(), tile_rows=1 << 12, device=cuda).run()
    cs.check_complex(name, got, tables)
    want = python_rows(LocalExecutor(plan(), tile_rows=1 << 12, device="cpu").run())
    rows = python_rows(got)
    for col in want:
        key = lambda i: tuple(repr(v[i]) for v in want.values())  # noqa: E731
        order_w = sorted(range(len(want[col])), key=key)
        key_g = lambda i: tuple(repr(v[i]) for v in rows.values())  # noqa: E731
        order_g = sorted(range(len(rows[col])), key=key_g)
        assert_same_values([rows[col][i] for i in order_g], [want[col][i] for i in order_w], path=col)


def test_segpool_on_the_card_matches_cpu(cuda):
    from velox_tpu_torch.ops import segpool as sp

    rng = np.random.default_rng(9)
    starts = torch.as_tensor(rng.integers(0, 100, 32))
    sizes = torch.as_tensor(rng.integers(0, 6, 32))
    values = torch.as_tensor(rng.integers(-50, 50, 128))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        st, sz, (v,), rowid, emask, _ = sp.normalize(starts.to(dev), sizes.to(dev), (values.to(dev),), 128)
        outs.append([
            sp.segment_reduce(v, st, sz, rowid, emask, op).cpu() for op in ("sum", "min", "max")
        ] + [sp.sort_within_rows(v, rowid, emask, (v,))[0].cpu()[emask.cpu()]])
    for g, w in zip(*outs):
        assert torch.equal(g, w)
