"""Expression evaluation of the port (velox_tpu_torch.expr) against the JAX
package's: the same SQL text is parsed, bound and evaluated by both packages
over the same numpy rows.  Integer, decimal, date and boolean results must be
equal bit for bit; DOUBLE results to rtol 1e-12 (one IEEE division each side).
Validity and error lanes must be equal wherever either side reports one."""

import numpy as np
import pytest
import torch

import velox_tpu as vt
import velox_tpu_torch as vtt
from velox_tpu.expr.binding import bind_string_literals as ref_bind
from velox_tpu.expr.compiler import ExprSet as RefExprSet
from velox_tpu.expr.parser import parse_expr as ref_parse
from velox_tpu.vector.column import Batch as RefBatch
from velox_tpu_torch.expr.binding import bind_string_literals as port_bind
from velox_tpu_torch.expr.compiler import ExprSet as PortExprSet
from velox_tpu_torch.expr.parser import parse_expr as port_parse
from velox_tpu_torch.vector.column import Batch as PortBatch

N = 1000
CAP = 1024

_COLUMNS = [
    # name, type string, (lo, hi), upload dtype, nullable
    ("l_quantity", "DECIMAL(12,2)", (100, 5000), np.int16, False),
    ("l_extendedprice", "DECIMAL(12,2)", (90000, 10500000), np.int32, False),
    ("l_discount", "DECIMAL(12,2)", (0, 10), np.int8, False),
    ("l_tax", "DECIMAL(12,2)", (0, 8), np.int8, False),
    ("l_shipdate", "DATE", (8036, 10561), np.int32, False),
    ("n_dec", "DECIMAL(12,2)", (-500, 500), np.int64, True),
    ("n_int", "BIGINT", (-3, 3), np.int64, True),
    ("n_flag", "BOOLEAN", (0, 1), np.bool_, True),
    ("dbl", "DOUBLE", None, np.float64, False),
]


def _type(mod, text):
    if text.startswith("DECIMAL"):
        p, s = text[8:-1].split(",")
        return mod.decimal(int(p), int(s))
    return getattr(mod, text)


def _data():
    rng = np.random.default_rng(17)
    arrays, validities = [], []
    for _, _, bounds, dt, nullable in _COLUMNS:
        if bounds is None:
            arr = rng.normal(0, 1e3, N)
        elif dt is np.bool_:
            arr = rng.random(N) < 0.5
        else:
            arr = rng.integers(bounds[0], bounds[1] + 1, N).astype(dt)
        arrays.append(arr)
        validities.append(rng.random(N) < 0.8 if nullable else None)
    return arrays, validities


def _batches():
    arrays, validities = _data()
    names = [c[0] for c in _COLUMNS]
    ref_schema = vt.RowType(names, [_type(vt, c[1]) for c in _COLUMNS])
    port_schema = vtt.RowType(names, [_type(vtt, c[1]) for c in _COLUMNS])
    ref_batch = RefBatch.from_numpy(ref_schema, arrays, validities, capacity=CAP)
    port_batch = PortBatch.from_numpy(
        port_schema, arrays, validities, capacity=CAP, device="cpu"
    )
    return ref_batch, port_batch


_BATCHES = []


def _both():
    if not _BATCHES:
        _BATCHES.extend(_batches())
    return _BATCHES


EXPRESSIONS = {
    # the TPC-H Q1 / Q6 scan filters and projections
    "q1_filter": "l_shipdate <= date '1998-12-01' - interval '90' day",
    "q6_filter": (
        "l_shipdate >= date '1994-01-01' "
        "and l_shipdate < date '1994-01-01' + interval '365' day "
        "and l_discount between 0.05 and 0.07 and l_quantity < 24"
    ),
    "q1_disc_price": "l_extendedprice * (1 - l_discount)",
    "q1_charge": "l_extendedprice * (1 - l_discount) * (1 + l_tax)",
    "q6_revenue": "l_extendedprice * l_discount",
    # decimal arithmetic with rescale, comparisons, Kleene logic over NULLs
    "dec_plus_rescale": "l_quantity + 0.5",
    "dec_minus": "l_extendedprice - l_quantity",
    "dec_negate": "-n_dec",
    "dec_compare_null": "n_dec > 1.25",
    "kleene_and": "n_flag and n_int > 0",
    "kleene_or": "n_flag or n_dec < 0",
    "not_null_flag": "not n_flag",
    "is_null": "n_int is null",
    "is_not_null": "n_dec is not null",
    "between_dates": "l_shipdate between date '1994-01-01' and date '1995-01-01'",
    "int_arith": "n_int * 7 - 2",
    # casts, errors and the special forms
    "cast_dec_to_double": "cast(l_extendedprice as double)",
    "cast_dec_to_bigint": "cast(n_dec as bigint)",
    "cast_int_to_dec": "cast(n_int as decimal(12,2))",
    "cast_double_to_bigint": "cast(dbl as bigint)",
    "div_by_zero_error": "l_quantity / n_int",
    "int_div_error": "100 / n_int",
    "mod_error": "17 % n_int",
    "try_div": "try(100 / n_int)",
    "if_form": "if(n_int > 0, l_quantity, l_tax)",
    "case_form": "case when n_int < 0 then 1 when n_int = 0 then 2 else 3 end",
    "coalesce_form": "coalesce(n_int, 42)",
    "in_form": "n_int in (1, 2, 3)",
    "double_arith": "dbl * 2.5 + 1",
}


def _eval(name):
    ref_batch, port_batch = _both()
    sql = EXPRESSIONS[name]
    r_expr = ref_bind(ref_parse(sql, ref_batch.schema), {})
    p_expr = port_bind(port_parse(sql, port_batch.schema), {})
    assert str(r_expr.dtype) == str(p_expr.dtype)
    [r] = RefExprSet([r_expr]).eval(ref_batch)
    [p] = PortExprSet([p_expr]).eval(port_batch)
    return r_expr, r, p


def _lane(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.numpy()[:N]
    return np.asarray(x)[:N]


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_expression_agrees(name):
    expr, r, p = _eval(name)
    rv, pv = _lane(r.values), _lane(p.values)
    r_valid = np.ones(N, bool) if r.validity is None else _lane(r.validity)
    p_valid = np.ones(N, bool) if p.validity is None else _lane(p.validity)
    r_err = np.zeros(N, bool) if r.errors is None else _lane(r.errors)
    p_err = np.zeros(N, bool) if p.errors is None else _lane(p.errors)
    np.testing.assert_array_equal(p_valid, r_valid)
    np.testing.assert_array_equal(p_err, r_err)
    live = r_valid & ~r_err  # values of NULL / erroring rows are unspecified
    assert pv.dtype == rv.dtype
    if expr.dtype.is_floating:
        np.testing.assert_allclose(pv[live], rv[live], rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(pv[live], rv[live])


def test_filter_selectivity_is_not_degenerate():
    # the Q1 / Q6 filters must keep some rows and drop some, or the parity
    # above would hold vacuously
    for name in ("q1_filter", "q6_filter"):
        _, _, p = _eval(name)
        kept = int(_lane(p.values).sum())
        assert 0 < kept < N, (name, kept)


def test_unregistered_function_raises_by_name():
    # every name of the JAX package's registry is registered now, the Spark
    # functions included (test_torch_scalar_functions.py); a name neither
    # package knows raises by name
    _, port_batch = _both()
    assert port_parse("pmod(n_int, 3)", port_batch.schema).name == "pmod"
    with pytest.raises(KeyError, match="no_such_function"):
        port_parse("no_such_function(n_int, 3)", port_batch.schema)
