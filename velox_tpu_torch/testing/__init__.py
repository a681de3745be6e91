"""Test utilities: tables from plain host data + plan-result assertions.

Counterpart of the JAX package's ``testing``.  Reference:
velox/exec/tests/utils/QueryAssertions.h:37 (assertQuery against an oracle) —
here the oracle is a pandas DataFrame the caller computes independently.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import numpy as np

from ..dtypes import DataType, RowType, TypeKind, decimal
from ..io.table import Table
from ..vector.string_table import StringTable

__all__ = [
    "assert_plan_result",
    "assert_same_rows",
    "assert_same_values",
    "parse_type",
    "python_rows",
    "run_at_tile_sizes",
    "table_from_numpy",
]


_DECIMAL_RE = re.compile(r"^DECIMAL\((\d+),\s*(\d+)\)$", re.IGNORECASE)


def parse_type(text: str) -> DataType:
    """The scalar DataType named by ``str(DataType)`` ('BIGINT', 'DATE',
    'DECIMAL(12,2)', ...)."""
    m = _DECIMAL_RE.match(text.strip())
    if m:
        return decimal(int(m.group(1)), int(m.group(2)))
    return DataType(TypeKind(text.strip().upper()))


def table_from_numpy(
    names: Sequence[str],
    type_strings: Sequence[str],
    columns: Dict[str, np.ndarray],
    string_values: Optional[Dict[str, Sequence]] = None,
    validities: Optional[Dict[str, np.ndarray]] = None,
) -> Table:
    """Build a Table from plain numpy / Python values.

    ``type_strings``: one SQL type string per column (``str(DataType)``
    round-trips).  ``columns``: arrays already in the device representation
    (unscaled decimals, int32 days, int32 string codes).  ``string_values``:
    per string column, the dictionary's values in code order.  This is how
    data generated elsewhere (another engine, a file) is carried across
    without sharing any code."""
    schema = RowType(list(names), [parse_type(t) for t in type_strings])
    tables = {}
    for name, values in (string_values or {}).items():
        values = list(values)
        if not values or values[0] != "" or len(set(values)) != len(values):
            raise ValueError(
                f"string_values[{name!r}] must list distinct values in code "
                "order, starting with the empty string"
            )
        tables[name] = StringTable.from_values(values)
    return Table(
        schema,
        {n: np.asarray(columns[n]) for n in names},
        tables,
        {n: np.asarray(v, dtype=bool) for n, v in (validities or {}).items()},
    )


def assert_plan_result(
    plan,
    expected,
    sort_by: Optional[Sequence[str]] = None,
    tile_rows: int = 1 << 20,
    check_dtype: bool = False,
    device=None,
):
    """Execute a plan and compare against a pandas oracle (assertQuery).

    ``sort_by``: columns to sort both sides by first (unordered queries).
    Returns the engine DataFrame for further checks."""
    import pandas as pd

    from ..exec.runner import LocalExecutor

    got = LocalExecutor(plan, tile_rows=tile_rows, device=device).run().to_pandas()
    expect = expected.copy()
    if sort_by:
        got = got.sort_values(list(sort_by)).reset_index(drop=True)
        expect = expect.sort_values(list(sort_by)).reset_index(drop=True)
    pd.testing.assert_frame_equal(
        got.reset_index(drop=True),
        expect.reset_index(drop=True),
        check_dtype=check_dtype,
    )
    return got


def run_at_tile_sizes(plan, tile_sizes=(1 << 10, 1 << 14, 1 << 20), device=None):
    """Execute a plan at several tile sizes and assert identical results —
    the tiling-invariance discipline every exact operator must satisfy."""
    import pandas as pd

    from ..exec.runner import LocalExecutor

    results = [
        LocalExecutor(plan, tile_rows=t, device=device).run().to_pandas()
        for t in tile_sizes
    ]
    for other in results[1:]:
        pd.testing.assert_frame_equal(results[0], other)
    return results[0]


def assert_same_rows(got, want, rtol: float = 1e-9, atol: float = 0.0):
    """Two result Tables hold the same rows in the same order: same names,
    type strings and NULLs; strings compared by value, floats to ``rtol``
    (NaN equal to NaN), everything else exactly.  ``want`` may be a Table of
    another engine with the same layout (schema, columns, validities,
    string_tables)."""
    assert list(got.schema.names) == list(want.schema.names)
    assert [str(t) for t in got.schema.types] == [str(t) for t in want.schema.types]
    assert got.num_rows == want.num_rows
    for name, dtype in zip(want.schema.names, want.schema.types):
        g, w = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        gv, wv = got.validities.get(name), want.validities.get(name)
        gv = np.ones(len(g), bool) if gv is None else np.asarray(gv, bool)
        wv = np.ones(len(w), bool) if wv is None else np.asarray(wv, bool)
        np.testing.assert_array_equal(gv, wv, err_msg=f"{name}: NULLs")
        g, w = g[wv], w[wv]
        if dtype.is_string:
            assert list(got.string_tables[name].decode(g)) == list(
                want.string_tables[name].decode(w)
            ), name
        elif dtype.is_floating:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def python_rows(table) -> Dict[str, list]:
    """A result Table as {column: list of Python values}: NULL is None,
    strings decoded, ARRAY / MAP / ROW values as lists / dicts.  Works on a
    Table of another engine with the same layout (it only calls
    ``to_pandas``)."""
    df = table.to_pandas()
    return {name: [_py_value(v) for v in df[name].tolist()] for name in df.columns}


def _py_value(v):
    if v is None:
        return None
    if isinstance(v, dict):
        return {_py_value(k): _py_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, np.ndarray)):
        return [_py_value(x) for x in v]
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and v != v:
        return None  # pandas spells a NULL of a float or string column NaN
    try:
        import pandas as pd

        if v is pd.NA:
            return None
    except ImportError:  # pragma: no cover
        pass
    return v


def assert_same_values(got, want, rtol: float = 1e-9, path: str = "") -> None:
    """Nested Python values (``python_rows``) equal: floats to ``rtol``,
    everything else exactly, dict keys as sets."""
    if isinstance(want, float) or isinstance(got, float):
        assert got is not None and want is not None, (path, got, want)
        assert abs(got - want) <= rtol * max(abs(got), abs(want)), (path, got, want)
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_same_values(got[k], want[k], rtol, f"{path}[{k!r}]")
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_values(g, w, rtol, f"{path}[{i}]")
        return
    assert got == want, (path, got, want)
