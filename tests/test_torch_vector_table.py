"""Columns, batches and table tiles of the port against the JAX package's:
the same numpy data through both, results equal bit for bit (no arithmetic is
involved, only encoding, widening, masking and slicing)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import velox_tpu as vt
import velox_tpu_torch as vtt
from velox_tpu.io.table import Table as RefTable
from velox_tpu.vector.column import Batch as RefBatch, Column as RefColumn
from velox_tpu_torch.io.table import Table as PortTable
from velox_tpu_torch.vector.column import Batch as PortBatch, Column as PortColumn, Encoding

CAP = 64


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(port_pair, ref_pair):
    pv, pval = port_pair
    rv, rval = ref_pair
    assert _np(pv).dtype == _np(rv).dtype
    np.testing.assert_array_equal(_np(pv), _np(rv))
    assert (pval is None) == (rval is None)
    if pval is not None:
        np.testing.assert_array_equal(_np(pval), _np(rval))


def _flat_pair(arr, type_name, validity=None):
    ref = RefColumn.from_numpy(arr, getattr(vt, type_name), validity)
    port = PortColumn.from_numpy(arr, getattr(vtt, type_name), validity)
    return ref, port


@pytest.mark.parametrize(
    "np_dtype,type_name",
    [(np.int8, "BIGINT"), (np.int16, "INTEGER"), (np.int32, "BIGINT"),
     (np.int64, "BIGINT"), (np.float64, "DOUBLE"), (np.bool_, "BOOLEAN"), (np.int32, "DATE")],
)
def test_flat_decode_widens_like_reference(np_dtype, type_name):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 2 if np_dtype is np.bool_ else 100, CAP).astype(np_dtype)
    validity = rng.random(CAP) < 0.7
    ref, port = _flat_pair(arr, type_name, validity)
    assert _np(port.data).dtype == _np(ref.data).dtype  # narrow stays narrow on the wire
    _same(port.decode(CAP), ref.decode(CAP))


def test_constant_and_null_constant_decode():
    for value, is_null in ((7, False), (0, True)):
        ref = RefColumn.constant(value, vt.BIGINT, is_null=is_null)
        port = PortColumn.constant(value, vtt.BIGINT, is_null=is_null)
        assert port.encoding == Encoding.CONSTANT and port.is_constant
        _same(port.decode(CAP), ref.decode(CAP))


def test_dictionary_decode_gather_and_clamp():
    rng = np.random.default_rng(2)
    base_vals = rng.integers(-50, 50, 10).astype(np.int64)
    base_valid = rng.random(10) < 0.8
    idx = rng.integers(0, 10, CAP).astype(np.int32)
    idx[:3] = [-4, 10, 99]  # out of range: both sides clamp to the ends
    outer_valid = rng.random(CAP) < 0.9
    ref = RefColumn.dictionary(
        jnp.asarray(idx), RefColumn.from_numpy(base_vals, vt.BIGINT, base_valid),
        jnp.asarray(outer_valid),
    )
    port = PortColumn.dictionary(
        torch.from_numpy(idx), PortColumn.from_numpy(base_vals, vtt.BIGINT, base_valid),
        torch.from_numpy(outer_valid),
    )
    _same(port.decode(CAP), ref.decode(CAP))
    order = rng.permutation(CAP).astype(np.int32)
    rg, pg = ref.gather(jnp.asarray(order)), port.gather(torch.from_numpy(order))
    assert pg.encoding.value == rg.encoding.value == "DICTIONARY"
    _same(pg.decode(CAP), rg.decode(CAP))
    _same(port.flatten(CAP).decode(CAP), ref.flatten(CAP).decode(CAP))


def test_flat_gather():
    arr = np.arange(CAP, dtype=np.int64) * 3
    validity = np.arange(CAP) % 5 != 0
    ref, port = _flat_pair(arr, "BIGINT", validity)
    order = np.random.default_rng(3).integers(0, CAP, 40).astype(np.int32)
    _same(port.gather(torch.from_numpy(order)).decode(40), ref.gather(jnp.asarray(order)).decode(40))


def test_sequence_and_bias_raise_by_name():
    """SEQUENCE and BIAS are ported (``tests/test_torch_encodings.py`` holds
    them to the JAX package).  What still raises names the encoding: a
    SEQUENCE column has no row capacity of its own, and its run lengths must
    cover the capacity it is given."""
    runs = PortColumn.from_numpy(np.array([1, 2], np.int64), vtt.BIGINT)
    seq = PortColumn.sequence(runs, [3, 5], 8)
    assert seq.encoding == Encoding.SEQUENCE
    assert seq.to_numpy(8)[0].tolist() == [1, 1, 1, 2, 2, 2, 2, 2]
    with pytest.raises(ValueError, match="sequence"):
        seq.capacity
    with pytest.raises(AssertionError, match="sum to capacity"):
        PortColumn.sequence(runs, [3, 4], 8)
    bias = PortColumn.bias(1 << 40, np.array([-1, 2], np.int8), vtt.BIGINT)
    assert bias.encoding == Encoding.BIAS
    assert bias.to_numpy(2)[0].tolist() == [(1 << 40) - 1, (1 << 40) + 2]


def _schemas():
    names = ["a", "s", "d"]
    return (
        vt.RowType(names, [vt.BIGINT, vt.VARCHAR, vt.decimal(12, 2)]),
        vtt.RowType(names, [vtt.BIGINT, vtt.VARCHAR, vtt.decimal(12, 2)]),
    )


def test_batch_active_mask_selection_and_pandas():
    rs, ps = _schemas()
    rng = np.random.default_rng(4)
    n = 50
    arrays = [
        rng.integers(-9, 9, n).astype(np.int64),
        np.asarray(rng.choice(["x", "yy", ""], n), dtype=object),
        rng.integers(0, 10000, n).astype(np.int64),
    ]
    validities = [rng.random(n) < 0.8, None, None]
    ref = RefBatch.from_numpy(rs, arrays, validities, capacity=CAP)
    port = PortBatch.from_numpy(ps, arrays, validities, capacity=CAP, device="cpu")
    np.testing.assert_array_equal(_np(port.active_mask()), _np(ref.active_mask()))
    keep = rng.random(CAP) < 0.5
    ref2 = ref.with_selection(jnp.asarray(keep)).with_selection(jnp.asarray(~keep | (np.arange(CAP) < 20)))
    port2 = port.with_selection(torch.from_numpy(keep)).with_selection(
        torch.from_numpy(~keep | (np.arange(CAP) < 20))
    )
    np.testing.assert_array_equal(_np(port2.active_mask()), _np(ref2.active_mask()))
    assert int(port2.num_active()) == int(ref2.num_active())
    got, want = port2.to_pandas(), ref2.to_pandas()
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        assert [None if v is None else v for v in got[c]] == [None if v is None else v for v in want[c]]


def _tables(n=1000):
    rng = np.random.default_rng(5)
    cols = {
        "tiny": rng.integers(-100, 100, n).astype(np.int64),
        "small": rng.integers(-30000, 30000, n).astype(np.int64),
        "mid": rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
        "wide": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
        "day": rng.integers(8000, 10000, n).astype(np.int32),
        "dec": rng.integers(0, 11, n).astype(np.int64),
        "dbl": rng.normal(size=n),
    }
    validity = {"small": rng.random(n) < 0.9}
    names = list(cols)
    def types(m):
        return [m.BIGINT, m.BIGINT, m.BIGINT, m.BIGINT, m.DATE, m.decimal(12, 2), m.DOUBLE]
    ref = RefTable(vt.RowType(names, types(vt)), dict(cols), {}, dict(validity))
    port = PortTable(vtt.RowType(names, types(vtt)), dict(cols), {}, dict(validity))
    return ref, port


def test_column_bounds_and_num_tiles():
    ref, port = _tables()
    for name in ref.schema.names:
        assert port.column_bounds(name) == ref.column_bounds(name)
    for rows in (128, 1000, 4096):
        assert port.num_tiles(rows) == ref.num_tiles(rows)
    assert port.select(["day", "tiny"]).column_bounds("tiny") == ref.column_bounds("tiny")


@pytest.mark.parametrize("index", [0, 3])  # a full tile and the ragged last one
def test_tile_narrow_upload_matches_reference(index):
    ref, port = _tables()
    rt = ref.tile(index, 256)
    pt = port.tile(index, 256, device="cpu")
    assert pt.capacity == rt.capacity == 256
    assert int(pt.length) == int(rt.length)
    assert int(pt.row_offset) == int(rt.row_offset)
    wire = {}
    for name in ref.schema.names:
        rc, pc = rt.column(name), pt.column(name)
        assert _np(pc.data).dtype == _np(rc.data).dtype, name
        wire[name] = _np(pc.data).dtype
        np.testing.assert_array_equal(_np(pc.data), _np(rc.data))
        _same(pc.decode(256), rc.decode(256))
    assert (wire["tiny"], wire["small"], wire["mid"], wire["wide"]) == (
        np.int8, np.int16, np.int32, np.int64,
    )
    assert wire["dec"] == np.int8 and wire["day"] == np.int16
    np.testing.assert_array_equal(_np(pt.active_mask()), _np(rt.active_mask()))


def test_device_tiles_and_to_pandas():
    ref, port = _tables(300)
    tiles = port.device_tiles(128, device="cpu")
    assert len(tiles) == 3 == len(ref.device_tiles(128))
    got, want = port.to_pandas(), ref.to_pandas()
    for c in want.columns:
        assert [v for v in got[c]] == [v for v in want[c]] or np.allclose(
            got[c].astype(float), want[c].astype(float), equal_nan=True
        )


def test_unported_file_formats_raise(tmp_path):
    """Parquet and Arrow are ported (``tests/test_torch_files.py`` holds them
    to the JAX package): a table round-trips, the JAX package reads the
    port's file, and a missing file or a source that is not Arrow data
    raises."""
    ref, port = _tables(10)
    path = str(tmp_path / "t.parquet")
    port.save_parquet(path)
    valid = port.validities["small"]
    for back in (PortTable.load_parquet(path), RefTable.load_parquet(path)):
        for name in port.schema.names:
            want = port.columns[name]
            if name == "small":  # a NULL row reads back as 0
                want = np.where(valid, want, 0)
            np.testing.assert_array_equal(back.columns[name], want)
        np.testing.assert_array_equal(back.validities["small"], valid)
    assert PortTable.from_arrow(port.to_arrow()).num_rows == 10
    with pytest.raises(FileNotFoundError):
        PortTable.load_parquet(str(tmp_path / "missing.parquet"))
    with pytest.raises(TypeError):
        PortTable.from_arrow(None)
