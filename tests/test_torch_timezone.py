"""Time-zone functions of the port (utils/tz.py + functions/presto/tzfuncs.py)
against the JAX package's and an independent oracle (Python ``zoneinfo``):
the cases of ``tests/test_timezone.py`` across DST transitions, half-hour
zones and fixed offsets, on the same seeded instants.  Every result is an
integer and agrees exactly."""

import datetime
from zoneinfo import ZoneInfo

import numpy as np
import pytest

import velox_tpu as vt
from velox_tpu.exec.runner import LocalExecutor as RefExecutor
from velox_tpu.io.table import Table as RefTable
from velox_tpu.plan import PlanBuilder as RefBuilder
from velox_tpu_torch.exec.runner import LocalExecutor as PortExecutor
from velox_tpu_torch.plan import PlanBuilder as PortBuilder
from velox_tpu_torch.testing import assert_same_rows, table_from_numpy

US = 1_000_000


def _ts(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    # +-2000000000 s: 1906..2033, covering many DST eras
    return rng.integers(-2_000_000_000, 2_000_000_000, n) * np.int64(US)


def _run_both(cols, types, exprs, tile_rows=512):
    names = list(cols)
    port_t = table_from_numpy(names, types, cols)
    ref_t = RefTable(vt.RowType(names, [getattr(vt, t) for t in types]), dict(cols))
    got = PortExecutor(PortBuilder().table_scan(port_t).project(exprs).build(), tile_rows=tile_rows, device="cpu").run()
    want = RefExecutor(RefBuilder().table_scan(ref_t).project(exprs).build(), tile_rows=tile_rows).run()
    assert_same_rows(got, want)
    return got


def _oracle_offsets(ts_us, zone):
    out = []
    for t in ts_us:
        dt = datetime.datetime.fromtimestamp(int(t) // US, tz=datetime.timezone.utc)
        out.append(int(dt.astimezone(ZoneInfo(zone)).utcoffset().total_seconds()) * US)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("zone", ["America/New_York", "Asia/Kolkata", "Australia/Lord_Howe"])
def test_at_timezone_matches_zoneinfo(zone):
    ts = _ts()
    out = _run_both({"ts": ts}, ["TIMESTAMP"], [f"at_timezone(ts, '{zone}') as local"])
    np.testing.assert_array_equal(np.asarray(out.columns["local"]), ts + _oracle_offsets(ts, zone))


def test_to_utc_roundtrip():
    zone = "Europe/Berlin"
    ts = _ts(seed=9)
    out = _run_both({"ts": ts}, ["TIMESTAMP"], [f"to_utc(at_timezone(ts, '{zone}'), '{zone}') as back"])
    # spring-forward gaps / fall-back overlaps are the only legitimate
    # mismatches; they affect <2h per year around 02:00 local
    assert (np.asarray(out.columns["back"]) != ts).mean() < 0.002


def test_timezone_hour_minute():
    out = _run_both(
        {"ts": _ts(seed=4)}, ["TIMESTAMP"],
        [
            "timezone_hour(ts, 'Asia/Kolkata') as h", "timezone_minute(ts, 'Asia/Kolkata') as m",
            "timezone_hour(ts, '-08:00') as h2", "timezone_minute(ts, '-03:30') as m2",
            "timezone_hour(ts, 'UTC') as h3",
        ],
    )
    # Kolkata eras: LMT +5:53, Madras +5:21, war-time +6:30, modern +5:30
    assert set(np.asarray(out.columns["h"]).tolist()) <= {5, 6}
    assert set(np.asarray(out.columns["m"]).tolist()) <= {21, 30, 53}
    assert set(np.asarray(out.columns["h2"]).tolist()) == {-8}
    assert set(np.asarray(out.columns["m2"]).tolist()) == {-30}
    assert set(np.asarray(out.columns["h3"]).tolist()) == {0}


def test_hour_of_local_time_dst_boundary():
    """hour(at_timezone(...)) flips with DST like the reference's
    timestamp-with-timezone hour()."""
    # 2024-03-10 06:30 UTC == 01:30 EST; 07:30 UTC == 03:30 EDT (gap skips 2)
    vals = np.asarray(
        [
            int(datetime.datetime(2024, 3, 10, 6, 30, tzinfo=datetime.timezone.utc).timestamp()),
            int(datetime.datetime(2024, 3, 10, 7, 30, tzinfo=datetime.timezone.utc).timestamp()),
        ],
        np.int64,
    ) * US
    out = _run_both({"ts": vals}, ["TIMESTAMP"], ["hour(at_timezone(ts, 'America/New_York')) as h"])
    assert np.asarray(out.columns["h"]).tolist() == [1, 3]


def test_from_unixtime_with_zone():
    out = _run_both(
        {"x": np.asarray([1700000000, 0, -86400], np.int64)}, ["BIGINT"],
        ["hour(from_unixtime(x, 'Asia/Tokyo')) as h", "from_unixtime(x, '+05:30') as t"],
    )
    # 2023-11-14 22:13 UTC -> 07:13 JST
    assert np.asarray(out.columns["h"]).tolist() == [7, 9, 9]


def test_unknown_zone_raises():
    t = table_from_numpy(["ts"], ["TIMESTAMP"], {"ts": _ts(10)})
    with pytest.raises(ValueError, match="unknown timezone"):
        PortBuilder().table_scan(t).project(["at_timezone(ts, 'Mars/Olympus') as x"])


def test_zone_table_is_the_reference_table():
    """utils/tz.py is a copy: the same transitions and offsets for a zone."""
    from velox_tpu.utils import tz as ref_tz
    from velox_tpu_torch.utils import tz as port_tz

    for zone in ("America/New_York", "Asia/Kolkata", "+05:30", "UTC"):
        for a, b in zip(port_tz.zone_table(zone), ref_tz.zone_table(zone)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(port_tz.wall_to_utc_table(zone), ref_tz.wall_to_utc_table(zone)):
            np.testing.assert_array_equal(a, b)
