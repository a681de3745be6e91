"""Timezone database: TZif transition tables for device-side zone math.

Reference: velox/type/tz/ — TimeZoneMap.h (zone name -> id), TimeZoneInfo
(transition list + offsets), used by at_timezone / from_unixtime(…, zone) /
timezone_hour (functions/prestosql/DateTimeFunctions.h).

A copy of the JAX package's ``utils/tz.py`` (numpy only, kept here so that
this package imports nothing of it).  A zone's entire history is two sorted
int64 arrays (UTC transition instants in µs, offsets in µs).  Converting a
timestamp column is then one ``searchsorted`` + gather on the device
(functions/presto/tzfuncs.py) — no per-row host logic.  Tables parse
straight from the system TZif files (RFC 8536) under ``zoneinfo.TZPATH``
and are cached per zone; fixed-offset spellings ("+05:30", "-08:00",
"UTC") bypass the file entirely.

The engine's TIMESTAMP carries no zone (int64 µs since epoch, UTC).
``at_timezone(ts, zone)`` therefore returns the zone's WALL-CLOCK µs — the
value whose calendar fields (hour(), date_trunc(), …) equal the reference's
timestamp-with-timezone rendering; ``to_utc(ts, zone)`` is the inverse
(ambiguous/skipped wall times resolve to the earliest offset, like the
reference's tz::local_time -> sys_time choice).
"""

from __future__ import annotations

import functools
import os
import re
import struct
from typing import Tuple

import numpy as np

_US = 1_000_000
_FIXED_RE = re.compile(r"^([+-])(\d{2}):?(\d{2})$")


def _tzfile_bytes(zone: str) -> bytes:
    if "/" in zone and ".." in zone:
        raise ValueError(f"bad zone name {zone!r}")
    import zoneinfo

    for root in zoneinfo.TZPATH:
        path = os.path.join(root, zone)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return f.read()
    try:  # pip tzdata package fallback
        import importlib.resources as res

        pkg = "tzdata.zoneinfo." + ".".join(zone.split("/")[:-1])
        name = zone.split("/")[-1]
        return (res.files(pkg.rstrip(".")) / name).read_bytes()
    except Exception:
        raise ValueError(f"unknown timezone {zone!r}") from None


def _parse_tzif(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """RFC 8536 TZif -> (transition instants [s], utc offsets [s]).

    Prefers the 64-bit v2+ block; the leading offset (pre-first-transition)
    rides as a sentinel transition at INT64_MIN."""

    def parse_block(buf, off, time_size, time_fmt):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt) = struct.unpack(
            ">6I", buf[off + 20 : off + 44]
        )
        p = off + 44
        times = np.frombuffer(buf, dtype=time_fmt, count=timecnt, offset=p)
        p += timecnt * time_size
        idx = np.frombuffer(buf, dtype=np.uint8, count=timecnt, offset=p)
        p += timecnt
        ttinfo = []
        for i in range(typecnt):
            utoff, isdst, abbrind = struct.unpack(">iBB", buf[p : p + 6])
            ttinfo.append(utoff)
            p += 6
        p += charcnt + leapcnt * (time_size + 4) + isstdcnt + isutcnt
        return times.astype(np.int64), np.asarray(ttinfo, np.int64), idx, p

    assert data[:4] == b"TZif", "not a TZif file"
    version = data[4:5]
    times, offs, idx, end = parse_block(data, 0, 4, ">i4")
    if version in (b"2", b"3", b"4"):
        # the v1 block is followed by a v2 64-bit block
        times, offs, idx, _ = parse_block(data, end, 8, ">i8")
    if len(times):
        first_type = 0  # RFC: the type of the era before the first transition
        transitions = np.concatenate(
            [np.asarray([np.iinfo(np.int64).min // 2], np.int64), times]
        )
        offsets = np.concatenate(
            [offs[first_type : first_type + 1], offs[idx.astype(np.int64)]]
        )
    else:
        transitions = np.asarray([np.iinfo(np.int64).min // 2], np.int64)
        offsets = offs[:1] if len(offs) else np.zeros(1, np.int64)
    return transitions, offsets


@functools.lru_cache(maxsize=256)
def zone_table(zone: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transition instants µs, utc offsets µs) for a zone name, cached.

    Accepts IANA names, 'UTC', and fixed offsets like '+05:30'/'-0800'."""
    if zone.upper() in ("UTC", "GMT", "Z", "UT"):
        return (
            np.asarray([np.iinfo(np.int64).min // 2], np.int64),
            np.zeros(1, np.int64),
        )
    m = _FIXED_RE.match(zone)
    if m:
        sign = 1 if m.group(1) == "+" else -1
        off = sign * (int(m.group(2)) * 3600 + int(m.group(3)) * 60)
        return (
            np.asarray([np.iinfo(np.int64).min // 2], np.int64),
            np.asarray([off * _US], np.int64),
        )
    transitions, offsets = _parse_tzif(_tzfile_bytes(zone))
    # clip sentinel / "big bang" transitions before scaling to µs: the
    # INT64_MIN//2 sentinel (and some zones' -2^59 first transition) would
    # overflow int64 under the *1e6
    lim = np.iinfo(np.int64).max // (2 * _US)
    transitions = np.clip(transitions, -lim, lim) * _US
    return transitions, offsets * _US


def offsets_at_np(ts_us: np.ndarray, zone: str) -> np.ndarray:
    """Host-side UTC offset (µs) of each instant — the numpy oracle of the
    device-side searchsorted+gather."""
    transitions, offsets = zone_table(zone)
    pos = np.searchsorted(transitions, ts_us, side="right") - 1
    return offsets[np.clip(pos, 0, len(offsets) - 1)]


def wall_to_utc_table(zone: str) -> Tuple[np.ndarray, np.ndarray]:
    """Transition table keyed by WALL time for the inverse conversion.

    Each UTC transition instant t with new offset o starts a wall-time era at
    t + o.  Ambiguous wall times (fall-back overlap) resolve to the era that
    began earlier being shadowed — i.e. the LATEST era whose start <= wall,
    matching Presto's choice of the post-transition offset; skipped wall
    times (spring-forward gap) map through the post-transition offset."""
    transitions, offsets = zone_table(zone)
    starts = transitions + offsets
    order = np.argsort(starts, kind="stable")
    return starts[order], offsets[order]
