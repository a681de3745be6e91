"""Timezone scalar functions over the TZif tables (utils/tz.py).

Counterpart of the JAX package's ``functions/presto/tzfuncs.py``.  Reference:
velox/functions/prestosql/DateTimeFunctions.h — at_timezone,
from_unixtime(x, zone), timezone_hour, timezone_minute over type/tz/.

Zone names are bind-time literals (like date_trunc's unit): the binder
(expr/binding.py) validates the zone, bakes its transition table into a
dedicated registered function, and rewrites the call.  On the device the
function is one ``searchsorted`` + gather over the zone's small table, which
is uploaded once per device.

Engine deviation (documented, as in the JAX package): TIMESTAMP carries no
zone, so ``at_timezone(ts, z)`` yields the zone's wall-clock µs (its calendar
fields match the reference's timestamp-with-timezone), and ``to_utc(ts, z)``
is the inverse; ambiguous wall times resolve to the post-transition offset.
"""

from __future__ import annotations

import zlib

import torch

from ...dtypes import BIGINT, TIMESTAMP, TypeKind
from ...utils.tz import wall_to_utc_table, zone_table

_US_H = 3_600_000_000
_US_M = 60_000_000


def _zone_key(kind: str, zone: str) -> str:
    return f"__tz_{kind}_{zlib.crc32(zone.encode()):08x}"


def register_zone_fn(kind: str, zone: str) -> str:
    """Register (once) and return the zone-specialized function name.

    kinds: 'at' (UTC->wall), 'to_utc' (wall->UTC), 'hour', 'minute'
    (offset components at a UTC instant)."""
    from ...expr.registry import DEFAULT_REGISTRY as reg

    name = _zone_key(kind, zone)
    if reg.signatures(name):
        return name

    if kind == "to_utc":
        starts, offs = wall_to_utc_table(zone)
    else:
        starts, offs = zone_table(zone)  # validates the zone name
    on_device = {}

    def _offset_at(ts: torch.Tensor) -> torch.Tensor:
        if ts.device not in on_device:
            on_device[ts.device] = (
                torch.as_tensor(starts, device=ts.device),
                torch.as_tensor(offs, device=ts.device),
            )
        t, o = on_device[ts.device]
        pos = torch.searchsorted(t, ts.contiguous(), right=True) - 1
        return o.index_select(0, pos.clamp(0, len(offs) - 1).reshape(-1)).reshape(ts.shape)

    if kind == "at":
        impl = lambda ctx, out_t, arg_ts, ts: ts + _offset_at(ts)  # noqa: E731
        out = TIMESTAMP
    elif kind == "to_utc":
        impl = lambda ctx, out_t, arg_ts, ts: ts - _offset_at(ts)  # noqa: E731
        out = TIMESTAMP
    elif kind == "hour":
        impl = lambda ctx, out_t, arg_ts, ts: torch.div(  # noqa: E731
            _offset_at(ts), _US_H, rounding_mode="floor"
        )
        out = BIGINT
    elif kind == "minute":
        # minute component of the offset, sign-carrying like the reference
        def impl(ctx, out_t, arg_ts, ts):
            off = _offset_at(ts)
            minutes = torch.div(torch.remainder(off, _US_H), _US_M, rounding_mode="floor")
            return minutes * torch.where(off < 0, -1, 1)

        out = BIGINT
    else:
        raise ValueError(f"bad tz function kind {kind!r}")
    reg.register(name, [TypeKind.TIMESTAMP], out, impl)
    return name


def register_stubs():
    """Generic (unbound) signatures so the parser can type the calls before
    the binder dispatches the literal zone."""
    from ...expr.registry import DEFAULT_REGISTRY as reg, NUMERIC, STRINGY

    if reg.signatures("at_timezone"):
        return

    def _unbound(name):
        def impl(*a, **k):
            raise ValueError(
                f"{name}() requires a literal zone string (bound at plan "
                "time, expr/binding.py)"
            )

        return impl

    reg.register(
        "at_timezone", [TypeKind.TIMESTAMP, STRINGY], TIMESTAMP,
        _unbound("at_timezone"),
    )
    reg.register(
        "to_utc", [TypeKind.TIMESTAMP, STRINGY], TIMESTAMP, _unbound("to_utc")
    )
    reg.register(
        "timezone_hour", [TypeKind.TIMESTAMP, STRINGY], BIGINT,
        _unbound("timezone_hour"),
    )
    reg.register(
        "timezone_minute", [TypeKind.TIMESTAMP, STRINGY], BIGINT,
        _unbound("timezone_minute"),
    )
    reg.register(
        "from_unixtime", [NUMERIC, STRINGY], TIMESTAMP,
        _unbound("from_unixtime"),
    )
