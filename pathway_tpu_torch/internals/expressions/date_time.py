"""``expr.dt.*`` datetime method namespace.

Parity target: ``python/pathway/internals/expressions/date_time.py``.
DateTimeNaive is a tz-naive ``datetime.datetime``; DateTimeUtc is tz-aware;
Duration is ``datetime.timedelta`` — same user-visible model as the reference.
"""

from __future__ import annotations

import datetime
from zoneinfo import ZoneInfo

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ColumnExpression, MethodCallExpression

_UTC = datetime.timezone.utc


def _strptime_impl(s: str, fmt: str) -> datetime.datetime:
    return datetime.datetime.strptime(s, fmt)


def _round_dt(value: datetime.datetime, duration: datetime.timedelta) -> datetime.datetime:
    epoch = (
        datetime.datetime(1970, 1, 1, tzinfo=value.tzinfo)
        if value.tzinfo
        else datetime.datetime(1970, 1, 1)
    )
    total = (value - epoch).total_seconds()
    step = duration.total_seconds()
    rounded = round(total / step) * step
    return epoch + datetime.timedelta(seconds=rounded)


def _floor_dt(value: datetime.datetime, duration: datetime.timedelta) -> datetime.datetime:
    epoch = (
        datetime.datetime(1970, 1, 1, tzinfo=value.tzinfo)
        if value.tzinfo
        else datetime.datetime(1970, 1, 1)
    )
    total = (value - epoch).total_seconds()
    step = duration.total_seconds()
    floored = (total // step) * step
    return epoch + datetime.timedelta(seconds=floored)


def _as_duration(d) -> datetime.timedelta:
    if isinstance(d, datetime.timedelta):
        return d
    raise TypeError(f"expected Duration, got {type(d)}")


class DateTimeNamespace:
    r"""``col.dt`` — datetime operations on column expressions.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('ts\n2024-03-01T10:30:00')
    >>> r = t.select(
    ...     d=pw.this.ts.dt.strptime('%Y-%m-%dT%H:%M:%S').dt.strftime('%d.%m.%Y'),
    ... )
    >>> pw.debug.compute_and_print(r, include_id=False)
    d
    01.03.2024
    """
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def _m(self, name, fun, ret, *args, **kwargs):
        return MethodCallExpression(f"dt.{name}", fun, ret, [self._expr, *args], kwargs)

    # field extraction
    def year(self):
        return self._m("year", lambda v: v.year, dt.INT)

    def month(self):
        return self._m("month", lambda v: v.month, dt.INT)

    def day(self):
        return self._m("day", lambda v: v.day, dt.INT)

    def hour(self):
        return self._m("hour", lambda v: v.hour, dt.INT)

    def minute(self):
        return self._m("minute", lambda v: v.minute, dt.INT)

    def second(self):
        return self._m("second", lambda v: v.second, dt.INT)

    def millisecond(self):
        return self._m("millisecond", lambda v: v.microsecond // 1000, dt.INT)

    def microsecond(self):
        return self._m("microsecond", lambda v: v.microsecond, dt.INT)

    def nanosecond(self):
        return self._m("nanosecond", lambda v: v.microsecond * 1000, dt.INT)

    def weekday(self):
        return self._m("weekday", lambda v: v.weekday(), dt.INT)

    # timestamps
    def timestamp(self, unit: str = "ns"):
        mult = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}[unit]

        def impl(v):
            if v.tzinfo is None:
                base = v.replace(tzinfo=_UTC)
            else:
                base = v
            return base.timestamp() * mult

        return self._m("timestamp", impl, dt.FLOAT)

    def from_timestamp(self, unit: str = "s"):
        div = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}[unit]
        return self._m(
            "from_timestamp",
            lambda v: datetime.datetime.utcfromtimestamp(v / div),
            dt.DATE_TIME_NAIVE,
        )

    def utc_from_timestamp(self, unit: str = "s"):
        div = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}[unit]
        return self._m(
            "utc_from_timestamp",
            lambda v: datetime.datetime.fromtimestamp(v / div, tz=_UTC),
            dt.DATE_TIME_UTC,
        )

    # formatting / parsing
    def strftime(self, fmt):
        return self._m("strftime", lambda v, f: v.strftime(f), dt.STR, fmt)

    def strptime(self, fmt, contains_timezone: bool | None = None):
        ret = dt.DATE_TIME_UTC if contains_timezone else dt.DATE_TIME_NAIVE
        return self._m("strptime", _strptime_impl, ret, fmt)

    # tz conversions
    def to_utc(self, from_timezone: str):
        tz = ZoneInfo(from_timezone)
        return self._m(
            "to_utc",
            lambda v: v.replace(tzinfo=tz).astimezone(_UTC),
            dt.DATE_TIME_UTC,
        )

    def to_naive_in_timezone(self, timezone: str):
        tz = ZoneInfo(timezone)
        return self._m(
            "to_naive_in_timezone",
            lambda v: v.astimezone(tz).replace(tzinfo=None),
            dt.DATE_TIME_NAIVE,
        )

    # rounding
    def round(self, duration):
        return self._m(
            "round",
            lambda v, d: _round_dt(v, _as_duration(d)),
            lambda ts: ts[0],
            duration,
        )

    def floor(self, duration):
        return self._m(
            "floor",
            lambda v, d: _floor_dt(v, _as_duration(d)),
            lambda ts: ts[0],
            duration,
        )

    # duration decomposition
    def nanoseconds(self):
        return self._m("nanoseconds", lambda v: int(v.total_seconds() * 1e9), dt.INT)

    def microseconds(self):
        return self._m("microseconds", lambda v: int(v.total_seconds() * 1e6), dt.INT)

    def milliseconds(self):
        return self._m("milliseconds", lambda v: int(v.total_seconds() * 1e3), dt.INT)

    def seconds(self):
        return self._m("seconds", lambda v: int(v.total_seconds()), dt.INT)

    def minutes(self):
        return self._m("minutes", lambda v: int(v.total_seconds() // 60), dt.INT)

    def hours(self):
        return self._m("hours", lambda v: int(v.total_seconds() // 3600), dt.INT)

    def days(self):
        return self._m("days", lambda v: v.days, dt.INT)

    def weeks(self):
        return self._m("weeks", lambda v: v.days // 7, dt.INT)
