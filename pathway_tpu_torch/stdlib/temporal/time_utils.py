"""Temporal time utilities: a live UTC clock stream and inactivity alerts.

Parity target: ``python/pathway/stdlib/temporal/time_utils.py``
(``utc_now`` clock source, ``inactivity_detection`` alert pattern).
"""

from __future__ import annotations

import datetime
import time
from functools import cache

import pathway_tpu_torch as pw
from pathway_tpu_torch import io


class TimestampSchema(pw.Schema):
    timestamp_utc: pw.DateTimeUtc


class TimestampSubject(io.python.ConnectorSubject):
    """Emits the current UTC time every ``refresh_rate`` (never finishes)."""

    def __init__(self, refresh_rate: datetime.timedelta) -> None:
        super().__init__()
        self._refresh_rate = refresh_rate

    def run(self) -> None:
        while True:
            now_utc = datetime.datetime.now(datetime.timezone.utc)
            self.next(timestamp_utc=now_utc)
            self.commit()
            time.sleep(self._refresh_rate.total_seconds())


@cache
def utc_now(refresh_rate: datetime.timedelta = datetime.timedelta(seconds=60)):
    """A continuously updating stream of the current UTC time (cached per
    refresh rate, like the reference — one clock per rate per process)."""
    return io.python.read(
        TimestampSubject(refresh_rate=refresh_rate),
        schema=TimestampSchema,
    )


def inactivity_detection(
    event_time_column,
    allowed_inactivity_period,
    refresh_rate: datetime.timedelta = datetime.timedelta(seconds=1),
    instance=None,
):
    """(inactivities, resumed_activities) alert tables for a stream whose
    ``event_time_column`` carries UTC timestamps: an inactivity row appears
    when no event lands within ``allowed_inactivity_period``; a resumed row
    carries the first event after each gap.  Assumes event timestamps track
    current UTC and system latency << the allowed period (reference
    time_utils.py:52)."""
    events_t = event_time_column.table.select(
        t=event_time_column, instance=instance
    )

    now_t = utc_now(refresh_rate=refresh_rate)
    latest_t = (
        events_t.groupby(pw.this.instance)
        .reduce(pw.this.instance, latest_t=pw.reducers.max(pw.this.t))
        .filter(
            pw.this.latest_t > datetime.datetime.now(datetime.timezone.utc)
        )  # avoid alerts while backfilling history
    )
    inactivities = (
        now_t.asof_now_join(latest_t)
        .select(pw.left.timestamp_utc, pw.right.instance, pw.right.latest_t)
        .filter(pw.this.latest_t + allowed_inactivity_period < pw.this.timestamp_utc)
        .groupby(pw.this.latest_t, pw.this.instance)
        .reduce(pw.this.latest_t, pw.this.instance)
        .select(instance=pw.this.instance, inactive_t=pw.this.latest_t)
    )

    latest_inactivity = inactivities.groupby(pw.this.instance).reduce(
        pw.this.instance, inactive_t=pw.reducers.latest(pw.this.inactive_t)
    )
    resumed_activities = (
        events_t.asof_now_join(
            latest_inactivity, events_t.instance == latest_inactivity.instance
        )
        .select(pw.left.t, pw.left.instance, pw.right.inactive_t)
        .groupby(pw.this.inactive_t, pw.this.instance)
        .reduce(pw.this.instance, resumed_t=pw.reducers.min(pw.this.t))
    )
    if instance is None:
        inactivities = inactivities.without(pw.this.instance)
        resumed_activities = resumed_activities.without(pw.this.instance)
    return inactivities, resumed_activities
