"""Windows + ``windowby`` (parity: stdlib/temporal/_window.py:588-855).

Window assignment is a flatten (each row → its window instances) followed by
an incremental groupby on ``(instance, window_start, window_end)``; session
windows merge chains of rows within ``max_gap`` per instance (recomputed per
touched instance per epoch — the reference's session logic in
``time_column.rs`` is likewise instance-scoped).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnReference
from pathway_tpu_torch.internals.table import GroupedTable, Table
from pathway_tpu_torch.internals.thisclass import this
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
    Behavior,
    CommonBehavior,
    ExactlyOnceBehavior,
)


class Window:
    def _assign(self, t: Any) -> list[tuple[Any, Any]]:
        """Return the list of (window_start, window_end) containing time t."""
        raise NotImplementedError


def _zero_like(duration):
    if isinstance(duration, datetime.timedelta):
        return datetime.timedelta(0)
    return 0


@dataclasses.dataclass(frozen=True)
class TumblingWindow(Window):
    duration: Any
    origin: Any = None
    shift: Any = None

    def _assign(self, t):
        origin = self.origin
        if origin is None:
            origin = _zero_like(self.duration) if not isinstance(t, datetime.datetime) else datetime.datetime(1970, 1, 1, tzinfo=t.tzinfo)
        offset = t - origin
        n = offset // self.duration
        start = origin + n * self.duration
        if start > t:  # floor for negatives with timedelta arithmetic
            start = start - self.duration
        return [(start, start + self.duration)]


@dataclasses.dataclass(frozen=True)
class SlidingWindow(Window):
    hop: Any
    duration: Any
    origin: Any = None

    def _assign(self, t):
        origin = self.origin
        if origin is None:
            origin = _zero_like(self.hop) if not isinstance(t, datetime.datetime) else datetime.datetime(1970, 1, 1, tzinfo=t.tzinfo)
        out = []
        # windows [origin + k*hop, origin + k*hop + duration) containing t
        offset = t - origin
        k_max = offset // self.hop
        k = k_max
        while True:
            start = origin + k * self.hop
            if start > t:
                k -= 1
                continue
            if start + self.duration <= t:
                break
            out.append((start, start + self.duration))
            k -= 1
        out.reverse()
        return out


@dataclasses.dataclass(frozen=True)
class SessionWindow(Window):
    predicate: Callable[[Any, Any], bool] | None = None
    max_gap: Any = None

    def merges(self, a, b) -> bool:
        if self.predicate is not None:
            return bool(self.predicate(a, b))
        return (b - a) <= self.max_gap


@dataclasses.dataclass(frozen=True)
class IntervalsOverWindow(Window):
    at: Any  # ColumnReference into a times table
    lower_bound: Any = None
    upper_bound: Any = None
    is_outer: bool = True


def tumbling(duration, origin=None, shift=None) -> TumblingWindow:
    r"""Fixed-size non-overlapping event-time windows.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('at | v\n1 | 10\n3 | 20\n7 | 30')
    >>> r = t.windowby(pw.this.at, window=pw.temporal.tumbling(duration=5)).reduce(
    ...     start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v)
    ... )
    >>> pw.debug.compute_and_print(r, include_id=False)
    start | total
    0     | 30
    5     | 30
    """
    if shift is not None:
        return SlidingWindow(hop=shift, duration=duration, origin=origin)
    return TumblingWindow(duration=duration, origin=origin)


def sliding(hop, duration=None, ratio=None, origin=None) -> SlidingWindow:
    r"""Overlapping windows of ``duration`` starting every ``hop``.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('at\n4\n6')
    >>> r = t.windowby(pw.this.at, window=pw.temporal.sliding(hop=5, duration=10)).reduce(
    ...     start=pw.this._pw_window_start, n=pw.reducers.count()
    ... )
    >>> pw.debug.compute_and_print(r, include_id=False)
    start | n
    -5    | 1
    0     | 2
    5     | 1
    """
    if duration is None and ratio is not None:
        duration = hop * ratio
    return SlidingWindow(hop=hop, duration=duration, origin=origin)


def session(*, predicate=None, max_gap=None) -> SessionWindow:
    r"""Windows that merge events closer than ``max_gap`` (or by ``predicate``).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('at\n1\n2\n10')
    >>> r = t.windowby(pw.this.at, window=pw.temporal.session(max_gap=3)).reduce(
    ...     n=pw.reducers.count()
    ... )
    >>> pw.debug.compute_and_print(r, include_id=False)
    n
    1
    2
    """
    if (predicate is None) == (max_gap is None):
        raise ValueError("session window needs exactly one of predicate/max_gap")
    return SessionWindow(predicate=predicate, max_gap=max_gap)


def intervals_over(*, at, lower_bound=None, upper_bound=None, is_outer: bool = True) -> IntervalsOverWindow:
    return IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


class WindowGroupedTable:
    """Result of windowby; reduce() closes over (instance, start, end) groups."""

    def __init__(self, assigned: Table, has_instance: bool, outer_info=None):
        self._assigned = assigned
        self._has_instance = has_instance
        # intervals_over(is_outer=True): (times_table, lb, ub) — empty
        # intervals still emit their at-point with None reduced values
        self._outer_info = outer_info

    def reduce(self, *args, **kwargs) -> Table:
        grouping = [
            ColumnReference(this, "_pw_window"),
            ColumnReference(this, "_pw_window_start"),
            ColumnReference(this, "_pw_window_end"),
        ]
        if self._has_instance:
            grouping.append(ColumnReference(this, "_pw_instance"))
        inner = self._assigned.groupby(*grouping).reduce(*args, **kwargs)
        if self._outer_info is None:
            return inner
        return self._pad_empty_intervals(inner, args, kwargs)

    def _pad_empty_intervals(self, inner: Table, args, kwargs) -> Table:
        """Anchors with no rows in their interval appear with None in every
        non-group column (reference intervals_over is_outer=True)."""
        times_table, lb, ub = self._outer_info
        at = ColumnReference(this, "_pw_at")
        pad = times_table.select(
            _pw_window=at,
            _pw_window_start=(at + lb) if lb is not None else at,
            _pw_window_end=(at + ub) if ub is not None else at,
        )
        # key pads exactly like the groupby keys its outputs: the hash of
        # the grouping tuple, in grouping order
        pad = pad.with_id_from(
            ColumnReference(this, "_pw_window"),
            ColumnReference(this, "_pw_window_start"),
            ColumnReference(this, "_pw_window_end"),
        )
        named: dict[str, Any] = {}
        for a in args:
            named[a.name] = a
        named.update(kwargs)
        out_cols: dict[str, Any] = {}
        for name, e in named.items():
            if isinstance(e, ColumnReference) and e.name in (
                "_pw_window",
                "_pw_window_start",
                "_pw_window_end",
            ):
                out_cols[name] = ColumnReference(this, e.name)
            else:
                out_cols[name] = expr_mod.ColumnConstExpression(None)
        padded = pad.select(**out_cols)
        missing = padded.difference(inner)
        return inner.concat(missing)


def windowby(
    table: Table,
    time_expr,
    *,
    window: Window,
    behavior: Behavior | None = None,
    instance=None,
    origin=None,
) -> WindowGroupedTable:
    if isinstance(window, SessionWindow):
        assigned = _assign_sessions(table, time_expr, window, instance)
        if behavior is not None:
            assigned = _apply_behavior(assigned, behavior)
    elif isinstance(window, IntervalsOverWindow):
        times_table = window.at.table.select(_pw_at=window.at)
        assigned = _assign_intervals_over(
            table, time_expr, window, instance, times_table
        )
        if behavior is not None:
            assigned = _apply_behavior(assigned, behavior)
        # outer padding caveats: with instance= the pad keys could not
        # match the (window, ..., instance) group keys (phantom pads for
        # every anchor); with keep_results=False a forgotten window would
        # be resurrected as an empty pad.  Both combinations skip padding.
        forgets = (
            isinstance(behavior, CommonBehavior) and not behavior.keep_results
        )
        if window.is_outer and instance is None and not forgets:
            outer_info = (
                times_table,
                window.lower_bound,
                window.upper_bound,
            )
            return WindowGroupedTable(
                assigned, has_instance=instance is not None,
                outer_info=outer_info,
            )
    else:
        win = window
        if _sliding_vectorizable(table, time_expr, win):
            # duration = m·hop over an int time column: every row is in
            # EXACTLY m windows, so the assignment becomes m fully
            # columnar branches (arithmetic starts, make_tuple windows),
            # each injectively rekeyed (native salted hash) and
            # concatenated — no per-row _assign, no flatten
            origin = 0 if win.origin is None else win.origin
            hop, duration = win.hop, win.duration
            m = duration // hop

            def base_of():
                return ((time_expr - origin) // hop) * hop + origin

            branches = []
            for j in range(m):
                # ascending starts, like _assign's reversed output
                shift = (m - 1 - j) * hop
                start = base_of() - shift
                cols = {
                    "_pw_time": time_expr,
                    "_pw_window_start": start,
                    "_pw_window_end": start + duration,
                    "_pw_window": expr_mod.MakeTupleExpression(
                        start, start + duration
                    ),
                }
                if instance is not None:
                    cols["_pw_instance"] = instance
                b = table.with_columns(**cols)
                if m > 1:  # rekey exists only to keep concat branches disjoint
                    b = b._rekey_salted(j)
                branches.append(b)
            assigned = branches[0].concat(*branches[1:]) if m > 1 else branches[0]
            if behavior is not None:
                assigned = _apply_behavior(assigned, behavior)
            return WindowGroupedTable(assigned, has_instance=instance is not None)
        if _tumbling_vectorizable(table, time_expr, win):
            # tumbling over a non-optional int column assigns EXACTLY one
            # window per row via plain arithmetic: the start/end columns
            # compile onto the columnar path (no per-row _assign call, no
            # flatten), and the multi-key columnar groupby reduces them.
            # Python // floors, matching _assign's floor for negatives.
            origin = win.duration * 0 if win.origin is None else win.origin
            d = win.duration

            def start_of():
                return ((time_expr - origin) // d) * d + origin

            cols = {
                "_pw_time": time_expr,
                "_pw_window_start": start_of(),
                "_pw_window_end": start_of() + d,
                # the window value is the (start, end) pair, as on the
                # flatten path; make_tuple compiles columnar
                "_pw_window": expr_mod.MakeTupleExpression(
                    start_of(), start_of() + d
                ),
            }
            if instance is not None:
                cols["_pw_instance"] = instance
            assigned = table.with_columns(**cols)
            if behavior is not None:
                assigned = _apply_behavior(assigned, behavior)
            return WindowGroupedTable(assigned, has_instance=instance is not None)

        def windows_of(t):
            if t is None:
                return ()
            return tuple(
                (s, e) for (s, e) in win._assign(t)
            )

        with_windows = table.with_columns(
            _pw_windows=ApplyExpression(windows_of, None, time_expr),
            _pw_time=time_expr,
        )
        if instance is not None:
            with_windows = with_windows.with_columns(_pw_instance=instance)
        flat = with_windows.flatten(ColumnReference(this, "_pw_windows"))
        assigned = flat.with_columns(
            _pw_window=ColumnReference(this, "_pw_windows"),
            _pw_window_start=ApplyExpression(
                lambda w: w[0], None, ColumnReference(this, "_pw_windows")
            ),
            _pw_window_end=ApplyExpression(
                lambda w: w[1], None, ColumnReference(this, "_pw_windows")
            ),
        )
        if behavior is not None:
            assigned = _apply_behavior(assigned, behavior)
    return WindowGroupedTable(assigned, has_instance=instance is not None)


def _sliding_vectorizable(table: Table, time_expr, win) -> bool:
    """Sliding fast path: int time column, int hop/duration with duration
    an exact multiple of hop (constant windows-per-row), int origin."""
    if not isinstance(win, SlidingWindow):
        return False
    if not (isinstance(win.hop, int) and isinstance(win.duration, int)):
        return False
    if win.hop <= 0 or win.duration <= 0 or win.duration % win.hop != 0:
        return False
    if win.origin is not None and not isinstance(win.origin, int):
        return False
    return _int_time_column(table, time_expr)


def _int_time_column(table: Table, time_expr) -> bool:
    from pathway_tpu_torch.internals import dtype as dt
    from pathway_tpu_torch.internals.thisclass import ThisPlaceholder

    if not isinstance(time_expr, ColumnReference):
        return False
    tbl = time_expr.table
    if isinstance(tbl, ThisPlaceholder):
        tbl = table
    sch = getattr(tbl, "schema", None)
    col = sch.__columns__.get(time_expr.name) if sch is not None else None
    return col is not None and col.dtype is dt.INT


def _tumbling_vectorizable(table: Table, time_expr, win) -> bool:
    """The arithmetic fast path is exact only for non-optional int time
    columns with int duration/origin (float times keep float // float
    quirks on the row path; None times must drop the row, which the
    windows_of path does and arithmetic cannot)."""
    if not isinstance(win, TumblingWindow):
        return False
    if not isinstance(win.duration, int) or win.duration == 0:
        return False
    if win.origin is not None and not isinstance(win.origin, int):
        return False
    return _int_time_column(table, time_expr)


def _apply_behavior(assigned: Table, behavior: Behavior) -> Table:
    time_col = ColumnReference(this, "_pw_time")
    if isinstance(behavior, CommonBehavior):
        t = assigned
        if behavior.delay is not None:
            t = t._buffer(time_col + behavior.delay, time_col)
        if behavior.cutoff is not None:
            end_col = ColumnReference(this, "_pw_window_end")
            t = t._freeze(end_col + behavior.cutoff, time_col)
            if not behavior.keep_results:
                # closed windows are dropped from the output entirely
                # (reference CommonBehavior keep_results=False: the Forget
                # operator retracts rows once the watermark passes cutoff)
                t = t._forget(end_col + behavior.cutoff, time_col)
        return t
    if isinstance(behavior, ExactlyOnceBehavior):
        end_col = ColumnReference(this, "_pw_window_end")
        shift = behavior.shift
        thr = end_col + shift if shift is not None else end_col
        t = assigned._buffer(thr, time_col)
        t = t._freeze(thr, time_col)
        return t
    return assigned


def _sessions_of_loop(win: SessionWindow, times_tuple) -> tuple:
    """Reference per-pair merge loop — the semantics oracle for the
    vectorized gap path, and the only option for custom predicates."""
    times = sorted(times_tuple)
    out = []
    cur_start = None
    prev = None
    for t in times:
        if cur_start is None:
            cur_start = t
        elif not win.merges(prev, t):
            out.append((cur_start, prev))
            cur_start = t
        prev = t
    if cur_start is not None:
        out.append((cur_start, prev))
    return tuple(out)


def _session_gap_vectorizable(table: Table, time_expr, win: SessionWindow) -> bool:
    """Gap-based session fast path: int max_gap over a non-optional int
    time column — the merge test is exact int64 arithmetic.  Float/
    datetime gaps keep the reference loop (Python comparison semantics),
    like the tumbling/sliding gates above."""
    if not isinstance(win.max_gap, int):
        return False
    if not -(2**63) <= win.max_gap < 2**63:
        return False  # bignum gap: numpy comparison would not be exact
    return _int_time_column(table, time_expr)


def _assign_sessions(table: Table, time_expr, window: SessionWindow, instance) -> Table:
    """Sessionization: group rows per instance, merge chains via the window
    predicate, emit (start, end) per session.  Incremental at instance
    granularity via groupby+sorted_tuple then flatten."""
    from pathway_tpu_torch.internals import reducers

    base = table.with_columns(_pw_time=time_expr)
    if instance is not None:
        base = base.with_columns(_pw_instance=instance)
    else:
        base = base.with_columns(_pw_instance=expr_mod.ColumnConstExpression(0))

    from pathway_tpu_torch.internals import vector_compiler as vc

    win = window

    if (
        vc.ENABLED
        and win.predicate is None
        and _session_gap_vectorizable(table, time_expr, win)
    ):
        # gap-based sessions over an int time column: the merge decision
        # is pure arithmetic (gap = t[i] - t[i-1] <= max_gap), so the
        # per-instance chain merge becomes one numpy diff + boundary
        # split instead of a Python loop over every event — the columnar
        # form of the reference's instance-scoped session recompute
        gap = win.max_gap

        def sessions_of(times_tuple):
            import numpy as np

            if not times_tuple:
                return ()
            times = np.sort(np.asarray(times_tuple, dtype=np.int64))
            if int(times[-1]) - int(times[0]) > 2**63 - 1:
                # int64 diff would wrap; the reference loop uses Python
                # bignums and stays exact
                return _sessions_of_loop(win, times_tuple)
            breaks = np.flatnonzero(np.diff(times) > gap)
            starts = times[np.concatenate(([0], breaks + 1))]
            ends = times[np.concatenate((breaks, [times.size - 1]))]
            return tuple(zip(starts.tolist(), ends.tolist()))
    else:
        if vc.ENABLED and win.predicate is not None:
            # a custom merge predicate is opaque Python — it must run
            # per adjacent pair, so this assignment cannot vectorize.
            # Classified under its own reason so `pathway_tpu_torch top` and
            # profiler snapshots attribute the row-speed cost to the
            # predicate, not to a missing fast path.
            vc.note_bail("session", "predicate-merge")
        elif vc.ENABLED:
            # max_gap over a non-int time column (float/datetime):
            # arithmetic exactness isn't guaranteed columnar, keep the
            # reference loop and say why
            vc.note_bail("session", "time-dtype")

        def sessions_of(times_tuple):
            return _sessions_of_loop(win, times_tuple)

    # session boundaries per instance
    sessions = base.groupby(ColumnReference(this, "_pw_instance")).reduce(
        _pw_instance=ColumnReference(this, "_pw_instance"),
        _pw_sessions=ApplyExpression(
            sessions_of, None, reducers.sorted_tuple(ColumnReference(this, "_pw_time"))
        ),
    )
    sess_flat = sessions.flatten(ColumnReference(this, "_pw_sessions"))
    sess_flat = sess_flat.with_columns(
        _pw_window_start=ApplyExpression(
            lambda w: w[0], None, ColumnReference(this, "_pw_sessions")
        ),
        _pw_window_end=ApplyExpression(
            lambda w: w[1], None, ColumnReference(this, "_pw_sessions")
        ),
    )
    # join rows back onto their session: time in [start, end]
    from pathway_tpu_torch.internals.thisclass import left as left_ph, right as right_ph

    jr = base.join(
        sess_flat,
        expr_mod.ColumnBinaryOpExpression(
            "==",
            ColumnReference(left_ph, "_pw_instance"),
            ColumnReference(right_ph, "_pw_instance"),
        ),
    )
    cols = {n: ColumnReference(left_ph, n) for n in table.column_names()}
    cols["_pw_time"] = ColumnReference(left_ph, "_pw_time")
    cols["_pw_instance"] = ColumnReference(left_ph, "_pw_instance")
    cols["_pw_window_start"] = ColumnReference(right_ph, "_pw_window_start")
    cols["_pw_window_end"] = ColumnReference(right_ph, "_pw_window_end")
    cols["_pw_window"] = expr_mod.make_tuple(
        ColumnReference(right_ph, "_pw_window_start"),
        ColumnReference(right_ph, "_pw_window_end"),
    )
    joined = jr.select(**cols)
    return joined.filter(
        (ColumnReference(this, "_pw_time") >= ColumnReference(this, "_pw_window_start"))
        & (ColumnReference(this, "_pw_time") <= ColumnReference(this, "_pw_window_end"))
    )


def _assign_intervals_over(
    table: Table, time_expr, window: IntervalsOverWindow, instance, times_table: Table
) -> Table:
    """intervals_over: windows centered at each value of ``window.at``."""
    from pathway_tpu_torch.internals.thisclass import left as left_ph, right as right_ph

    base = table.with_columns(_pw_time=time_expr)
    if instance is not None:
        base = base.with_columns(_pw_instance=instance)
    else:
        base = base.with_columns(_pw_instance=expr_mod.ColumnConstExpression(0))
    # cross join rows x window anchors (filtered by interval containment)
    jr = base.join(
        times_table,
        expr_mod.ColumnBinaryOpExpression(
            "==",
            expr_mod.ColumnConstExpression(0),
            expr_mod.ColumnConstExpression(0),
        ),
    )
    lb, ub = window.lower_bound, window.upper_bound
    cols = {n: ColumnReference(left_ph, n) for n in table.column_names()}
    cols["_pw_time"] = ColumnReference(left_ph, "_pw_time")
    cols["_pw_instance"] = ColumnReference(left_ph, "_pw_instance")
    cols["_pw_window_start"] = (
        ColumnReference(right_ph, "_pw_at") + lb
        if lb is not None
        else ColumnReference(right_ph, "_pw_at")
    )
    cols["_pw_window_end"] = (
        ColumnReference(right_ph, "_pw_at") + ub
        if ub is not None
        else ColumnReference(right_ph, "_pw_at")
    )
    cols["_pw_window"] = ColumnReference(right_ph, "_pw_at")
    joined = jr.select(**cols)
    return joined.filter(
        (ColumnReference(this, "_pw_time") >= ColumnReference(this, "_pw_window_start"))
        & (ColumnReference(this, "_pw_time") <= ColumnReference(this, "_pw_window_end"))
    )
