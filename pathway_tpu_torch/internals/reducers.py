"""Incremental reducers.

Parity target: ``src/engine/reduce.rs:22-38`` (engine side) and
``python/pathway/reducers.py`` (user API): count, sum (int,
float, array), min/max/argmin/argmax, unique, any, sorted_tuple, tuple,
ndarray, avg, earliest/latest, stateful_single/stateful_many, plus
``BaseCustomAccumulator`` custom reducers.

Engine contract (mirrors the semigroup-vs-full split of reduce.rs:40-61):
every reducer owns a per-group state object supporting ``add(args, diff,
time, key)`` and ``extract()``.  Invertible reducers (count/sum/avg) update
in O(1); non-invertible ones keep the group's value multiset and recompute
on change — the same strategy differential dataflow's ``reduce`` uses, minus
arrangement sharing.
"""

from __future__ import annotations

import datetime as _datetime
import itertools
from collections import Counter
from collections.abc import Sequence
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.types import ERROR, Pointer
from pathway_tpu_torch.internals import dtype as dt


class ReducerState:
    def add(self, args: tuple, diff: int, time: int, key) -> None:
        raise NotImplementedError

    def extract(self) -> Any:
        raise NotImplementedError

    def is_empty(self) -> bool:
        raise NotImplementedError

    # operator-snapshot hooks (persistence/operator_snapshot.rs analog):
    # dump() returns plain picklable data; load() restores it into a state
    # freshly created by Reducer.make_state(), which re-binds any callables
    def dump(self) -> Any:
        raise NotImplementedError(f"{type(self).__name__} is not persistable")

    def load(self, data: Any) -> None:
        raise NotImplementedError(f"{type(self).__name__} is not persistable")


class Reducer:
    name: str = "reducer"

    def result_dtype(self, arg_dtypes: list[dt.DType]) -> dt.DType:
        return dt.ANY

    def make_state(self) -> ReducerState:
        raise NotImplementedError

    def make_append_state(self) -> ReducerState:
        """State variant for groups fed by an append-only input stream
        (``Node.append_only``): never sees retractions, so non-invertible
        reducers may keep O(1) running entries instead of value multisets.
        Default: same as ``make_state`` (already O(1) or order-dependent)."""
        return self.make_state()

    def __call__(self, *args, **kwargs):
        from pathway_tpu_torch.internals.expression import ReducerExpression

        return ReducerExpression(self, *args, **kwargs)

    def __repr__(self):
        return f"pw.reducers.{self.name}"


class _CountState(ReducerState):
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def add(self, args, diff, time, key):
        self.n += diff

    def add_bulk(self, n_contrib: int) -> None:
        """Columnar path: fold a whole batch's diff total in one call."""
        self.n += n_contrib

    def extract(self):
        return self.n

    def is_empty(self):
        return self.n == 0

    def dump(self):
        return self.n

    def load(self, data):
        self.n = data


class CountReducer(Reducer):
    name = "count"

    def result_dtype(self, arg_dtypes):
        return dt.INT

    def make_state(self):
        return _CountState()


class _SumState(ReducerState):
    __slots__ = ("total", "n", "is_array")

    def __init__(self):
        self.total = None
        self.n = 0

    def add(self, args, diff, time, key):
        (v,) = args
        if v is None:
            return
        contrib = v * diff if diff != 1 else v
        if self.total is None:
            self.total = contrib if diff == 1 else contrib
        else:
            self.total = self.total + contrib
        self.n += diff

    def add_bulk(self, total_contrib, n_contrib: int) -> None:
        """Columnar path: Σ value·diff and Σ diff for a batch (no Nones —
        the vector path only runs on typed columns)."""
        if self.total is None:
            self.total = total_contrib
        else:
            self.total = self.total + total_contrib
        self.n += n_contrib

    def extract(self):
        if self.total is None:
            return 0
        if isinstance(self.total, float):
            return self.total
        return self.total

    def is_empty(self):
        return self.n == 0

    def dump(self):
        return (self.total, self.n)

    def load(self, data):
        self.total, self.n = data


class SumReducer(Reducer):
    name = "sum"

    def result_dtype(self, arg_dtypes):
        t = arg_dtypes[0].strip_optional() if arg_dtypes else dt.ANY
        if t in (dt.INT, dt.FLOAT, dt.DURATION) or isinstance(t, dt._Array):
            return t
        return dt.ANY

    def make_state(self):
        return _SumState()


class _AvgState(_SumState):
    def extract(self):
        if self.n == 0:
            return None
        return self.total / self.n


class AvgReducer(Reducer):
    name = "avg"

    def result_dtype(self, arg_dtypes):
        return dt.FLOAT

    def make_state(self):
        return _AvgState()


def _sort_key(v):
    # deterministic total order: numbers compare numerically across
    # bool/int/float; other types are grouped and ordered within the group
    if isinstance(v, (bool, int, float)):
        return (0, float(v))
    if isinstance(v, str):
        return (1, v)
    if isinstance(v, bytes):
        return (2, v)
    if isinstance(v, _builtin_tuple):
        return (3, _builtin_tuple(_sort_key(x) for x in v))
    if isinstance(v, Pointer):
        return (4, v.value)
    if isinstance(v, _datetime.datetime):
        if v.tzinfo is not None:
            return (6, 1, v.astimezone(_datetime.timezone.utc).isoformat())
        return (6, 0, v.isoformat())
    if isinstance(v, _datetime.timedelta):
        return (7, v.total_seconds())
    return (5, str(type(v).__name__), repr(v))


class _MultisetState(ReducerState):
    """Counter-of-rows state for non-invertible reducers.

    ``keyed=False`` collapses entries by VALUE: reducers that never look at
    the row key (min/max/unique/sorted_tuple) then hold one counter per
    distinct value instead of one per contributing row — the semigroup-style
    compaction the reference applies to these reducers (reduce.rs:40-61),
    bounding per-group memory on high-churn groups."""

    __slots__ = ("rows", "finish", "keyed")

    def __init__(self, finish: Callable[[Counter], Any], keyed: bool = True):
        self.rows = Counter()
        self.finish = finish
        self.keyed = keyed

    def add(self, args, diff, time, key):
        entry = (args, key if self.keyed else None)
        self.rows[entry] += diff
        if self.rows[entry] == 0:
            del self.rows[entry]

    def add_pairs(self, values, counts):
        """Columnar bulk update: per distinct value, a summed diff.
        Only valid for ``keyed=False`` states (min/max/...)."""
        rows = self.rows
        for v, c in zip(values, counts):
            entry = ((v,), None)
            rows[entry] += c
            if rows[entry] == 0:
                del rows[entry]

    def extract(self):
        return self.finish(self.rows)

    def is_empty(self):
        return not self.rows

    def dump(self):
        return self.rows

    def load(self, data):
        _reject_running_dump(data)
        if self.keyed:
            self.rows = Counter(data)
            return
        # snapshots written before value-collapsing keep (args, key)
        # entries — normalize so later retractions (args, None) cancel them
        self.rows = Counter()
        for (args, _key), cnt in Counter(data).items():
            self.rows[(args, None)] += cnt
        for entry in [e for e, c in self.rows.items() if c == 0]:
            del self.rows[entry]


def _reject_running_dump(data) -> None:
    """Multiset/time states must refuse a running-state dump (the other
    direction of the _RunningState.load guard): a snapshot written while
    the source was append-only cannot resume after the declaration was
    dropped — Counter(data) would silently build garbage state."""
    if (
        isinstance(data, _builtin_tuple)
        and len(data) == 3
        and data[0] in ("ro1", "ru1")
    ):
        raise ValueError(
            "operator snapshot holds an append-only reducer state but the "
            "source is no longer append-only; resume with the original "
            "schema properties or clear the persistence dir"
        )


def _append_only_violation():
    from pathway_tpu_torch.engine.dataflow import EngineError

    raise EngineError(
        "retraction reached an append-only reduction state: the input "
        "stream was inferred append-only (declared via "
        "column_definition(append_only=True) or a retraction-free source) "
        "but produced a deletion"
    )


class _RunningState(ReducerState):
    """O(1) accumulator for groups fed by an append-only stream.

    Non-invertible reducers (min/max/argmin/argmax/any/earliest/latest)
    need their value multiset only to survive retractions; when the lowered
    input can never retract (``Node.append_only``) a single running entry
    suffices.  This is the operator-variant choice the reference drives off
    column append-onlyness (``internals/column_properties.py``; engine
    switches ``src/engine/dataflow.rs:1741``).

    ``enter(args, time, key)`` builds a comparable entry; ``better`` says
    whether a new entry replaces the running one (strict — ties keep the
    first arrival, matching multiset iteration order); ``result`` maps the
    running entry to the reducer output.
    """

    __slots__ = ("entry", "n", "enter", "better", "result")

    def __init__(self, enter: Callable, better: Callable, result: Callable):
        self.entry = None
        self.n = 0
        self.enter = enter
        self.better = better
        self.result = result

    def add(self, args, diff, time, key):
        if diff < 0:
            _append_only_violation()
        self.n += diff
        e = self.enter(args, time, key)
        if self.entry is None or self.better(e, self.entry):
            self.entry = e

    def add_pairs(self, values, counts):
        """Columnar bulk update (GroupByNode "mm" path): per distinct
        value, a summed diff — only keyless reducers (min/max) get here."""
        enter, better = self.enter, self.better
        for v, c in zip(values, counts):
            if c < 0:
                _append_only_violation()
            self.n += c
            e = enter((v,), 0, None)
            if self.entry is None or better(e, self.entry):
                self.entry = e

    def extract(self):
        return self.result(self.entry)

    def is_empty(self):
        return self.n <= 0

    def dump(self):
        return ("ro1", self.entry, self.n)

    def load(self, data):
        if not (isinstance(data, _builtin_tuple) and len(data) == 3 and data[0] == "ro1"):
            raise ValueError(
                "operator snapshot holds a multiset reducer state but the "
                "source is now append-only (or vice versa); resume with the "
                "original schema properties or clear the persistence dir"
            )
        _, self.entry, self.n = data


def _running_min_factory(latest: bool):
    def enter(args, time, key):
        return (_sort_key(args[0]), args[0])

    def better(e, cur):
        return e[0] > cur[0] if latest else e[0] < cur[0]

    return lambda: _RunningState(enter, better, lambda e: e[1])


_running_states: dict[str, Callable[[], _RunningState]] = {
    "min": _running_min_factory(latest=False),
    "max": _running_min_factory(latest=True),
    # argmin: min by (value sort key, row key) — the tie rule of
    # _finish_argmin; argmax: max by value, tie broken by MIN row key
    "argmin": lambda: _RunningState(
        lambda a, t, k: (_sort_key(a[0]), k),
        lambda e, c: e < c,
        lambda e: e[1] if isinstance(e[1], Pointer) else Pointer(e[1]),
    ),
    "argmax": lambda: _RunningState(
        lambda a, t, k: (_sort_key(a[0]), k),
        lambda e, c: e[0] > c[0] or (e[0] == c[0] and e[1] < c[1]),
        lambda e: e[1] if isinstance(e[1], Pointer) else Pointer(e[1]),
    ),
    # any: the row with the smallest key (the _finish_any pick)
    "any": lambda: _RunningState(
        lambda a, t, k: (k, a[0]),
        lambda e, c: e[0] < c[0],
        lambda e: e[1],
    ),
}


class _RunningUniqueState(ReducerState):
    """Append-only ``unique``: remembers at most two distinct non-None
    values — two suffice to report ERROR, exactly as _finish_unique."""

    __slots__ = ("vals", "n")

    def __init__(self):
        self.vals: list = []
        self.n = 0

    def add(self, args, diff, time, key):
        if diff < 0:
            _append_only_violation()
        self.n += diff
        v = args[0]
        if v is not None and v not in self.vals and len(self.vals) < 2:
            self.vals.append(v)

    def add_pairs(self, values, counts):
        for v, c in zip(values, counts):
            self.add((v,), c, 0, None)

    def extract(self):
        if len(self.vals) > 1:
            return ERROR
        return self.vals[0] if self.vals else None

    def is_empty(self):
        return self.n <= 0

    def dump(self):
        return ("ru1", self.vals, self.n)

    def load(self, data):
        if not (isinstance(data, _builtin_tuple) and len(data) == 3 and data[0] == "ru1"):
            raise ValueError(
                "operator snapshot reducer-state format mismatch (see "
                "_RunningState.load)"
            )
        _, self.vals, self.n = data


def _multiset_reducer(
    name_: str, finish: Callable[[Counter], Any], rdtype=None, keyed: bool = True
):
    class _R(Reducer):
        name = name_

        def result_dtype(self, arg_dtypes):
            if rdtype is not None:
                return rdtype if isinstance(rdtype, dt.DType) else rdtype(arg_dtypes)
            return arg_dtypes[0] if arg_dtypes else dt.ANY

        def make_state(self):
            return _MultisetState(finish, keyed=keyed)

        def make_append_state(self):
            if name_ == "unique":
                return _RunningUniqueState()
            factory = _running_states.get(name_)
            return factory() if factory is not None else self.make_state()

    _R.__name__ = f"{name_.title()}Reducer"
    return _R()


# `min`/`max`/`sum`/`any`/`tuple` are shadowed below by the public reducer
# instances (mirroring pw.reducers naming); keep the builtins reachable.
_builtin_min = min
_builtin_max = max
_builtin_sum = sum
_builtin_any = any
_builtin_tuple = tuple


def _finish_min(rows: Counter):
    return _builtin_min((a[0] for (a, k) in rows), key=_sort_key)


def _finish_max(rows: Counter):
    return _builtin_max((a[0] for (a, k) in rows), key=_sort_key)


def _finish_argmin(rows: Counter):
    best = _builtin_min(rows, key=lambda e: (_sort_key(e[0][0]), e[1]))
    return Pointer(best[1]) if not isinstance(best[1], Pointer) else best[1]


def _finish_argmax(rows: Counter):
    mx = _builtin_max(_sort_key(e[0][0]) for e in rows)
    best = _builtin_min((e for e in rows if _sort_key(e[0][0]) == mx), key=lambda e: e[1])
    return Pointer(best[1]) if not isinstance(best[1], Pointer) else best[1]


def _finish_unique(rows: Counter):
    vals = {a[0] for (a, k) in rows if a[0] is not None}
    if len(vals) > 1:
        return ERROR
    return next(iter(vals), None)


def _finish_any(rows: Counter):
    return _builtin_min(((a, k) for (a, k) in rows), key=lambda e: e[1])[0][0]


def _finish_sorted_tuple_factory(skip_nones: bool):
    def finish(rows: Counter):
        out = []
        for (a, k), cnt in rows.items():
            v = a[0]
            if skip_nones and v is None:
                continue
            out.extend([v] * cnt)
        out.sort(key=_sort_key)
        return _builtin_tuple(out)

    return finish


def _finish_tuple_factory(skip_nones: bool):
    def finish(rows: Counter):
        entries = []
        for (a, k), cnt in rows.items():
            v = a[0]
            if skip_nones and v is None:
                continue
            # order by the sort column when 2 args are given (tuple(x, sort_by=...)),
            # else by row key — matching reference tuple reducer ordering
            sort_v = a[1] if len(a) > 1 else k
            entries.extend([(sort_v, k, v)] * cnt)
        entries.sort(key=lambda e: (_sort_key(e[0]), e[1]))
        return _builtin_tuple(v for (_, _, v) in entries)

    return finish


def _finish_ndarray_factory(skip_nones: bool):
    def finish(rows: Counter):
        tup = _finish_tuple_factory(skip_nones)(rows)
        return np.array(tup)

    return finish


class _TimeBasedState(ReducerState):
    """earliest/latest — value at min/max processing time."""

    __slots__ = ("rows", "latest")

    def __init__(self, latest: bool):
        self.rows = Counter()
        self.latest = latest

    def add(self, args, diff, time, key):
        entry = (time, key, args)
        self.rows[entry] += diff
        if self.rows[entry] == 0:
            del self.rows[entry]

    def extract(self):
        pick = _builtin_max if self.latest else _builtin_min
        best = pick(self.rows, key=lambda e: (e[0], e[1]))
        return best[2][0]

    def is_empty(self):
        return not self.rows

    def dump(self):
        return self.rows

    def load(self, data):
        _reject_running_dump(data)
        self.rows = Counter(data)


def _time_running_state(latest: bool) -> _RunningState:
    return _RunningState(
        lambda a, t, k: ((t, k), a[0]),
        (lambda e, c: e[0] > c[0]) if latest else (lambda e, c: e[0] < c[0]),
        lambda e: e[1],
    )


class EarliestReducer(Reducer):
    name = "earliest"

    def result_dtype(self, arg_dtypes):
        return arg_dtypes[0] if arg_dtypes else dt.ANY

    def make_state(self):
        return _TimeBasedState(latest=False)

    def make_append_state(self):
        return _time_running_state(latest=False)


class LatestReducer(Reducer):
    name = "latest"

    def result_dtype(self, arg_dtypes):
        return arg_dtypes[0] if arg_dtypes else dt.ANY

    def make_state(self):
        return _TimeBasedState(latest=True)

    def make_append_state(self):
        return _time_running_state(latest=True)


class _StatefulState(ReducerState):
    """Recompute a Python combiner over the group multiset (reduce.rs Stateful)."""

    __slots__ = ("rows", "combine", "many")

    def __init__(self, combine: Callable, many: bool):
        self.rows = Counter()
        self.combine = combine
        self.many = many

    def add(self, args, diff, time, key):
        entry = (args, key)
        self.rows[entry] += diff
        if self.rows[entry] == 0:
            del self.rows[entry]

    def extract(self):
        values = []
        for (a, k), cnt in sorted(self.rows.items(), key=lambda e: e[0][1]):
            values.extend([a] * cnt)
        if self.many:
            return self.combine(None, [(1, v) for v in values])
        state = None
        for v in values:
            state = self.combine(state, *v)
        return state

    def is_empty(self):
        return not self.rows

    def dump(self):
        return self.rows

    def load(self, data):
        self.rows = Counter(data)


class StatefulReducer(Reducer):
    def __init__(self, combine: Callable, many: bool, name: str = "stateful"):
        self._combine = combine
        self._many = many
        self.name = name

    def result_dtype(self, arg_dtypes):
        import typing

        try:
            hints = typing.get_type_hints(self._combine)
            if "return" in hints:
                return dt.wrap(hints["return"])
        except Exception:
            pass
        return dt.ANY

    def make_state(self):
        return _StatefulState(self._combine, self._many)


def stateful_single(combine_fn: Callable) -> StatefulReducer:
    r"""pw.reducers.stateful_single — state = combine(state, *row_values).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> concat = pw.reducers.stateful_single(
    ...     lambda state, v: (state or '') + v
    ... )
    >>> t = pw.debug.table_from_markdown('k | v\na | x\na | y')
    >>> r = t.groupby(pw.this.k).reduce(pw.this.k, s=concat(pw.this.v))
    >>> pw.debug.compute_and_print(r, include_id=False)
    k | s
    a | xy
    """
    return StatefulReducer(combine_fn, many=False, name=getattr(combine_fn, "__name__", "stateful"))


def stateful_many(combine_fn: Callable) -> StatefulReducer:
    """pw.reducers.stateful_many — combine(state, [(diff, row), ...])."""
    return StatefulReducer(combine_fn, many=True, name=getattr(combine_fn, "__name__", "stateful"))


class BaseCustomAccumulator:
    """User-defined accumulator (pw.BaseCustomAccumulator).

    Subclasses implement ``from_row``, ``update``, optionally ``retract`` and
    ``neutral``, and ``compute_result``.
    """

    @classmethod
    def from_row(cls, row):
        raise NotImplementedError

    def update(self, other):
        raise NotImplementedError

    def retract(self, other):
        raise NotImplementedError

    def compute_result(self):
        raise NotImplementedError


class _CustomAccState(ReducerState):
    __slots__ = ("rows", "acc_cls", "order", "_seq")

    def __init__(self, acc_cls):
        self.rows = Counter()
        self.acc_cls = acc_cls
        # arrival order (time, seq) per entry: order-sensitive accumulators
        # (HMM) must replay in processing order, matching how the reference
        # engine applies stateful updates per timestamp — keys are hashes
        # and carry no ordering
        self.order: dict = {}
        self._seq = itertools.count()

    def add(self, args, diff, time, key):
        entry = (args, key)
        if entry not in self.order:
            self.order[entry] = (time, next(self._seq))
        self.rows[entry] += diff
        if self.rows[entry] == 0:
            del self.rows[entry]
            del self.order[entry]

    def extract(self):
        acc = None
        for (a, _k), cnt in sorted(self.rows.items(), key=lambda e: self.order[e[0]]):
            for _ in range(cnt):
                nxt = self.acc_cls.from_row(list(a))
                if acc is None:
                    acc = nxt
                else:
                    acc.update(nxt)
        return acc.compute_result() if acc is not None else None

    def is_empty(self):
        return not self.rows

    def dump(self):
        return (self.rows, self.order, max((s for (_t, s) in self.order.values()), default=-1) + 1)

    def load(self, data):
        rows, order, seq_next = data
        self.rows = Counter(rows)
        self.order = dict(order)
        self._seq = itertools.count(seq_next)


def udf_reducer(accumulator: type[BaseCustomAccumulator]):
    r"""Custom reducer from a ``BaseCustomAccumulator`` subclass (supports retractions).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> class Sum(pw.BaseCustomAccumulator):
    ...     def __init__(self, v):
    ...         self.s = v
    ...     @classmethod
    ...     def from_row(cls, row):
    ...         return cls(row[0])
    ...     def update(self, other):
    ...         self.s += other.s
    ...     def retract(self, other):
    ...         self.s -= other.s
    ...     def compute_result(self):
    ...         return self.s
    >>> ssum = pw.reducers.udf_reducer(Sum)
    >>> t = pw.debug.table_from_markdown('k | v\na | 2\na | 3')
    >>> pw.debug.compute_and_print(t.groupby(pw.this.k).reduce(pw.this.k, s=ssum(pw.this.v)), include_id=False)
    k | s
    a | 5
    """
    class _R(Reducer):
        name = getattr(accumulator, "__name__", "custom")

        def result_dtype(self, arg_dtypes):
            import typing

            try:
                hints = typing.get_type_hints(accumulator.compute_result)
                if "return" in hints:
                    return dt.wrap(hints["return"])
            except Exception:
                pass
            return dt.ANY

        def make_state(self):
            return _CustomAccState(accumulator)

    return _R()


# --- public reducer instances -------------------------------------------------

count = CountReducer()
sum = SumReducer()  # noqa: A001 — mirrors pw.reducers.sum
avg = AvgReducer()
min = _multiset_reducer("min", _finish_min, keyed=False)  # noqa: A001
max = _multiset_reducer("max", _finish_max, keyed=False)  # noqa: A001
argmin = _multiset_reducer("argmin", _finish_argmin, dt.POINTER)
argmax = _multiset_reducer("argmax", _finish_argmax, dt.POINTER)
unique = _multiset_reducer("unique", _finish_unique, keyed=False)
any = _multiset_reducer("any", _finish_any)  # noqa: A001
earliest = EarliestReducer()
latest = LatestReducer()


def sorted_tuple(expr, *, skip_nones: bool = False):
    r"""Aggregate the values of ``expr`` into a sorted tuple per group.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('k | v\na | 3\na | 1\nb | 2')
    >>> r = t.groupby(pw.this.k).reduce(pw.this.k, vs=pw.reducers.sorted_tuple(pw.this.v))
    >>> pw.debug.compute_and_print(r, include_id=False)
    k | vs
    a | (1, 3)
    b | (2,)
    """
    r = _multiset_reducer(
        "sorted_tuple",
        _finish_sorted_tuple_factory(skip_nones),
        lambda ts: dt.List(dt.unoptionalize(ts[0]) if skip_nones else ts[0]),
        keyed=False,
    )
    return r(expr)


def tuple(expr, *, skip_nones: bool = False, sort_by=None):  # noqa: A001
    r"""Aggregate values into a tuple per group, optionally ordered by ``sort_by``.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('k | v | o\na | x | 2\na | y | 1')
    >>> r = t.groupby(pw.this.k).reduce(pw.this.k, vs=pw.reducers.tuple(pw.this.v, sort_by=pw.this.o))
    >>> pw.debug.compute_and_print(r, include_id=False)
    k | vs
    a | ('y', 'x')
    """
    r = _multiset_reducer(
        "tuple",
        _finish_tuple_factory(skip_nones),
        lambda ts: dt.List(dt.unoptionalize(ts[0]) if skip_nones else ts[0]),
    )
    if sort_by is not None:
        return r(expr, sort_by)
    return r(expr)


def ndarray(expr, *, skip_nones: bool = False):
    r = _multiset_reducer(
        "ndarray", _finish_ndarray_factory(skip_nones), dt.ANY_ARRAY
    )
    return r(expr)


# count may be called with zero args inside reduce()
class _CountCallable(CountReducer):
    def __call__(self, *args, **kwargs):
        from pathway_tpu_torch.internals.expression import ReducerExpression

        return ReducerExpression(self, *args)


count = _CountCallable()
