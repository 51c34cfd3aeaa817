"""Wrappers that the harness puts around calls into the program, from
outside and without editing it, and takes off again.

Each record carries the host's ``time.perf_counter()``, so that a reader
keeps what fell inside the measured window.  With ``ranges`` on, a call
also records a host range (wall-clock nanoseconds and the thread), to
which a traced run ties the device kernels launched inside it
(``devtrace.summarize``).
"""

from __future__ import annotations

import contextlib
import threading
import time

_MISSING = object()


class Probe:
    def __init__(self, ranges: bool = False):
        self.ranges = ranges
        self.foreign: dict[str, tuple] = {}  # range -> other threads' ranges whose kernels may fall in it
        self.records: dict[str, list] = {}
        self._watchers: dict[str, list] = {}
        self._undo: list[tuple] = []
        self._lock = threading.Lock()

    def add(self, kind: str, *values) -> None:
        with self._lock:
            self.records.setdefault(kind, []).append((time.perf_counter(), *values))
        for fn in self._watchers.get(kind, ()):
            fn()

    def watch(self, kind: str, fn) -> None:
        """Call ``fn()`` after each record of ``kind``."""
        self._watchers.setdefault(kind, []).append(fn)

    def count(self, kind: str) -> int:
        return len(self.records.get(kind, ()))

    def of(self, kind: str, window=None) -> list:
        rows = self.records.get(kind, [])
        if window is None:
            return list(rows)
        t0, t1 = window
        return [r for r in rows if t0 <= r[0] < t1]

    def span(self, name: str):
        """A host range ``name`` on this thread (wall-clock ns and the
        thread's native id): the traced window ties to it the kernels
        launched inside it."""
        if not self.ranges:
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            ident = threading.get_ident()
            self.add("range", name, t0, time.time_ns(), (threading.get_native_id(), ident, ident & 0xFFFFFFFF))

    def patch(self, owner, name: str, make) -> None:
        """Replace ``owner.name`` by ``make(original)``; an instance
        attribute shadowing a method is deleted again on ``close``."""
        before = owner.__dict__.get(name, _MISSING) if hasattr(owner, "__dict__") else _MISSING
        original = getattr(owner, name)
        setattr(owner, name, make(original))
        self._undo.append((owner, name, before))

    def patch_kwdefault(self, fn, key: str, make) -> None:
        """Replace the keyword-only default ``key`` of function ``fn``."""
        kw = dict(fn.__kwdefaults__)
        original = kw[key]
        kw[key] = make(original)
        fn.__kwdefaults__ = kw
        self._undo.append((fn, "__kwdefaults__", {**kw, key: original}))

    def on_close(self, fn) -> None:
        self._undo.append((fn, None, None))

    def close(self) -> None:
        while self._undo:
            owner, name, before = self._undo.pop()
            if name is None:
                owner()
            elif before is _MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, before)
