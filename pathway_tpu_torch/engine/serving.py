"""Typed serving rejections and request deadlines.

A slim copy of the part of ``pathway_tpu/engine/serving.py`` that the
generation scheduler uses: the typed errors a request future fails with,
:class:`Deadline`, and the ambient deadline of the calling context.  The
admission controller, load shedding, drain and the metrics they feed wait
for the host-engine slice of the port.
"""

from __future__ import annotations

import contextlib
import contextvars
import time


class ServeRejected(Exception):
    """Base of the typed serving rejections: the value a request future is
    failed with and the exception a wait point raises; both ends read
    ``.status`` and ``.message``."""

    status = 500
    reason = "error"

    def __init__(self, message: str, *, retry_after_s: float | None = None):
        super().__init__(message)
        self.message = message
        self.retry_after_s = retry_after_s


class OverloadedError(ServeRejected):
    """A bounded queue is full: shed newest, 429."""

    status = 429
    reason = "overloaded"


class DeadlineExceededError(ServeRejected):
    """The request's deadline lapsed before an answer existed: 504."""

    status = 504
    reason = "deadline exceeded"


class RequestFailedError(ServeRejected):
    """The serving path failed this request: typed 500."""

    status = 500
    reason = "request failed"


class Deadline:
    """A monotonic point in time a request must be answered by."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)

    @classmethod
    def from_ms(cls, ms: float, *, now: float | None = None) -> "Deadline":
        if now is None:
            now = time.monotonic()
        return cls(now + max(0.0, float(ms)) / 1000.0)

    def remaining_s(self, now: float | None = None) -> float:
        if now is None:
            now = time.monotonic()
        return self.at - now

    def expired(self, now: float | None = None) -> bool:
        return self.remaining_s(now) <= 0.0


_AMBIENT: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "pathway_serve_deadline", default=None
)


def current_deadline() -> Deadline | None:
    """The ambient request deadline of the calling context, if any."""
    return _AMBIENT.get()


@contextlib.contextmanager
def deadline_scope(deadline: Deadline | None):
    """Run a block under an ambient deadline (contextvar-scoped)."""
    token = _AMBIENT.set(deadline)
    try:
        yield deadline
    finally:
        _AMBIENT.reset(token)
