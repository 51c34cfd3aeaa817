"""Typed serving rejections and request deadlines.

A slim copy of the part of ``pathway_tpu/engine/serving.py`` that the
generation scheduler and the device layer use: the typed errors a request
future fails with, :class:`Deadline`, the ambient deadline of the calling
context, and the shed-before-work check (:func:`shed_if_expired`) with its
``serve.deadline.exceeded``/``serve.shed`` counters, which
``DeviceExecutor.submit`` and ``AsyncMicroBatcher`` call before any device
work; and the request-row registry behind :func:`note_row_error`, the
dataflow's poisoned-row hook (a no-op while nothing is serving).  The
admission controller, its quarantine, load shedding and drain wait for the
serving slice of the port (H5).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Callable

from pathway_tpu_torch.engine import metrics as metrics_mod


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


def shed_if_expired(where: str) -> None:
    """Raise :class:`DeadlineExceededError` when the ambient deadline has
    lapsed: the shed-before-work check a wait point calls before paying
    for dispatch.  No ambient deadline, no-op."""
    ddl = _AMBIENT.get()
    if ddl is not None and ddl.expired():
        note_deadline_shed(where)
        raise DeadlineExceededError(
            f"request deadline lapsed before {where} dispatch (shed-before-work)"
        )


def note_deadline_shed(where: str) -> None:
    """Count a deadline-driven shed at a named wait point."""
    reg = metrics_mod.get_registry()
    reg.counter(
        "serve.deadline.exceeded", "requests answered 504, by where the lapse was caught", where=where
    ).inc()
    reg.counter("serve.shed", "requests shed before pipeline work", reason=where).inc()


# ---------------------------------------------------------------------------
# request registry: pipeline-side typed completion
# ---------------------------------------------------------------------------

# key -> fail callback (status, message) — registered for every in-flight
# request row by the REST ingress, called (threadsafe) by the dataflow
# row-error hook.  Module-level so the epoch thread can reach it without
# holding a reference to the webserver.
_requests: dict[int, Callable[[int, str], None]] = {}
_requests_lock = threading.Lock()


def register_request(key: int, fail_cb: Callable[[int, str], None]) -> None:
    with _requests_lock:
        _requests[key] = fail_cb


def unregister_request(key: int) -> None:
    with _requests_lock:
        _requests.pop(key, None)


def fail_request(key: int, status: int, message: str) -> bool:
    """Complete the waiting future of request ``key`` with a typed error.

    Called from the epoch thread — must stay cheap when serving is
    inactive: one falsy dict check."""
    if not _requests:
        return False
    with _requests_lock:
        cb = _requests.get(key)
    if cb is None:
        return False
    try:
        cb(status, message)
    except Exception:  # noqa: BLE001 - a dead event loop must not hurt the epoch
        return False
    return True


def note_row_error(key: int, message: str) -> None:
    """Pipeline errored on row ``key``: if it is a serving request,
    complete it as a typed 500."""
    if not _requests:
        return
    fail_request(key, 500, message)
