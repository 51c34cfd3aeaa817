"""Serving-path overload robustness: admission, deadlines, shedding, drain.

A copy of ``pathway_tpu/engine/serving.py``, the contract of the REST
ingress (``io/http/_server.py``):

* **Admission control** — an :class:`AdmissionController` bounds in-flight
  request count (``PATHWAY_SERVE_INFLIGHT``) and bytes
  (``PATHWAY_SERVE_INFLIGHT_MB``); arrivals beyond the budget wait in a
  deadline-aware pending queue (``PATHWAY_SERVE_QUEUE`` deep), and
  overflow is answered ``429`` with a ``Retry-After`` sized from observed
  ``serve.latency.ms`` — never a stranded socket.
* **Deadline propagation** — every request carries a :class:`Deadline`
  (client ``X-Pathway-Deadline-Ms`` header, default
  ``PATHWAY_SERVE_DEADLINE_MS``), stamped onto the request row
  (``io/_utils.DEADLINE_TS``) and checked at the wait points: connector
  staging drops expired rows, ``AsyncMicroBatcher`` fails expired waiters
  before coalescing, ``DeviceExecutor.submit`` refuses an expired ambient
  deadline, and the generation scheduler sheds lapsed rows — answered
  ``504``.
* **Load shedding with graceful degradation** — queue delay sustained
  above ``PATHWAY_SERVE_QUEUE_DELAY_MS`` engages degraded mode with dwell
  and recovery clocks: newest requests are shed (429) and routes
  registered with a ``degraded_handler`` switch to their cheap path.
* **Typed error completion + drain** — a pipeline error on a request row
  completes the waiting future as a typed ``500`` (the row lands in a
  bounded quarantine); :func:`ready_for_handoff` stops accepting (``503``)
  and drains in-flight requests within ``PATHWAY_SERVE_DRAIN_S``.

The promotion hooks (:func:`fail_inflight_for_promotion`,
:func:`resume_after_promotion`) and :func:`ready_for_handoff` are copied
but have no caller until the supervisor and live handoff of slice H4; the
freshness sensor behind :func:`set_pressure_supplier` comes with H5.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import threading
import time
from collections import deque
from typing import Any, Callable

from pathway_tpu_torch.engine import metrics as metrics_mod
from pathway_tpu_torch.internals.config import (
    env_bool,
    env_float,
    env_int,
)

# ---------------------------------------------------------------------------
# typed serve errors
# ---------------------------------------------------------------------------


class ServeRejected(Exception):
    """Base of the typed serving rejections.

    Doubles as the *value* a request future is failed with (``fail()``)
    and the *exception* a wait point raises (batcher/device shed) — both
    ends read ``.status``/``.message`` and answer the client promptly.
    """

    status = 500
    reason = "error"

    def __init__(self, message: str, *, retry_after_s: float | None = None):
        super().__init__(message)
        self.message = message
        self.retry_after_s = retry_after_s


class OverloadedError(ServeRejected):
    """Admission budget + pending queue full: shed newest, 429."""

    status = 429
    reason = "overloaded"


class DrainingError(ServeRejected):
    """Webserver stop-accept window (shutdown / live handoff): 503."""

    status = 503
    reason = "draining"


class DeadlineExceededError(ServeRejected):
    """The request's deadline lapsed before an answer existed: 504."""

    status = 504
    reason = "deadline exceeded"


class RequestFailedError(ServeRejected):
    """The pipeline errored on this request's row: typed 500."""

    status = 500
    reason = "request failed"


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


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
    """Run a block under an ambient deadline (contextvar-scoped, so it
    propagates into coroutines/tasks created inside the block)."""
    token = _AMBIENT.set(deadline)
    try:
        yield deadline
    finally:
        _AMBIENT.reset(token)


def shed_if_expired(where: str) -> None:
    """Raise :class:`DeadlineExceededError` when the ambient deadline has
    lapsed — the shed-before-work check wait points call before paying
    for dispatch.  No ambient deadline → no-op."""
    ddl = _AMBIENT.get()
    if ddl is not None and ddl.expired():
        note_deadline_shed(where)
        raise DeadlineExceededError(
            f"request deadline lapsed before {where} dispatch "
            "(shed-before-work)"
        )


def note_deadline_shed(where: str) -> None:
    """Count a deadline-driven shed at a named wait point."""
    reg = metrics_mod.get_registry()
    reg.counter(
        "serve.deadline.exceeded",
        "requests answered 504, by where the lapse was caught",
        where=where,
    ).inc()
    reg.counter(
        "serve.shed", "requests shed before pipeline work", reason=where
    ).inc()


# ---------------------------------------------------------------------------
# request registry: pipeline-side typed completion
# ---------------------------------------------------------------------------

# key -> fail callback (status, message) — registered by _RestSubject for
# every in-flight request row, called (threadsafe) by the staging dropper
# and the dataflow row-error hook.  Module-level so the epoch thread can
# reach it without holding a reference to the webserver.
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

    Called from the epoch thread (row errors, staging drops) — must stay
    cheap when serving is inactive: one falsy dict check."""
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
    complete it as a typed 500 and quarantine the record (the serving
    analogue of the device executor's poisoned-batch log)."""
    if not _requests:
        return
    if fail_request(key, 500, message):
        c = _controller
        if c is not None:
            c.quarantine(key, message)


def shed_staged(key: int) -> None:
    """Connector staging found an expired request row: never stage it —
    504 the waiting client instead of burning an epoch on it."""
    note_deadline_shed("staging")
    fail_request(
        key, 504, "deadline expired before the request row was staged"
    )


# ---------------------------------------------------------------------------
# admission controller
# ---------------------------------------------------------------------------


class _Ticket:
    """One admitted request's claim on the in-flight budget."""

    __slots__ = ("route", "nbytes", "synthetic", "admitted_at", "trace")

    def __init__(
        self,
        route: str,
        nbytes: int,
        synthetic: bool = False,
        admitted_at: float = 0.0,
    ):
        self.route = route
        self.nbytes = int(nbytes)
        self.synthetic = synthetic
        self.admitted_at = admitted_at
        # RequestTrace attached by ``admit`` (None when tracing is off)
        self.trace = None


class _Waiter:
    __slots__ = ("route", "nbytes", "deadline", "enqueued_at", "loop", "future")

    def __init__(self, route, nbytes, deadline, enqueued_at, loop, future):
        self.route = route
        self.nbytes = nbytes
        self.deadline = deadline
        self.enqueued_at = enqueued_at
        self.loop = loop
        self.future = future


class AdmissionController:
    """Bounded in-flight budget + deadline-aware pending queue + CoDel
    shedder + drain state machine.

    Pure state under one lock, wall clock injected (``clock=``) so the
    hysteresis is unit-testable tick by tick — the ``ScaleController``
    shape.  Async admission waits are parked on per-waiter futures and
    granted via ``call_soon_threadsafe``, so one controller serves
    webserver threads on different event loops.
    """

    def __init__(
        self,
        *,
        inflight_limit: int,
        inflight_bytes: int,
        queue_limit: int,
        target_delay_ms: float,
        shed_dwell_s: float,
        recover_s: float,
        drain_s: float,
        enabled: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.inflight_limit = max(1, int(inflight_limit))
        self.inflight_bytes_limit = max(1, int(inflight_bytes))
        self.queue_limit = max(0, int(queue_limit))
        self.target_delay_ms = float(target_delay_ms)
        self.shed_dwell_s = float(shed_dwell_s)
        self.recover_s = float(recover_s)
        self.drain_s = float(drain_s)
        self.enabled = bool(enabled)
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight = 0
        self._inflight_bytes = 0
        self._waiters: deque[_Waiter] = deque()
        self._lat_ms: deque[float] = deque(maxlen=128)
        # shedder hysteresis dwell clocks — explicit None checks (0.0 is a
        # valid injected clock reading; `or` resets a dwell started at 0)
        self._over_since: float | None = None
        self._calm_since: float | None = None
        self._degraded = False
        # drain state
        self._draining = False
        self._drain_started: float | None = None
        self._drain_deadline: float | None = None
        self._drained_evt = threading.Event()
        self._drain_recorded = False
        # typed-500 quarantine (newest kept, device-executor parity)
        self._quarantine: deque[dict[str, Any]] = deque(maxlen=32)
        self._quarantined_total = 0
        # optional external pressure sensor (worst output staleness, s)
        self._pressure: Callable[[], float] | None = None
        # admit-time of every outstanding real ticket (id(ticket) keyed):
        # clamps the staleness pressure signal to the age of the oldest
        # admitted request still unanswered
        self._outstanding: dict[int, float] = {}
        self._reg = metrics_mod.get_registry()

    # -- properties --------------------------------------------------------

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def queue_depth(self) -> int:
        return len(self._waiters)

    @property
    def degraded(self) -> bool:
        return self._degraded

    @property
    def draining(self) -> bool:
        return self._draining

    def set_pressure_supplier(self, fn: Callable[[], float] | None) -> None:
        self._pressure = fn

    def oldest_outstanding_age_s(self, now: float | None = None) -> float:
        """Age (seconds) of the oldest admitted request still unanswered;
        0.0 when nothing is outstanding.  The shedder clamps its staleness
        pressure signal to this (idleness is not overload), and the
        default staleness SLO shares the same clamp (idleness is not
        burn)."""
        if now is None:
            now = self._clock()
        with self._lock:
            if not self._outstanding:
                return 0.0
            return max(0.0, now - min(self._outstanding.values()))

    # -- admission ---------------------------------------------------------

    def _has_capacity_locked(self, nbytes: int) -> bool:
        return (
            self._inflight < self.inflight_limit
            and self._inflight_bytes + nbytes <= self.inflight_bytes_limit
        )

    def _grant_locked(self, route: str, nbytes: int, now: float) -> _Ticket:
        self._inflight += 1
        self._inflight_bytes += nbytes
        ticket = _Ticket(route, nbytes, admitted_at=now)
        self._outstanding[id(ticket)] = now
        return ticket

    async def admit(
        self,
        route: str,
        nbytes: int,
        deadline: Deadline,
        trace_parent: str | None = None,
    ):
        """Admit or reject one request.  Returns a ticket to pass to
        :meth:`release`; raises a :class:`ServeRejected` subclass with the
        HTTP status + Retry-After already decided.  Never strands the
        caller: every path answers within the request's own deadline.

        The admission controller is also where the request's
        :class:`~pathway_tpu_torch.engine.tracing.RequestTrace` is born (the
        ingress ``traceparent`` continues a caller's trace; otherwise one
        is minted): the ticket carries it, and the admission wait —
        fast-path or queued — becomes its first child span."""
        from pathway_tpu_torch.engine import tracing

        trace = tracing.begin_request(route, trace_parent)
        started = time.time()
        try:
            ticket = await self._admit(route, nbytes, deadline)
        except ServeRejected as exc:
            if trace is not None:
                trace.finish(status=exc.status, reason=exc.reason)
            raise
        ticket.trace = trace
        if trace is not None:
            trace.add_span(
                "serve.admission",
                started,
                max(0.0, time.time() - started),
                inflight=self._inflight,
            )
        return ticket

    async def _admit(self, route: str, nbytes: int, deadline: Deadline):
        import asyncio

        now = self._clock()
        with self._lock:
            if not self.enabled:
                self._note_delay_locked(0.0, now)
                return self._grant_locked(route, nbytes, now)
            if self._draining:
                raise DrainingError(
                    "webserver is draining (shutdown or live handoff)",
                    retry_after_s=self._retry_after_locked(),
                )
            if self._has_capacity_locked(nbytes) and not self._waiters:
                self._note_delay_locked(0.0, now)
                return self._grant_locked(route, nbytes, now)
            # would queue: degraded mode sheds newest instead of queuing
            if self._degraded:
                retry = self._retry_after_locked()
                self._shed_locked("degraded", route)
                raise OverloadedError(
                    "load shedder engaged (sustained queue delay)",
                    retry_after_s=retry,
                )
            if len(self._waiters) >= self.queue_limit:
                retry = self._retry_after_locked()
                self._shed_locked("queue-full", route)
                raise OverloadedError(
                    "admission queue full", retry_after_s=retry
                )
            loop = asyncio.get_running_loop()
            waiter = _Waiter(
                route, nbytes, deadline, now, loop, loop.create_future()
            )
            self._waiters.append(waiter)
            self._gauge_locked()
        try:
            remaining = max(0.0, deadline.remaining_s(self._clock()))
            return await asyncio.wait_for(waiter.future, timeout=remaining)
        except asyncio.TimeoutError:
            with self._lock:
                try:
                    self._waiters.remove(waiter)
                except ValueError:
                    pass  # granted in the race window; ticket reclaimed below
                self._gauge_locked()
            # the grant callback reclaims the ticket if it lost the race
            # (waiter.future is cancelled by wait_for)
            note_deadline_shed("queue")
            raise DeadlineExceededError(
                "deadline lapsed waiting for an in-flight slot"
            ) from None
        except ServeRejected:
            raise

    def release(
        self,
        ticket: _Ticket,
        *,
        code: int = 200,
        latency_ms: float | None = None,
    ) -> None:
        """Return an admitted request's budget; pump the pending queue."""
        grants: list[tuple[_Waiter, _Ticket]] = []
        now = self._clock()
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            self._inflight_bytes = max(0, self._inflight_bytes - ticket.nbytes)
            self._outstanding.pop(id(ticket), None)
            if latency_ms is not None and code == 200:
                self._lat_ms.append(float(latency_ms))
            grants = self._pump_locked(now)
            self._gauge_locked()
            self._check_drained_locked(now)
        for waiter, granted in grants:
            self._deliver(waiter, granted)

    def _pump_locked(self, now: float) -> list[tuple[_Waiter, _Ticket]]:
        """Grant queued waiters while capacity lasts; expired waiters are
        failed in place (their slot is never wasted on a dead request)."""
        grants: list[tuple[_Waiter, _Ticket]] = []
        while self._waiters:
            head = self._waiters[0]
            if head.deadline.expired(now):
                self._waiters.popleft()
                self._fail_waiter(head)
                continue
            if not self._has_capacity_locked(head.nbytes):
                break
            self._waiters.popleft()
            waited_ms = max(0.0, (now - head.enqueued_at) * 1000.0)
            self._note_delay_locked(waited_ms, now)
            self._reg.histogram(
                "serve.queue.wait.ms",
                "admission queue wait (ms)",
                buckets=metrics_mod.MS_BUCKETS,
            ).observe(waited_ms)
            grants.append((head, self._grant_locked(head.route, head.nbytes, now)))
        return grants

    def _deliver(self, waiter: _Waiter, ticket: _Ticket) -> None:
        def grant():
            if waiter.future.done():
                # the waiter timed out between grant and delivery: put the
                # budget back and pass it on
                self.release(ticket, code=0)
            else:
                waiter.future.set_result(ticket)

        try:
            waiter.loop.call_soon_threadsafe(grant)
        except RuntimeError:
            # waiter's loop is gone (webserver died): reclaim the budget
            self.release(ticket, code=0)

    def _fail_waiter(self, waiter: _Waiter) -> None:
        note_deadline_shed("queue")

        def fail():
            if not waiter.future.done():
                waiter.future.set_exception(
                    DeadlineExceededError(
                        "deadline lapsed waiting for an in-flight slot"
                    )
                )

        try:
            waiter.loop.call_soon_threadsafe(fail)
        except RuntimeError:
            pass

    # -- shedding hysteresis ----------------------------------------------

    def _effective_delay_ms(self, queue_delay_ms: float, now: float) -> float:
        fn = self._pressure
        if fn is not None:
            try:
                staleness_s = fn()
            except Exception:  # noqa: BLE001 - a sensor must never break admission
                staleness_s = 0.0
            if staleness_s and math.isfinite(staleness_s):
                # an idle gap also grows output staleness (no input ->
                # frozen watermark), and idleness is not overload: the
                # pipeline-pressure signal is clamped to the age of the
                # oldest admitted request still unanswered, so staleness
                # counts only while admitted work has actually been
                # outstanding that long
                if self._outstanding:
                    oldest_s = max(0.0, now - min(self._outstanding.values()))
                    pressure_s = min(staleness_s, oldest_s)
                else:
                    pressure_s = 0.0
                return max(queue_delay_ms, pressure_s * 1000.0)
        return queue_delay_ms

    def _note_delay_locked(self, queue_delay_ms: float, now: float) -> None:
        """CoDel-style: delay sustained above target for ``shed_dwell_s``
        engages degraded mode; back under target for ``recover_s``
        disengages it.  Any dip resets the opposing clock."""
        delay = self._effective_delay_ms(queue_delay_ms, now)
        if delay > self.target_delay_ms:
            self._calm_since = None
            if self._over_since is None:
                self._over_since = now
            elif (
                not self._degraded
                and now - self._over_since >= self.shed_dwell_s
            ):
                self._degraded = True
                self._transition_locked(1.0)
        else:
            self._over_since = None
            if self._degraded:
                if self._calm_since is None:
                    self._calm_since = now
                elif now - self._calm_since >= self.recover_s:
                    self._degraded = False
                    self._calm_since = None
                    self._transition_locked(0.0)

    def observe_pressure(self, now: float | None = None) -> None:
        """Feed the shedder outside an admission event (periodic poll —
        lets sustained *pipeline* pressure engage shedding even while
        the admission queue itself is empty)."""
        if now is None:
            now = self._clock()
        with self._lock:
            self._note_delay_locked(0.0, now)

    def _transition_locked(self, to: float) -> None:
        self._reg.gauge(
            "serve.degraded", "1 while the load shedder is engaged"
        ).set(to)
        self._reg.counter(
            "serve.degraded.transitions", "degraded engage/disengage edges"
        ).inc()

    def _shed_locked(self, reason: str, route: str) -> None:
        self._reg.counter(
            "serve.shed", "requests shed before pipeline work", reason=reason
        ).inc()

    # -- Retry-After -------------------------------------------------------

    def _retry_after_locked(self) -> float:
        """Seconds the client should back off: observed p50 latency scaled
        by how much admitted+queued work is ahead of it, clamped [1, 30]."""
        if self._lat_ms:
            ordered = sorted(self._lat_ms)
            p50_ms = ordered[len(ordered) // 2]
        else:
            p50_ms = 1000.0
        ahead = self._inflight + len(self._waiters) + 1
        est_s = (p50_ms / 1000.0) * ahead / max(1, self.inflight_limit)
        return float(min(30.0, max(1.0, math.ceil(est_s))))

    def retry_after_s(self) -> float:
        with self._lock:
            return self._retry_after_locked()

    # -- drain -------------------------------------------------------------

    def begin_drain(self, now: float | None = None) -> None:
        """Stop accepting (new arrivals get 503) and start the bounded
        in-flight drain window.  Idempotent."""
        if now is None:
            now = self._clock()
        fail: list[_Waiter] = []
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._drain_started = now
            self._drain_deadline = now + self.drain_s
            # queued waiters cannot be admitted any more: answer them now
            fail = list(self._waiters)
            self._waiters.clear()
            self._reg.gauge(
                "serve.draining", "1 while the webserver is draining"
            ).set(1.0)
            self._check_drained_locked(now)
        for w in fail:
            self._shed_drain_waiter(w)

    def _shed_drain_waiter(self, waiter: _Waiter) -> None:
        self._reg.counter(
            "serve.shed", "requests shed before pipeline work",
            reason="draining",
        ).inc()

        def fail():
            if not waiter.future.done():
                waiter.future.set_exception(
                    DrainingError(
                        "webserver is draining (shutdown or live handoff)"
                    )
                )

        try:
            waiter.loop.call_soon_threadsafe(fail)
        except RuntimeError:
            pass

    def _check_drained_locked(self, now: float) -> None:
        if not self._draining or self._drain_recorded:
            return
        if self._inflight == 0 and not self._waiters:
            self._drain_recorded = True
            self._drained_evt.set()
            started = self._drain_started
            if started is not None:
                self._reg.histogram(
                    "serve.drain.ms",
                    "drain start to last in-flight completion (ms)",
                    buckets=metrics_mod.MS_BUCKETS,
                ).observe(max(0.0, (now - started) * 1000.0))

    def drain_ready(self, now: float | None = None) -> bool:
        """True once the drain may be considered complete: every in-flight
        request answered, or the ``PATHWAY_SERVE_DRAIN_S`` budget blown
        (counted — a handoff must not wait forever on a wedged client)."""
        if now is None:
            now = self._clock()
        with self._lock:
            if not self._draining:
                return False
            self._check_drained_locked(now)
            if self._drained_evt.is_set():
                return True
            if self._drain_deadline is not None and now >= self._drain_deadline:
                self._shed_locked("drain-timeout", "*")
                return True
            return False

    def wait_drained(self, timeout: float) -> bool:
        """Block (bounded) until the in-flight set drains to zero."""
        return self._drained_evt.wait(timeout=timeout)

    def end_drain(self) -> None:
        """Re-open admission (tests / aborted handoff)."""
        with self._lock:
            self._draining = False
            self._drain_started = None
            self._drain_deadline = None
            self._drain_recorded = False
            self._drained_evt.clear()
            self._reg.gauge(
                "serve.draining", "1 while the webserver is draining"
            ).set(0.0)

    # -- chaos: synthetic flood -------------------------------------------

    def inject_flood(self, count: int, hold_s: float) -> None:
        """``request_flood`` chaos: claim ``count`` synthetic in-flight
        slots for ``hold_s`` — competing traffic without real sockets, so
        chaos tests drive deterministic 429/queue behavior."""
        count = max(1, int(count))
        with self._lock:
            self._inflight += count
            self._gauge_locked()
        self._reg.counter(
            "serve.flood.synthetic", "synthetic flood admissions injected"
        ).inc(count)

        def _release():
            grants: list[tuple[_Waiter, _Ticket]] = []
            now = self._clock()
            with self._lock:
                self._inflight = max(0, self._inflight - count)
                grants = self._pump_locked(now)
                self._gauge_locked()
                self._check_drained_locked(now)
            for waiter, granted in grants:
                self._deliver(waiter, granted)

        t = threading.Timer(max(0.0, hold_s), _release)
        t.daemon = True
        t.start()

    # -- quarantine --------------------------------------------------------

    def quarantine(self, key: int, message: str) -> None:
        with self._lock:
            self._quarantine.append(
                {"key": int(key), "error": str(message)[:300], "ts": time.time()}
            )
            self._quarantined_total += 1
        self._reg.counter(
            "serve.quarantined", "request rows failed by the pipeline"
        ).inc()

    # -- observability -----------------------------------------------------

    def _gauge_locked(self) -> None:
        self._reg.gauge(
            "serve.inflight", "admitted, unanswered REST requests"
        ).set(float(self._inflight))
        self._reg.gauge(
            "serve.inflight.bytes", "in-flight request-body bytes"
        ).set(float(self._inflight_bytes))
        self._reg.gauge(
            "serve.queue.depth", "requests waiting for admission"
        ).set(float(len(self._waiters)))

    def state_metrics(self) -> dict[str, float]:
        """Pull-time gauges for the ``serve.state`` collector."""
        with self._lock:
            return {
                "serve.inflight": float(self._inflight),
                "serve.inflight.bytes": float(self._inflight_bytes),
                "serve.queue.depth": float(len(self._waiters)),
                "serve.degraded": 1.0 if self._degraded else 0.0,
                "serve.draining": 1.0 if self._draining else 0.0,
            }

    def snapshot(self) -> dict[str, Any]:
        """Flight-recorder payload: state + knobs + the quarantine tail."""
        with self._lock:
            lat = sorted(self._lat_ms)
            p50 = lat[len(lat) // 2] if lat else None
            return {
                "inflight": self._inflight,
                "inflight_bytes": self._inflight_bytes,
                "queue_depth": len(self._waiters),
                "degraded": self._degraded,
                "draining": self._draining,
                "enabled": self.enabled,
                "latency_p50_ms": p50,
                "limits": {
                    "inflight": self.inflight_limit,
                    "inflight_bytes": self.inflight_bytes_limit,
                    "queue": self.queue_limit,
                    "target_delay_ms": self.target_delay_ms,
                },
                "quarantined_total": self._quarantined_total,
                "quarantine": list(self._quarantine)[-5:],
            }


# ---------------------------------------------------------------------------
# process-global controller
# ---------------------------------------------------------------------------

_controller: AdmissionController | None = None
_controller_lock = threading.Lock()


def get_controller() -> AdmissionController:
    """The process-global admission controller, built from the declared
    ``PATHWAY_SERVE_*`` knobs on first use (the REST ingress path)."""
    global _controller
    c = _controller
    if c is not None:
        return c
    with _controller_lock:
        if _controller is None:
            c = AdmissionController(
                inflight_limit=env_int("PATHWAY_SERVE_INFLIGHT"),
                inflight_bytes=int(
                    env_float("PATHWAY_SERVE_INFLIGHT_MB") * 1024 * 1024
                ),
                queue_limit=env_int("PATHWAY_SERVE_QUEUE"),
                target_delay_ms=env_float("PATHWAY_SERVE_QUEUE_DELAY_MS"),
                shed_dwell_s=env_float("PATHWAY_SERVE_SHED_DWELL_S"),
                recover_s=env_float("PATHWAY_SERVE_RECOVER_S"),
                drain_s=env_float("PATHWAY_SERVE_DRAIN_S"),
                enabled=env_bool("PATHWAY_SERVE_ADMISSION"),
            )
            metrics_mod.get_registry().register_collector(
                "serve.state", c.state_metrics
            )
            _adopt_pending_pressure(c)
            _controller = c
        return _controller


def controller_if_active() -> AdmissionController | None:
    """The controller if any REST route ever initialized it — never
    creates one (non-serving runs must stay zero-cost)."""
    return _controller


def snapshot_or_none() -> dict[str, Any] | None:
    """Flight-recorder serving supplier (runner wires it per run)."""
    c = _controller
    return c.snapshot() if c is not None else None


def set_pressure_supplier(fn: Callable[[], float] | None) -> None:
    """Wire the freshness sensor (worst output staleness, seconds)
    into the shedder; the runner sets/clears it around each run."""
    c = _controller
    if c is not None:
        c.set_pressure_supplier(fn)
    global _pending_pressure
    _pending_pressure = fn


# a run may wire the sensor before the first request builds the controller
_pending_pressure: Callable[[], float] | None = None


def _adopt_pending_pressure(c: AdmissionController) -> None:
    if _pending_pressure is not None:
        c.set_pressure_supplier(_pending_pressure)


def ready_for_handoff() -> bool:
    """The runner's live-handoff gate (called at the epoch boundary, so it
    must never block): on first call under an in-flight serving load it
    begins the stop-accept drain and reports False — the epoch loop keeps
    processing so in-flight requests can complete — then True once every
    request is answered or the drain budget lapses.  Without an active
    serving controller it is True immediately."""
    c = _controller
    if c is None:
        return True
    c.begin_drain()
    return c.drain_ready()


def fail_inflight_for_promotion() -> int:
    """A peer died and this worker is unwinding its mesh for an
    in-process promotion rejoin: every registered in-flight request is
    waiting on epochs the poisoned mesh will never run.  Answer them all
    NOW with the typed 503 retry signal — a well-behaved client retries
    after promotion completes (sub-second) instead of timing out across
    the rejoin — and park new arrivals behind the drain gate until
    :func:`resume_after_promotion` re-opens admission.  Returns the
    number of requests answered."""
    c = _controller
    if c is not None:
        c.begin_drain()
    with _requests_lock:
        keys = list(_requests)
    failed = 0
    for key in keys:
        if fail_request(
            key, 503,
            "standby promotion in progress on this worker group; retry",
        ):
            failed += 1
    if failed:
        metrics_mod.get_registry().counter(
            "serve.shed", "requests shed before pipeline work",
            reason="promotion",
        ).inc(failed)
    return failed


def resume_after_promotion() -> None:
    """Re-open admission after a promotion rejoin (the ``run()`` wrapper
    calls this between mesh lifetimes; the controller is process-global
    and survives the rejoin, so its drain gate must be reset here)."""
    c = _controller
    if c is not None:
        c.end_drain()


def reset_for_tests() -> None:
    """Drop the process-global controller + request registry (tests)."""
    global _controller, _pending_pressure
    with _controller_lock:
        if _controller is not None:
            metrics_mod.get_registry().unregister_collector("serve.state")
        _controller = None
        _pending_pressure = None
    with _requests_lock:
        _requests.clear()


# ---------------------------------------------------------------------------
# chaos fault hooks (engine/faults.py kinds: request_flood, slow_handler)
# ---------------------------------------------------------------------------


def maybe_flood(route: str) -> None:
    """``request_flood`` injection site: a firing spec saturates the whole
    admission budget (in-flight limit worth of synthetic requests) for
    ``delay_ms`` (default 1000) — the 2×-capacity wall chaos tests push
    against."""
    from pathway_tpu_torch.engine import faults

    spec = faults.check("request_flood", source=route)
    if spec is None:
        return
    c = get_controller()
    hold_ms = spec.delay_ms if spec.delay_ms else 1000.0
    c.inject_flood(c.inflight_limit, hold_ms / 1000.0)


def slow_handler_delay_s(route: str) -> float:
    """``slow_handler`` injection site: seconds the REST handler should
    stall (async, budget held) before emitting the row — drives queue
    delay up so shedding/degraded paths fire deterministically."""
    from pathway_tpu_torch.engine import faults

    spec = faults.check("slow_handler", source=route)
    if spec is None:
        return 0.0
    return (spec.delay_ms or 0.0) / 1000.0
