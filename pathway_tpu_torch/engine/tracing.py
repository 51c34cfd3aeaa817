"""Request-scoped tracing for the serving path.

A copy of ``pathway_tpu/engine/tracing.py``: a :class:`RequestTrace` —
W3C ``traceparent`` accepted on ingress, minted otherwise — is created by
the admission controller (``engine/serving.py``) and propagated through
the REST handler (``io/http/_server.py``), the connector row stamp
(``_pw_trace`` next to ``_pw_deadline_ts``), the dataflow's async-UDF node
(:func:`bind_key`), the coalescing ``AsyncMicroBatcher``
(``utils/batching.py``), ``DeviceExecutor`` submit and dispatch
(``device/executor.py``) and the continuous-batching
``GenerationScheduler`` (``serving/generation.py``).  Every stage records
a child span with ids minted at creation, so a slow request decomposes
into admission, staging, pipeline, coalesce, device job and dispatch,
queue, prefill and decode.  Finished traces land in a bounded
in-process ring (:func:`recent_requests`, :func:`slowest_requests`,
:func:`snapshot`).

Propagation is ambient (a contextvar scope, :func:`trace_scope`) for
same-thread stages and explicit (the trace rides the row stamp, the key
binding or the generation request) across thread hops.

``PATHWAY_TRACE_REQUESTS=0`` turns the whole layer off.  The runner wires
the run's telemetry exporter (``engine/telemetry.py``) with
:func:`set_exporter`, so spans ride its bounded export queue as well as
the ring.
"""

from __future__ import annotations

import secrets
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from typing import Any

from pathway_tpu_torch.engine import metrics as _metrics
from pathway_tpu_torch.internals.config import env_bool, env_int

__all__ = [
    "TRACE_STAMP",
    "RequestTrace",
    "active_trace",
    "begin_request",
    "current_trace",
    "enabled",
    "maybe_trace_storm",
    "recent_requests",
    "reset_for_tests",
    "set_exporter",
    "slowest_requests",
    "snapshot",
    "trace_scope",
]

# the connector row stamp — rides REST rows next to ``_pw_deadline_ts``
TRACE_STAMP = "_pw_trace"

# per-trace span cap: overflow drops the newest span and counts it
MAX_SPANS_PER_TRACE = 64

# deep-tree shape of one ``trace_storm`` synthetic trace
STORM_TREE_DEPTH = 12
STORM_DEFAULT_TRACES = 64


def enabled() -> bool:
    """Request tracing on? (``PATHWAY_TRACE_REQUESTS``, default on)."""
    return env_bool("PATHWAY_TRACE_REQUESTS")


def _buffer_max() -> int:
    return max(1, int(env_int("PATHWAY_TRACE_BUFFER")))


def _root_trace_id(trace_parent: str | None) -> str | None:
    """trace-id field of a W3C ``traceparent`` header value."""
    if not trace_parent:
        return None
    parts = trace_parent.split("-")
    return parts[1] if len(parts) >= 3 and len(parts[1]) == 32 else None


def _parent_span_id(trace_parent: str | None) -> str:
    """span-id field of a W3C ``traceparent`` header value."""
    parts = (trace_parent or "").split("-")
    return parts[2] if len(parts) >= 4 and len(parts[2]) == 16 else ""


class RequestTrace:
    """One request's trace: a trace id, a root span, and child spans.

    ``finish()`` closes the root ``serve.request`` span and moves the
    trace into the bounded finished-request ring.
    """

    __slots__ = (
        "trace_id", "root_span_id", "parent_span_id", "route", "started",
        "spans", "duration_s", "status", "_lock", "_finished", "_dropped",
        "attributes",
    )

    def __init__(self, route: str, trace_parent: str | None = None):
        self.trace_id = _root_trace_id(trace_parent) or secrets.token_hex(16)
        self.parent_span_id = _parent_span_id(trace_parent)
        self.root_span_id = secrets.token_hex(8)
        self.route = route
        self.started = time.time()
        self.spans: list[dict] = []
        self.duration_s: float | None = None
        self.status: Any = None
        self.attributes: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._finished = False
        self._dropped = 0

    def traceparent(self) -> str:
        """The W3C header value downstream stages propagate."""
        return f"00-{self.trace_id}-{self.root_span_id}-01"

    def add_span(
        self,
        name: str,
        start: float,
        duration_s: float,
        parent_span_id: str | None = None,
        **attributes: Any,
    ) -> str:
        """Record one finished child span (explicit timing); returns the
        minted span id so a caller can chain children."""
        span_id = secrets.token_hex(8)
        record = {
            "name": name,
            "start": start,
            "duration_s": duration_s,
            "attributes": attributes,
            "trace_parent": self.traceparent(),
            "trace_id": self.trace_id,
            "span_id": span_id,
            "parent_span_id": self.root_span_id if parent_span_id is None else parent_span_id,
        }
        with self._lock:
            if len(self.spans) >= MAX_SPANS_PER_TRACE:
                self._dropped += 1
                _metrics.get_registry().counter(
                    "trace.spans.dropped", "request spans dropped by the per-trace span cap"
                ).inc()
                return span_id
            self.spans.append(record)
        _metrics.get_registry().counter("trace.spans", "request-scoped spans recorded").inc()
        _export(record)
        return span_id

    @contextmanager
    def span(self, name: str, parent_span_id: str | None = None, **attributes: Any):
        """Timed child-span scope for same-thread stages."""
        start = time.time()
        try:
            yield
        finally:
            self.add_span(name, start, time.time() - start, parent_span_id=parent_span_id, **attributes)

    def finish(self, status: Any = None, **attributes: Any) -> None:
        """Close the root ``serve.request`` span and ring-buffer the
        trace.  Idempotent — the first close wins."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
            self.duration_s = time.time() - self.started
            self.status = status
            self.attributes.update(attributes)
        record = {
            "name": "serve.request",
            "start": self.started,
            "duration_s": self.duration_s,
            "attributes": {
                "route": self.route,
                **({"status": status} if status is not None else {}),
                **self.attributes,
            },
            "trace_parent": self.traceparent(),
            "trace_id": self.trace_id,
            "span_id": self.root_span_id,
            "parent_span_id": self.parent_span_id,
        }
        with self._lock:
            self.spans.append(record)
        _export(record)
        with _active_lock:
            _active.pop(self.trace_id, None)
        with _ring_lock:
            _ring.append(self.summary())

    def summary(self) -> dict[str, Any]:
        """JSON-able view of this trace (the ring's shape)."""
        with self._lock:
            spans = list(self.spans)
            dropped = self._dropped
        return {
            "trace_id": self.trace_id,
            "route": self.route,
            "start": self.started,
            "duration_s": self.duration_s,
            "status": self.status,
            "spans": spans,
            "spans_dropped": dropped,
        }


# ---------------------------------------------------------------------------
# Ambient propagation
# ---------------------------------------------------------------------------

_AMBIENT: ContextVar[RequestTrace | None] = ContextVar("pathway_request_trace", default=None)


def trace_scope(trace: RequestTrace | None):
    """Context manager binding ``trace`` as the ambient request trace
    (no-op for ``None`` — disabled tracing costs one branch)."""
    if trace is None:
        return nullcontext()
    return _scope(trace)


@contextmanager
def _scope(trace: RequestTrace):
    token = _AMBIENT.set(trace)
    try:
        yield trace
    finally:
        _AMBIENT.reset(token)


def current_trace() -> RequestTrace | None:
    """The ambient request trace of the calling context, if any."""
    return _AMBIENT.get()


def begin_request(route: str, trace_parent: str | None = None) -> RequestTrace | None:
    """Mint (or adopt) a request trace — ``None`` while tracing is off."""
    if not enabled():
        return None
    trace = RequestTrace(route, trace_parent)
    with _active_lock:
        if len(_active) < _ACTIVE_MAX:
            _active[trace.trace_id] = trace
    _metrics.get_registry().counter("trace.requests", "request traces created by the serving path").inc()
    return trace


# in-flight traces by trace id: a stage that only holds the row stamp
# (connector staging) attributes its span to the right trace
_ACTIVE_MAX = 4096
_active: dict[str, RequestTrace] = {}
_active_lock = threading.Lock()


def active_trace(trace_parent: str | None) -> RequestTrace | None:
    """The in-flight trace a ``_pw_trace`` row stamp refers to, if any."""
    trace_id = _root_trace_id(trace_parent)
    if not trace_id:
        return None
    with _active_lock:
        return _active.get(trace_id)


# in-flight traces by REQUEST ROW KEY: the REST ingress binds its row's
# key so the dataflow's async-UDF node (engine/dataflow.py) can re-enter
# the request's trace scope on the epoch thread
_by_key: dict[int, RequestTrace] = {}


def bind_key(key: int, trace: RequestTrace | None) -> None:
    if trace is None:
        return
    with _active_lock:
        if len(_by_key) < _ACTIVE_MAX:
            _by_key[key] = trace


def unbind_key(key: int) -> None:
    if not _by_key:
        return
    with _active_lock:
        _by_key.pop(key, None)


def trace_for_key(key: int) -> RequestTrace | None:
    """The trace bound to a request row key — one falsy dict check while
    nothing is serving."""
    if not _by_key:
        return None
    with _active_lock:
        return _by_key.get(key)


# ---------------------------------------------------------------------------
# Finished-request ring + export hook
# ---------------------------------------------------------------------------

_ring: deque[dict] = deque(maxlen=256)
_ring_lock = threading.Lock()
_exporter: Any = None


def set_exporter(telemetry: Any) -> None:
    """Wire (or clear, with ``None``) a telemetry exporter whose
    ``emit_span(record)`` receives every span, and resize the ring to
    ``PATHWAY_TRACE_BUFFER``."""
    global _exporter, _ring
    _exporter = telemetry
    with _ring_lock:
        size = _buffer_max()
        if _ring.maxlen != size:
            _ring = deque(list(_ring)[-size:], maxlen=size)


def _export(record: dict) -> None:
    exporter = _exporter
    if exporter is not None:
        try:
            exporter.emit_span(record)
        except Exception:  # noqa: BLE001 - tracing must never fail a request
            pass


def recent_requests(n: int = 20) -> list[dict]:
    """The newest ``n`` finished request traces, newest first."""
    with _ring_lock:
        items = list(_ring)
    return list(reversed(items))[:n]


def slowest_requests(n: int = 10) -> list[dict]:
    """The ``n`` slowest finished request traces, slowest first."""
    with _ring_lock:
        items = list(_ring)
    return sorted(items, key=lambda t: -(t.get("duration_s") or 0.0))[:n]


def requests_state() -> dict[str, float]:
    """Scalar gauges of the ring (the ``trace.requests.state`` collector)."""
    with _ring_lock:
        items = list(_ring)
    out = {"trace.requests.buffered": float(len(items))}
    if items:
        durations = [t.get("duration_s") or 0.0 for t in items]
        out["trace.requests.slowest.ms"] = max(durations) * 1000.0
        out["trace.requests.newest.ms"] = (items[-1].get("duration_s") or 0.0) * 1000.0
    return out


def snapshot() -> dict[str, Any]:
    """Ring occupancy plus the slowest and newest traces with their spans."""
    with _ring_lock:
        buffered = len(_ring)
    return {"buffered": buffered, "slowest": slowest_requests(10), "recent": recent_requests(10)}


def reset_for_tests() -> None:
    global _exporter
    _exporter = None
    with _ring_lock:
        _ring.clear()
    with _active_lock:
        _active.clear()
        _by_key.clear()


_metrics.get_registry().register_collector("trace.requests.state", requests_state)


# ---------------------------------------------------------------------------
# trace_storm chaos hook (engine/faults.py)
# ---------------------------------------------------------------------------


def maybe_trace_storm(route: str) -> int:
    """``trace_storm`` fault injection: burst N synthetic traced requests,
    each with a deep chained span tree.  Returns the number of synthetic
    traces emitted (0 = no fire)."""
    from pathway_tpu_torch.engine import faults

    spec = faults.check("trace_storm", source=route)
    if spec is None:
        return 0
    n = int(spec.count or STORM_DEFAULT_TRACES)
    now = time.time()
    for i in range(n):
        trace = RequestTrace(route or "storm")
        parent: str | None = None
        for depth in range(STORM_TREE_DEPTH):
            parent = trace.add_span(
                f"storm.depth.{depth}", now, 0.0, parent_span_id=parent, synthetic=True, storm_index=i
            )
        trace.finish(status="storm", synthetic=True)
    _metrics.get_registry().counter(
        "trace.storm.synthetic", "synthetic traces injected by the trace_storm chaos fault kind"
    ).inc(float(n))
    return n
