"""Request-trace propagation into the dataflow.

The part of ``pathway_tpu/engine/tracing.py`` that the dataflow's async-UDF
node reads: the ambient trace of the calling context (:func:`trace_scope`)
and the binding of a request row's key to its trace (:func:`bind_key`,
:func:`trace_for_key`).  A trace is any object the
serving edge mints; ``RequestTrace`` itself, its spans, the
finished-request ring and the export hook arrive with the observability
slice (H5).  While nothing binds a key every lookup is one falsy dict
check.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from typing import Any

_AMBIENT: ContextVar[Any] = ContextVar("pathway_request_trace", default=None)


def trace_scope(trace: Any):
    """Context manager binding ``trace`` as the ambient request trace
    (no-op for ``None`` — disabled tracing costs one branch)."""
    if trace is None:
        return nullcontext()
    return _scope(trace)


@contextmanager
def _scope(trace: Any):
    token = _AMBIENT.set(trace)
    try:
        yield trace
    finally:
        _AMBIENT.reset(token)


# in-flight traces by REQUEST ROW KEY: the REST ingress binds its row's
# key so the dataflow's async-UDF node (engine/dataflow.py) can re-enter
# the request's trace scope on the epoch thread
_ACTIVE_MAX = 4096
_by_key: dict[int, Any] = {}
_lock = threading.Lock()


def bind_key(key: int, trace: Any) -> None:
    if trace is None:
        return
    with _lock:
        if len(_by_key) < _ACTIVE_MAX:
            _by_key[key] = trace


def unbind_key(key: int) -> None:
    if not _by_key:
        return
    with _lock:
        _by_key.pop(key, None)


def trace_for_key(key: int) -> Any:
    """The trace bound to a request row key — ultra-cheap when serving
    is inactive (one falsy dict check)."""
    if not _by_key:
        return None
    with _lock:
        return _by_key.get(key)
