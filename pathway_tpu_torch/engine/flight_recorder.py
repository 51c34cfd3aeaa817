"""The flight recorder: a bounded ring of structured runtime events.

A slim copy of ``pathway_tpu/engine/flight_recorder.py``: ``record`` appends
one ``{"seq", "ts", "mono", "kind", ...}`` event to a process-wide ring
(the oldest falls out past ``DEFAULT_CAPACITY``), and ``events`` reads it.
The device layer records ``device.failure``, ``device.oom.ratchet``,
``device.breaker.open``/``close``, ``device.quarantine``,
``device.dispatch.restart``, ``fault.injected`` and ``fault.device_hang``
under the JAX package's names, and the generation scheduler sets its
snapshot as the recorder's generation supplier.  Dumping the ring into a
persistence root, and the other suppliers that ride a dump, wait for the
host-engine slice.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

DEFAULT_CAPACITY = 512


class FlightRecorder:
    """Bounded ring of ``{"seq", "ts", "mono", "kind", ...}`` events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._generation_supplier: Any = None

    def record(self, kind: str, **fields: Any) -> None:
        event = {"ts": time.time(), "mono": time.monotonic(), "kind": kind}
        event.update(fields)
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._ring.append(event)

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def set_generation_supplier(self, fn: Any) -> None:
        """Wire (or clear, with ``None``) the generation scheduler's
        snapshot, read by :meth:`generation_snapshot`."""
        self._generation_supplier = fn

    def generation_snapshot(self) -> dict[str, Any] | None:
        fn = self._generation_supplier
        return fn() if fn is not None else None


_recorder: FlightRecorder | None = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record(kind: str, **fields: Any) -> None:
    """Append one event to the process-wide ring (always cheap)."""
    get_recorder().record(kind, **fields)
