"""Device-path fault tolerance: typed failure classes, retry policy,
circuit breaker and poisoned-batch quarantine.

Counterpart of ``pathway_tpu/device/resilience.py``: the same classes,
kinds, breaker state machine, retry schedule and quarantine records, so a
fault plan takes the same path through both packages.
``DeviceExecutor`` (``executor.py``) wraps them around every dispatch;
``PATHWAY_DEVICE_RESILIENCE=0`` removes the whole rail.

**Classification differs from the reference by design.**  The JAX
package wraps every XLA runtime error and every exception from a jax
module, defaulting an unrecognised one to a retryable transient.  On
CUDA that would be wrong, so :func:`classify` wraps exactly two things:

* ``torch.cuda.OutOfMemoryError`` becomes :class:`DeviceOOMError`: the
  executor splits the batch onto a smaller bucket and ratchets the
  callable's cap, as in the reference;
* :class:`InjectedDeviceError` (raised only by the fault plan) is read by
  the reference's message markers, so chaos tests take the same path in
  both packages.

Every other error propagates raw: unretried, never sent to a host
fallback, never counted as a device failure.  That covers
``torch.AcceleratorError`` and any ``RuntimeError`` reading "CUDA error"
(a CUDA context error is sticky: every later call on the context fails
too, so a retry cannot cure it), a hand kernel's own launch failure (a
kernel fault, which a fallback would hide), and a failure to build an
extension (a build fault).  They reach the caller as they were raised.
"""

from __future__ import annotations

import dataclasses
import random
import re
import threading
import time
from collections import deque
from typing import Any, Iterator

import torch

from pathway_tpu_torch.internals.config import env_float, env_int

__all__ = [
    "CircuitBreaker",
    "DeviceCompileError",
    "DeviceDispatchHangError",
    "DeviceJobError",
    "DeviceOOMError",
    "DeviceQuarantinedError",
    "ExecutorClosedError",
    "InjectedDeviceError",
    "QuarantineLog",
    "RetryPolicy",
    "TransientDeviceError",
    "classify",
]


# ---------------------------------------------------------------------------
# Typed failure classes
# ---------------------------------------------------------------------------


class DeviceJobError(RuntimeError):
    """Base of every typed device-path failure the executor raises;
    ``kind`` is the label on ``device.failures{kind=}`` and in events."""

    kind = "device"


class TransientDeviceError(DeviceJobError):
    """A failure worth retrying (bounded, jittered); persistent ones
    reach the breaker once the retries are spent."""

    kind = "transient"


class DeviceCompileError(DeviceJobError):
    """A deterministic compile failure of this cache key: never retried
    at the same shape; counts toward the breaker."""

    kind = "compile"


class DeviceOOMError(DeviceJobError):
    """Out of device memory.  Not retried at the same shape: the executor
    splits the batch onto a smaller bucket and ratchets the callable's
    largest bucket (``device.oom.splits`` / ``device.bucket.cap``)."""

    kind = "oom"


class DeviceDispatchHangError(DeviceJobError):
    """A dispatched job outlived the hard dispatch deadline
    (``PATHWAY_DEVICE_DISPATCH_DEADLINE_S``): its waiters get this error
    and the dispatch thread is written off and respawned."""

    kind = "hang"


class DeviceQuarantinedError(DeviceJobError):
    """The batch failed on the device and no host path could serve it
    (the fallback failed, or none was registered): it is recorded in the
    quarantine log and its waiters get this error."""

    kind = "quarantined"


class ExecutorClosedError(DeviceJobError):
    """``submit()``/``run_batch()`` after ``close()``, or a job failed
    because the executor shut down before running it."""

    kind = "closed"


class InjectedDeviceError(RuntimeError):
    """Raised only by the fault plan (``engine/faults.py``), never by real
    infrastructure; deliberately not a :class:`DeviceJobError`, so it
    enters the classifier as a raw device error would."""


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------

# the reference's message markers, checked in this order (most specific wins)
_OOM_MARKERS = ("resource_exhausted", "out of memory")
# bare "oom" only as a standalone word: a name embedding it (zoom, bloom)
# must not route a transient into the ratchet
_OOM_WORD = re.compile(r"\boom\b")
_COMPILE_MARKERS = ("compil", "lowering", "mosaic", "unimplemented")


def classify(exc: BaseException) -> DeviceJobError | None:
    """The typed failure for ``exc``, or ``None`` when it must propagate
    raw (see the module docstring).  An already-typed
    :class:`DeviceJobError` passes through unchanged."""
    if isinstance(exc, DeviceJobError):
        return exc
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return DeviceOOMError(str(exc))
    if not isinstance(exc, InjectedDeviceError):
        return None
    msg = str(exc)
    low = msg.lower()
    if any(m in low for m in _OOM_MARKERS) or _OOM_WORD.search(low):
        return DeviceOOMError(msg)
    if any(m in low for m in _COMPILE_MARKERS):
        return DeviceCompileError(msg)
    return TransientDeviceError(msg)


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded jittered retry for transient device failures: ``retries``
    extra attempts, each after a jittered exponential delay, all within
    ``deadline_s`` of wall clock."""

    retries: int = 2
    deadline_s: float = 30.0
    backoff_ms: float = 50.0

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(
            retries=max(0, int(env_int("PATHWAY_DEVICE_RETRIES"))),
            deadline_s=float(env_float("PATHWAY_DEVICE_RETRY_DEADLINE_S")),
            backoff_ms=float(env_float("PATHWAY_DEVICE_RETRY_BACKOFF_MS")),
        )

    def delays(self) -> Iterator[float]:
        """The schedule in seconds, one entry per retry: initial delay
        ``backoff_ms`` (at least 1 ms), doubling, jittered by up to half
        the initial delay, with the reference's integer rounding (a copy
        of ``ExponentialBackoffRetryStrategy.delays`` of the JAX package's
        ``internals/udfs/retries.py``)."""
        delay = max(1, int(self.backoff_ms)) / 1000.0
        jitter = max(0, int(self.backoff_ms // 2)) / 1000.0
        for _ in range(self.retries):
            yield delay + random.random() * jitter
            delay *= 2


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

# gauge encoding of breaker state (device.breaker.state{callable=})
STATE_CLOSED = 0.0
STATE_HALF_OPEN = 0.5
STATE_OPEN = 1.0


class CircuitBreaker:
    """Per-callable device/host routing decision.

    CLOSED: dispatch to the device.  ``threshold`` consecutive device
    failures (retries spent) trip it OPEN: dispatches route to the host
    fallback without touching the device.  After ``cooldown_s`` the next
    admit is one HALF-OPEN probe; its success closes the breaker, its
    failure re-opens it.  Decisions are made under one small lock that is
    never held around work."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 10.0):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.trips = 0  # lifetime count, for snapshots

    @classmethod
    def from_env(cls) -> "CircuitBreaker":
        return cls(
            threshold=int(env_int("PATHWAY_DEVICE_BREAKER_THRESHOLD")),
            cooldown_s=float(env_float("PATHWAY_DEVICE_BREAKER_COOLDOWN_S")),
        )

    def admit(self) -> str:
        """Route the next dispatch: ``"device"`` (closed), ``"probe"``
        (half-open trial; the caller reports its outcome) or
        ``"fallback"`` (open, or a probe already in flight)."""
        # lock-free fast path: a stale CLOSED read lets one extra dispatch
        # reach the device, whose failure is then recorded
        if self._state == STATE_CLOSED:
            return "device"
        with self._lock:
            if self._state == STATE_CLOSED:
                return "device"
            if self._state == STATE_OPEN:
                if time.monotonic() - self._opened_at < self.cooldown_s:
                    return "fallback"
                self._state = STATE_HALF_OPEN
                self._probe_inflight = True
                return "probe"
            if self._probe_inflight:
                return "fallback"
            self._probe_inflight = True
            return "probe"

    def record_success(self, *, probe: bool = False) -> bool:
        """A device dispatch succeeded; True when this closed a breaker
        that was not closed (the recovery transition)."""
        if not probe and self._state == STATE_CLOSED and self._consecutive == 0:
            return False
        with self._lock:
            recovered = self._state != STATE_CLOSED
            self._state = STATE_CLOSED
            self._consecutive = 0
            if probe:
                self._probe_inflight = False
            return recovered

    def abort_probe(self) -> None:
        """The in-flight probe's outcome will never be reported (a raw
        error escaped it, or the executor closed): release the slot so a
        later admit can probe again.  The state stays half-open."""
        with self._lock:
            self._probe_inflight = False

    def record_failure(self, *, probe: bool = False) -> bool:
        """A device dispatch failed (retries spent); True when this tripped
        the breaker open (closed to open, or a failed probe)."""
        with self._lock:
            self._consecutive += 1
            if probe:
                self._probe_inflight = False
                self._state = STATE_OPEN
                self._opened_at = time.monotonic()
                self.trips += 1
                return True
            if self._state == STATE_CLOSED and self._consecutive >= self.threshold:
                self._state = STATE_OPEN
                self._opened_at = time.monotonic()
                self.trips += 1
                return True
            return False

    def state_value(self) -> float:
        with self._lock:
            return self._state

    @staticmethod
    def _name_of(state: float) -> str:
        if state == STATE_OPEN:
            return "open"
        if state == STATE_HALF_OPEN:
            return "half-open"
        return "closed"

    def state_name(self) -> str:
        with self._lock:
            return self._name_of(self._state)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "state": self._name_of(self._state),
                "consecutive_failures": self._consecutive,
                "trips": self.trips,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
            }


# ---------------------------------------------------------------------------
# Quarantine log
# ---------------------------------------------------------------------------


class QuarantineLog:
    """Bounded record of poisoned batches (newest kept): the callable, the
    batch signature and both failure strings, never the row data."""

    def __init__(self, keep: int = 32):
        self._records: deque[dict[str, Any]] = deque(maxlen=max(1, int(keep)))
        self._lock = threading.Lock()
        self.total = 0

    @classmethod
    def from_env(cls) -> "QuarantineLog":
        return cls(keep=int(env_int("PATHWAY_DEVICE_QUARANTINE_KEEP")))

    def add(
        self,
        name: str,
        rows: int,
        arrays: tuple,
        device_error: BaseException | None,
        fallback_error: BaseException,
    ) -> dict[str, Any]:
        record = {
            "callable": name,
            "rows": int(rows),
            "shapes": [list(getattr(a, "shape", ())) for a in arrays],
            "dtypes": [str(getattr(a, "dtype", type(a).__name__)) for a in arrays],
            "device_error": (
                f"{type(device_error).__name__}: {device_error}"[:300]
                if device_error is not None
                else "(device not attempted: breaker open)"
            ),
            "fallback_error": f"{type(fallback_error).__name__}: {fallback_error}"[:300],
            "ts": time.time(),
        }
        with self._lock:
            self._records.append(record)
            self.total += 1
        return record

    def records(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)
