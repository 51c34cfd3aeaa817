"""Deterministic fault injection on the device path.

A copy of the plan machinery of ``pathway_tpu/engine/faults.py``
(``FaultSpec``, ``FaultPlan``, the process-wide active plan) with its five
device kinds; one plan JSON drives both packages the same way::

    {"seed": 7, "faults": [
        {"kind": "device_stall", "source": "encoder", "nth": 1, "delay_ms": 500},
        {"kind": "device_error", "source": "rowsum", "from_nth": 1, "max_times": 5},
        {"kind": "device_oom", "source": "rowsum", "nth": 2},
        {"kind": "device_compile_fail", "source": "rowsum", "nth": 1},
        {"kind": "device_hang", "source": "embed", "nth": 1, "delay_ms": 10000}
    ]}

``device_error``, ``device_oom`` and ``device_compile_fail`` fire inside
``DeviceExecutor._dispatch_fixed`` (``source`` filters on the registered
callable name) and raise an :class:`~pathway_tpu_torch.device.resilience.
InjectedDeviceError`, which the classifier reads by its message markers as
the JAX package does.  ``device_stall`` delays and ``device_hang`` wedges a
job on the dispatch thread (``source`` filters on the job name).

Matching: ``worker``/``peer``/``attempt`` match exactly when present
(``attempt`` against ``PATHWAY_RESTART_ATTEMPT``); ``key``/``source`` are
substring filters; ``nth`` fires once on the Nth matching event;
``from_nth`` fires on every matching event from the Nth on, bounded by
``max_times``; ``prob`` fires with that probability from a per-spec seeded
RNG.  A spec with none of these fires on the first match.  The plan is
installed by :func:`install_plan` or read once from ``PATHWAY_FAULT_PLAN``.

The serving kinds fire where the JAX package fires them:
``request_flood`` (``serving.maybe_flood``: saturates the admission budget
with synthetic in-flight requests for ``delay_ms``, default 1000) and
``slow_handler`` (``serving.slow_handler_delay_s``: the REST handler stalls
``delay_ms`` holding its admission slot), both on the REST ingress with
``source`` the route; ``request_churn`` (the generation scheduler's
admission: a burst of ``count``, default 4, short synthetic requests;
``source`` the model name); ``trace_storm`` (``tracing.maybe_trace_storm``:
``count``, default 64, synthetic deep traces; ``source`` the route).

The persistence kinds fire on the checkpoint path, as in the JAX package:
``blob_put``/``blob_get``/``blob_delete`` fail a backend call with
:class:`InjectedFault`, ``blob_torn``/``blob_truncate``/``blob_bitflip`` let
a write succeed with damaged bytes (``frac``, ``keep_bytes`` and ``bit``
shape the damage), all through :class:`FlakyBackend`, which the runner
puts around the storage when the plan names one (:func:`wrap_backend`);
``writer_crash`` SIGKILLs the process from a checkpoint writer thread
after a chunk is framed and before it is uploaded (``key`` filters on the
blob key).  The worker and connector kinds need the supervisor and the
multi-worker runner (slice H4b); a plan naming one raises ``ValueError``.
"""

from __future__ import annotations

import json as _json
import os
import random
import signal
import threading
from typing import Any

from pathway_tpu_torch.engine import flight_recorder as _blackbox
from pathway_tpu_torch.engine.persistence import BlobBackend

ENV_PLAN = "PATHWAY_FAULT_PLAN"
ENV_ATTEMPT = "PATHWAY_RESTART_ATTEMPT"

_BLOB_KINDS = ("blob_put", "blob_get", "blob_delete")
# write-corruption kinds: the I/O succeeds but the stored bytes are damaged
# (torn write / truncation / bit rot) — the persistence integrity frames
# must catch them on the read side
_BLOB_CORRUPT_KINDS = ("blob_torn", "blob_truncate", "blob_bitflip")
KINDS = _BLOB_KINDS + _BLOB_CORRUPT_KINDS + (
    "writer_crash",
    "device_stall", "device_error", "device_oom", "device_compile_fail", "device_hang",
    "request_flood", "slow_handler", "request_churn", "trace_storm",
)


class InjectedFault(IOError):
    """An error raised by the fault plan, never by real infrastructure."""


def restart_attempt() -> int:
    """Supervisor restart attempt of this process (0 = first launch)."""
    raw = os.environ.get(ENV_ATTEMPT, "").strip()
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0


class FaultSpec:
    """One declarative fault; counts its own matches and firings."""

    __slots__ = (
        "kind", "worker", "peer", "nth", "from_nth", "prob", "delay_ms",
        "key", "source", "attempt", "max_times", "frac", "keep_bytes", "bit",
        "count", "seen", "fired", "_rng",
    )

    def __init__(self, spec: dict[str, Any], *, seed: int, index: int):
        kind = spec.get("kind")
        if kind not in KINDS:
            raise ValueError(f"fault plan: unknown kind {kind!r} (valid: {', '.join(KINDS)})")
        self.kind = kind
        self.worker = spec.get("worker")
        self.peer = spec.get("peer")
        self.nth = spec.get("nth")
        self.from_nth = spec.get("from_nth")
        self.prob = spec.get("prob")
        self.delay_ms = float(spec.get("delay_ms", 0.0))
        self.key = spec.get("key")
        self.source = spec.get("source")
        self.attempt = spec.get("attempt")
        self.max_times = spec.get("max_times")
        # corruption-kind knobs (blob_torn / blob_truncate / blob_bitflip)
        self.frac = spec.get("frac")
        self.keep_bytes = spec.get("keep_bytes")
        self.bit = spec.get("bit")
        self.count = spec.get("count")
        if self.nth is None and self.from_nth is None and self.prob is None:
            self.nth = 1  # a bare spec fires once, on the first match
        self.seen = 0
        self.fired = 0
        # per-spec RNG: a prob-spec's firing pattern depends only on
        # (plan seed, spec position), never on other specs' interleaving
        self._rng = random.Random(f"{seed}:{index}")

    def _matches(self, ctx: dict[str, Any]) -> bool:
        if self.worker is not None and ctx.get("worker") != self.worker:
            return False
        if self.peer is not None and ctx.get("peer") != self.peer:
            return False
        if self.attempt is not None and restart_attempt() != self.attempt:
            return False
        if self.key is not None and self.key not in str(ctx.get("key", "")):
            return False
        if self.source is not None and self.source not in str(ctx.get("source", "")):
            return False
        return True

    def consider(self, ctx: dict[str, Any]) -> bool:
        """Record one matching event; True if the fault fires on it."""
        if not self._matches(ctx):
            return False
        self.seen += 1
        if self.max_times is not None and self.fired >= self.max_times:
            return False
        if self.nth is not None:
            fire = self.seen == self.nth
        elif self.from_nth is not None:
            fire = self.seen >= self.from_nth
        else:
            fire = self._rng.random() < self.prob
        if fire:
            self.fired += 1
        return fire

    def describe(self) -> str:
        parts = [self.kind]
        for name in ("worker", "peer", "nth", "from_nth", "prob", "key", "source"):
            v = getattr(self, name)
            if v is not None:
                parts.append(f"{name}={v}")
        return " ".join(parts)


class FaultPlan:
    """A seeded set of :class:`FaultSpec`; thread-safe, deterministic."""

    def __init__(self, faults: list[dict[str, Any]], *, seed: int = 0):
        self.seed = seed
        self.specs = [FaultSpec(s, seed=seed, index=i) for i, s in enumerate(faults)]
        self._kinds = {s.kind for s in self.specs}
        self._lock = threading.Lock()
        self.log: list[str] = []  # fired faults, for test assertions

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        obj = _json.loads(raw)
        if isinstance(obj, list):
            return cls(obj)
        return cls(obj.get("faults", []), seed=int(obj.get("seed", 0)))

    @classmethod
    def from_env(cls) -> "FaultPlan | None":
        raw = os.environ.get(ENV_PLAN)
        if not raw:
            return None
        return cls.from_json(raw)

    def has(self, *kinds: str) -> bool:
        return any(k in self._kinds for k in kinds)

    def check(self, kind: str, **ctx: Any) -> FaultSpec | None:
        """The firing spec for this event, or None: the first declared
        match fires, so exactly one spec fires per event."""
        if kind not in self._kinds:
            return None
        with self._lock:
            for spec in self.specs:
                if spec.kind == kind and spec.consider(ctx):
                    self.log.append(
                        f"{spec.describe()} @ " + ",".join(f"{k}={v}" for k, v in sorted(ctx.items()))
                    )
                    _blackbox.record("fault.injected", fault=kind, **ctx)
                    return spec
        return None


_active: FaultPlan | None = None
_env_loaded = False
_load_lock = threading.Lock()


def install_plan(plan: FaultPlan | None) -> None:
    """Set (or clear, with None) the process-wide plan; wins over the env."""
    global _active, _env_loaded
    with _load_lock:
        _active = plan
        _env_loaded = True


def clear_plan() -> None:
    """Forget any installed or env plan; the env is read again on next use."""
    global _active, _env_loaded
    with _load_lock:
        _active = None
        _env_loaded = False


def active_plan() -> FaultPlan | None:
    """The installed plan, else one parsed from ``PATHWAY_FAULT_PLAN``
    (cached): every injection site shares one plan and its counters."""
    global _active, _env_loaded
    if _env_loaded:
        return _active
    with _load_lock:
        if not _env_loaded:
            _active = FaultPlan.from_env()
            _env_loaded = True
    return _active


def check(kind: str, **ctx: Any) -> FaultSpec | None:
    plan = active_plan()
    if plan is None:
        return None
    return plan.check(kind, **ctx)


def maybe_crash_writer(*, worker: int, key: str) -> None:
    """Async-commit crash injection: SIGKILL from a checkpoint writer-pool
    thread MID-FLIGHT — after the artifact was framed and hashed, before
    its upload.  Some chunks of the staged generation may already be on the
    store, the generation manifest is not: the crash must leave only an
    unreferenced partial generation (invisible to resume and to
    ``python -m pathway_tpu_torch.cli scrub``).  The port's flight recorder
    records the crash and dumps nothing (the dump comes with slice H5)."""
    plan = active_plan()
    if plan is None or not plan.has("writer_crash"):
        return
    if plan.check("writer_crash", worker=worker, key=key) is not None:
        _blackbox.record("fault.writer_crash", worker=worker, key=key)
        os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------------------
# Flaky blob backend
# ---------------------------------------------------------------------------


class FlakyBackend(BlobBackend):
    """A ``BlobBackend`` wrapper that fails OR corrupts calls per the plan.

    Raising kinds (``blob_put``/``blob_get``/``blob_delete``) abort the
    call with :class:`InjectedFault`.  Corruption kinds (``blob_torn``,
    ``blob_truncate``, ``blob_bitflip``) let the write SUCCEED but damage
    the stored bytes — exactly what real storage faults look like to the
    process that wrote them, and what the persistence layer's integrity
    frames + generation manifests must catch on the read side.

    With no explicit ``plan`` the process-wide active plan is consulted at
    call time, so env-driven soak runs inject persistence faults without
    any code change (``wrap_backend`` below is applied by the runner).
    """

    def __init__(self, inner: BlobBackend, plan: FaultPlan | None = None):
        self.inner = inner
        self.plan = plan

    def describe(self) -> str:
        return self.inner.describe()

    def _active(self) -> FaultPlan | None:
        return self.plan if self.plan is not None else active_plan()

    def _gate(self, kind: str, key: str) -> None:
        plan = self._active()
        if plan is None:
            return
        if plan.check(kind, key=key) is not None:
            raise InjectedFault(f"injected {kind} failure for key {key!r}")

    def _mangle(self, key: str, data: bytes) -> bytes:
        """Apply write-corruption specs (torn / truncate / bitflip)."""
        plan = self._active()
        if plan is None:
            return data
        spec = plan.check("blob_torn", key=key)
        if spec is not None:
            frac = spec.frac if spec.frac is not None else 0.5
            data = data[: max(0, int(len(data) * float(frac)))]
        spec = plan.check("blob_truncate", key=key)
        if spec is not None:
            data = data[: int(spec.keep_bytes or 0)]
        spec = plan.check("blob_bitflip", key=key)
        if spec is not None and data:
            nbits = len(data) * 8
            bit = (
                int(spec.bit) if spec.bit is not None
                else spec._rng.randrange(nbits)
            ) % nbits
            mangled = bytearray(data)
            mangled[bit // 8] ^= 1 << (bit % 8)
            data = bytes(mangled)
        return data

    def put(self, key: str, data: bytes) -> None:
        self._gate("blob_put", key)
        self.inner.put(key, self._mangle(key, data))

    def put_atomic(self, key: str, data: bytes) -> None:
        self._gate("blob_put", key)
        self.inner.put_atomic(key, self._mangle(key, data))

    def put_staged(self, key: str, data: bytes) -> None:
        self._gate("blob_put", key)
        self.inner.put_staged(key, self._mangle(key, data))

    def sync_staged(self, keys: list[str]) -> None:
        self.inner.sync_staged(keys)

    def get(self, key: str) -> bytes | None:
        self._gate("blob_get", key)
        return self.inner.get(key)

    def list_keys(self, prefix: str) -> list[str]:
        return self.inner.list_keys(prefix)

    def delete(self, key: str) -> None:
        self._gate("blob_delete", key)
        self.inner.delete(key)


def wrap_backend(backend: BlobBackend) -> BlobBackend:
    """Wrap with FlakyBackend iff the active plan injects blob faults."""
    plan = active_plan()
    if plan is not None and plan.has(*_BLOB_KINDS, *_BLOB_CORRUPT_KINDS):
        return FlakyBackend(backend, plan)
    return backend
