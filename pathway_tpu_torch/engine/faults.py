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

The worker, persistence, connector and serving kinds need the host engine
and wait for its slice of the port; a plan naming one raises ``ValueError``.
"""

from __future__ import annotations

import json as _json
import os
import random
import threading
from typing import Any

from pathway_tpu_torch.engine import flight_recorder as _blackbox

ENV_PLAN = "PATHWAY_FAULT_PLAN"
ENV_ATTEMPT = "PATHWAY_RESTART_ATTEMPT"

KINDS = ("device_stall", "device_error", "device_oom", "device_compile_fail", "device_hang")


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
        "key", "source", "attempt", "max_times", "seen", "fired", "_rng",
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
