"""Load-adaptive scale controller: the sensor→actuator loop made autonomous.

PR 9 built the sensors (``output.staleness.s``, ``backlog.*`` attribution
at every wait point) and PR 10 built the actuator (rescale-via-recovery
at N′ ≠ N with shard-range repartitioning); this module closes the loop.
The supervisor (``engine/supervisor.py``) runs one :class:`ScaleController`
beside its liveness watch: every poll it reads the per-worker **load
beacons** the runners drop beside the lease (``lease/load.<worker>`` —
plain advisory JSON, same contract as the progress beacons), feeds the
worst staleness + total backlog into :meth:`ScaleController.observe`, and
applies whatever decision comes back by initiating a **live shard
handoff** (see ``engine/persistence.py``'s handoff files) with automatic
fallback to the PR-10 restart-based rescale.

The controller itself is *pure decision logic over an injected clock* —
``observe(now, ...)`` takes the timestamp explicitly, so the hysteresis
unit tests (``tests/test_autoscaler.py``) drive years of synthetic load
in microseconds.  The policy, deliberately boring:

* **grow** — worst staleness above ``PATHWAY_AUTOSCALE_STALENESS_S``
  *continuously* for ``PATHWAY_AUTOSCALE_DWELL_S`` (one dip resets the
  clock) grows the target by one worker, up to ``_MAX_WORKERS``.
* **shrink** — staleness comfortably low (< half the grow threshold) AND
  backlog ~empty continuously for ``PATHWAY_AUTOSCALE_IDLE_S`` shrinks by
  one, never below ``_MIN_WORKERS`` (and never below 1 — the same floor
  degraded-mode shrink honors).
* **cooldown** — after any rescale, no decision in either direction for
  ``PATHWAY_AUTOSCALE_COOLDOWN_S``.  Dwell + cooldown together are the
  anti-flap guarantee: load oscillating across the threshold faster than
  the dwell window never triggers, and a triggered rescale cannot be
  immediately reversed.
* **budget** — at most ``PATHWAY_AUTOSCALE_BUDGET`` rescales per
  supervisor run.  Exhaustion is LOUD (``log.error``, a ``suppressed``
  decision entry, ``autoscaler.budget.exhausted`` metric) and then
  silent: the topology pins where it is.

Every decision — applied or suppressed — lands in a bounded provenance
log (:attr:`ScaleController.decisions`) that rides
``SupervisorResult.rescales``, flight-recorder dumps
(``set_autoscaler_supplier``), ``pathway_tpu_torch blackbox``, and the
``/status`` + ``pathway_tpu_torch top`` autoscaler panels via the state file
this module maintains at ``lease/autoscaler.json``.
"""

from __future__ import annotations

import logging
import os
import time as _time
from collections import deque
from typing import Any

from pathway_tpu_torch.engine import metrics as _registry
from pathway_tpu_torch.engine.persistence import (
    _lease_dir_read_json,
    _lease_dir_write_json,
)
from pathway_tpu_torch.internals.config import (
    env_bool,
    env_float,
    env_int,
)

_log = logging.getLogger("pathway_tpu_torch.autoscaler")

ENV_AUTOSCALE = "PATHWAY_AUTOSCALE"

LOAD_PREFIX = "lease/load."
STATE_KEY = "lease/autoscaler.json"

# a beacon older than this is a dead sensor, not a fresh reading: its
# staleness number is ignored (the liveness watchdog owns dead workers)
_BEACON_MAX_AGE_S = 10.0

_DECISION_LOG_CAP = 64


def autoscale_enabled() -> bool:
    return env_bool(ENV_AUTOSCALE)


# -- worker-side load beacons --
def write_load_beacon(
    root: str,
    worker: int,
    *,
    staleness_s: float,
    backlog: float,
    epochs: int,
) -> None:
    """Drop this worker's load reading beside the lease (advisory JSON,
    atomic tmp+rename — torn/missing degrades to 'no reading')."""
    _lease_dir_write_json(
        root,
        f"{LOAD_PREFIX}{worker}",
        {
            "worker": worker,
            "staleness_s": round(float(staleness_s), 3),
            "backlog": round(float(backlog), 1),
            "epochs": int(epochs),
            "at": _time.time(),
        },
    )


def read_load_beacons(root: str, workers: int) -> dict[int, dict]:
    """{worker: beacon} for every fresh, well-formed load beacon."""
    now = _time.time()
    out: dict[int, dict] = {}
    for w in range(workers):
        obj = _lease_dir_read_json(root, f"{LOAD_PREFIX}{w}")
        if (
            obj is not None
            and obj.get("worker") == w
            and isinstance(obj.get("staleness_s"), (int, float))
            and isinstance(obj.get("at"), (int, float))
            and now - obj["at"] <= _BEACON_MAX_AGE_S
        ):
            out[w] = obj
    return out


def clear_load_beacons(root: str, workers: int) -> None:
    """Drop stale beacons before relaunching at a new topology, so the
    first post-rescale poll cannot read the pre-rescale load."""
    for w in range(workers):
        path = os.path.join(root, *f"{LOAD_PREFIX}{w}".split("/"))
        try:
            os.remove(path)
        except OSError:
            pass


def worst_load(beacons: dict[int, dict]) -> tuple[float, float]:
    """(worst staleness, total backlog) over a beacon set — the two
    numbers the controller's policy runs on.  (0, 0) when no beacons
    are fresh: an instrumentation gap must read as 'calm', never as
    'scale!'."""
    if not beacons:
        return 0.0, 0.0
    staleness = max(float(b.get("staleness_s", 0.0)) for b in beacons.values())
    backlog = sum(float(b.get("backlog", 0.0)) for b in beacons.values())
    return staleness, backlog


class ScaleController:
    """Hysteresis + budget + cooldown over (staleness, backlog) readings.

    Pure logic: ``observe`` takes ``now`` explicitly (monotonic-like
    seconds; any consistent clock works) and returns either ``None`` or a
    decision dict ``{"action": "grow"|"shrink", "from": N, "to": N',
    ...provenance}``.  The caller applies the decision; the controller
    optimistically adopts the target as current (the actuator always ends
    at N′ — live handoff when it works, restart fallback when it
    doesn't)."""

    def __init__(
        self,
        *,
        current: int,
        min_workers: int | None = None,
        max_workers: int | None = None,
        staleness_hi_s: float | None = None,
        dwell_s: float | None = None,
        cooldown_s: float | None = None,
        idle_dwell_s: float | None = None,
        budget: int | None = None,
    ):
        def _f(v: float | None, env: str) -> float:
            return float(env_float(env) if v is None else v)

        self.min_workers = max(
            1,
            (
                env_int("PATHWAY_AUTOSCALE_MIN_WORKERS")
                if min_workers is None
                else min_workers
            ),
        )
        self.max_workers = max(
            self.min_workers,
            (
                env_int("PATHWAY_AUTOSCALE_MAX_WORKERS")
                if max_workers is None
                else max_workers
            ),
        )
        self.current = max(1, current)
        self.staleness_hi_s = _f(staleness_hi_s, "PATHWAY_AUTOSCALE_STALENESS_S")
        self.dwell_s = _f(dwell_s, "PATHWAY_AUTOSCALE_DWELL_S")
        self.cooldown_s = _f(cooldown_s, "PATHWAY_AUTOSCALE_COOLDOWN_S")
        self.idle_dwell_s = _f(idle_dwell_s, "PATHWAY_AUTOSCALE_IDLE_S")
        self.budget = (
            env_int("PATHWAY_AUTOSCALE_BUDGET") if budget is None else budget
        )
        self.budget_left = max(0, self.budget)
        # hysteresis state: when the grow/shrink condition STARTED holding
        # continuously (None = not holding), and when the post-rescale
        # cooldown expires
        self._hot_since: float | None = None
        self._idle_since: float | None = None
        self._cooldown_until = 0.0
        self._exhaustion_logged = False
        # bounded provenance log: every decision (applied, suppressed,
        # fallback notes from the supervisor) newest-last
        self.decisions: deque[dict] = deque(maxlen=_DECISION_LOG_CAP)
        # what the supervisor last told us about the actuator ("", then
        # "handoff-requested" / "handoff" / "fallback" / "done")
        self.handoff_state = ""
        self._m_decisions = _registry.get_registry().counter(
            "autoscaler.decisions",
            "scaling decisions fired (grow + shrink)",
        )
        self._m_exhausted = _registry.get_registry().counter(
            "autoscaler.budget.exhausted",
            "scaling decisions suppressed because the rescale budget "
            "was spent",
        )

    # -- policy --
    def observe(
        self, now: float, worst_staleness_s: float, backlog: float
    ) -> dict | None:
        """Feed one (staleness, backlog) reading; maybe return a decision.

        Must be called with a non-decreasing ``now``.  Returns None in the
        overwhelmingly common case (nothing sustained, cooling down, or
        within bounds)."""
        hot = worst_staleness_s > self.staleness_hi_s
        idle = (
            worst_staleness_s < self.staleness_hi_s * 0.5 and backlog <= 0.0
        )
        # dwell clocks run even through cooldown — a spike that persists
        # across a rescale's cooldown fires again the instant the cooldown
        # expires, without re-paying the dwell
        # None-checks, not truthiness: a dwell that started at clock 0.0
        # is still running (the clock is injected; 0.0 is a valid now)
        if hot:
            self._hot_since = now if self._hot_since is None else self._hot_since
        else:
            self._hot_since = None
        if idle:
            self._idle_since = (
                now if self._idle_since is None else self._idle_since
            )
        else:
            self._idle_since = None
        if now < self._cooldown_until:
            return None
        if (
            self._hot_since is not None
            and now - self._hot_since >= self.dwell_s
        ):
            return self._decide(
                now,
                "grow",
                min(self.current + 1, self.max_workers),
                f"staleness {worst_staleness_s:.1f}s > "
                f"{self.staleness_hi_s:.1f}s sustained "
                f"{now - self._hot_since:.1f}s",
                worst_staleness_s,
                backlog,
            )
        if (
            self._idle_since is not None
            and now - self._idle_since >= self.idle_dwell_s
        ):
            return self._decide(
                now,
                "shrink",
                max(self.current - 1, self.min_workers),
                f"idle (staleness {worst_staleness_s:.1f}s, backlog "
                f"{backlog:.0f}) sustained {now - self._idle_since:.1f}s",
                worst_staleness_s,
                backlog,
            )
        return None

    def _decide(
        self,
        now: float,
        action: str,
        target: int,
        reason: str,
        staleness: float,
        backlog: float,
    ) -> dict | None:
        if target == self.current:
            return None  # already pinned at the bound; nothing to do
        entry = {
            "at": now,
            "action": action,
            "from": self.current,
            "to": target,
            "reason": reason,
            "staleness_s": round(staleness, 3),
            "backlog": round(backlog, 1),
            "budget_left": self.budget_left,
        }
        if self.budget_left <= 0:
            # LOUD exhaustion, exactly once — then the controller goes
            # quiet and the topology pins where it is
            entry["action"] = f"suppressed-{action}"
            entry["reason"] = (
                f"rescale budget exhausted ({self.budget} spent); "
                f"wanted {action} {self.current}→{target}: {reason}"
            )
            if not self._exhaustion_logged:
                self._exhaustion_logged = True
                self._m_exhausted.inc()
                self.decisions.append(entry)
                _log.error(
                    "autoscaler: %s — topology pinned at %d worker(s) "
                    "until the next supervisor run",
                    entry["reason"], self.current,
                )
            return None
        self.budget_left -= 1
        self._m_decisions.inc()
        self.decisions.append(entry)
        self._cooldown_until = now + self.cooldown_s
        self._hot_since = self._idle_since = None
        _log.warning(
            "autoscaler: %s %d→%d (%s; budget left %d)",
            action, self.current, target, reason, self.budget_left,
        )
        self.current = target
        return entry

    def note(self, now: float, action: str, **fields: Any) -> None:
        """Append an actuator-side provenance entry (handoff outcome,
        fallback) to the decision log without consuming budget."""
        self.decisions.append({"at": now, "action": action, **fields})

    def cooldown_remaining(self, now: float) -> float:
        return max(0.0, self._cooldown_until - now)

    # -- observability --
    def snapshot(self, now: float) -> dict:
        """The autoscaler panel payload (also persisted as the state file
        the workers' flight-recorder supplier and /status section read)."""
        last = self.decisions[-1] if self.decisions else None
        return {
            "target_workers": self.current,
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "budget": self.budget,
            "budget_left": self.budget_left,
            "cooldown_remaining_s": round(self.cooldown_remaining(now), 2),
            "hot_for_s": round(
                now - self._hot_since if self._hot_since is not None else 0.0,
                2,
            ),
            "idle_for_s": round(
                now - self._idle_since
                if self._idle_since is not None
                else 0.0,
                2,
            ),
            "handoff_state": self.handoff_state,
            "last_decision": last,
            "decisions": list(self.decisions),
        }

    def write_state(self, root: str, now: float) -> None:
        """Persist the panel payload beside the lease (advisory JSON; the
        workers read it back for /status, top, and blackbox dumps)."""
        try:
            _lease_dir_write_json(
                root, STATE_KEY, {**self.snapshot(now), "at": _time.time()}
            )
        except OSError as exc:
            _log.warning(
                "autoscaler: failed to write state file under %s: %s",
                root, exc,
            )


def read_state_file(root: str) -> dict | None:
    """The supervisor-maintained autoscaler state, or None (solo runs,
    autoscaling off, or the file torn mid-write)."""
    return _lease_dir_read_json(root, STATE_KEY)


def clear_state_file(root: str) -> None:
    try:
        os.remove(os.path.join(root, *STATE_KEY.split("/")))
    except OSError:
        pass


def state_metrics(root: str) -> dict[str, float]:
    """Numeric ``autoscaler.*`` gauges derived from the state file — the
    registry collector each worker registers so the panel rides /status
    and /metrics scrapes without new plumbing."""
    state = read_state_file(root)
    if state is None:
        return {}
    phase = 0.0  # 0 steady, 1 hot-dwell, 2 cooldown, 3 handoff in flight
    if state.get("handoff_state") in ("handoff-requested", "handoff"):
        phase = 3.0
    elif float(state.get("cooldown_remaining_s") or 0.0) > 0.0:
        phase = 2.0
    elif float(state.get("hot_for_s") or 0.0) > 0.0:
        phase = 1.0
    out = {
        "autoscaler.target.workers": float(state.get("target_workers", 0)),
        "autoscaler.budget.left": float(state.get("budget_left", 0)),
        "autoscaler.cooldown.remaining.s": float(
            state.get("cooldown_remaining_s") or 0.0
        ),
        "autoscaler.phase": phase,
        "autoscaler.decisions.logged": float(
            len(state.get("decisions") or ())
        ),
    }
    last = state.get("last_decision")
    if isinstance(last, dict) and last.get("action"):
        # the action rides as a label so the text survives the numeric
        # scalar-metrics path into /status and the `top` panel
        out[f"autoscaler.last.decision{{action={last['action']}}}"] = float(
            last.get("to") or 0
        )
    return out


__all__ = [
    "ENV_AUTOSCALE",
    "ScaleController",
    "autoscale_enabled",
    "clear_load_beacons",
    "clear_state_file",
    "read_load_beacons",
    "read_state_file",
    "state_metrics",
    "worst_load",
    "write_load_beacon",
]
