"""Crash flight recorder: a bounded ring of structured runtime events.

A copy of ``pathway_tpu/engine/flight_recorder.py``.  Every notable state transition (epoch starts, commit-barrier
publishes, comm link drops and reconnects, injected faults, restart
attempts, device failures) is appended to a bounded in-memory ring.  When
a worker crashes or a fault fires, the ring is dumped as JSON to
``<persistence root>/blackbox/``, so the supervisor
(``engine/supervisor.py``) can gather every worker's last seconds into
``SupervisorResult.post_mortem`` (:func:`gather_dumps`,
:func:`summarize_dumps`) and ``python -m pathway_tpu_torch blackbox`` can
pretty-print them long after the processes are gone.

The recorder is process-global and always records in memory; dumping
requires a configured filesystem root (the runner wires it when the run
persists to a ``FileBackend``).  SIGKILL-style injected crashes dump
before the kill (``engine/faults.py``); real uncaught failures dump from
the runner's failure path.  A dump carries the profiler, freshness,
device, autoscaler, serving, generation, request-trace and SLO
suppliers' snapshots.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any

DEFAULT_CAPACITY = 512
_DUMP_DIR = "blackbox"


class FlightRecorder:
    """Bounded ring of ``{"seq", "ts", "mono", "kind", ...}`` events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        # reentrant: the watchdog's SIGUSR1 handler (internals/runner.py)
        # calls record()/dump() on the MAIN thread and may interrupt a
        # record() that already holds this lock — a plain Lock would
        # deadlock the whole worker inside the signal handler
        self._lock = threading.RLock()
        self._seq = 0
        # dump context, set by configure(): without a root, record() still
        # works (post-mortems via the in-process API) but dump() no-ops
        self.root: str | None = None
        self.worker = 0
        self.run_id: str | None = None
        self.trace_parent: str | None = None
        self.attempt = 0
        # cluster incarnation of this process (PATHWAY_INCARNATION); when
        # set, dump() is FENCED like every other write to the persistence
        # root — a zombie from a superseded restart attempt must not drop
        # its stale story into the live cluster's blackbox/ directory
        # (the supervisor's post-mortem gather would misattribute it)
        self.incarnation = 0
        self._dumped: str | None = None  # path of the last dump, if any
        # optional profiler supplier (engine/profiler.py): every dump
        # carries a final top-N operator attribution snapshot, so a
        # post-mortem says where the time went, not just what happened
        self._profile_supplier: Any = None
        # optional freshness supplier (engine/freshness.py): final
        # watermark/backlog snapshot — what was STUCK, not just slow
        self._freshness_supplier: Any = None
        # optional device supplier (device/__init__.py
        # default_executor_snapshot): the final DeviceExecutor snapshot
        # (cost/utilization/padding/HBM/queue) — what the DEVICE was doing
        self._device_supplier: Any = None
        # optional autoscaler supplier (engine/autoscaler.py): the scale
        # controller's decision log + panel state — post-mortems say WHY
        # a rescale fired (or why one was suppressed)
        self._autoscaler_supplier: Any = None
        # optional serving supplier (engine/serving.py): the admission
        # controller's final state (in-flight/queue depth, degraded/
        # draining, quarantine tail) — post-mortems say what the SERVING
        # edge was refusing when the process died
        self._serving_supplier: Any = None
        # optional generation supplier (serving/generation.py): the
        # continuous-batching scheduler's slot/page-pool occupancy —
        # post-mortems say what the GENERATION loop was holding when
        # the process died
        self._generation_supplier: Any = None
        # optional tracing supplier (engine/tracing.py): the finished-
        # request ring (trace ids, durations, span trees), which
        # `python -m pathway_tpu_torch requests` re-renders from a dump
        self._tracing_supplier: Any = None
        # optional SLO supplier (engine/slo.py): declared objectives with
        # their burn rates and remaining budgets
        self._slo_supplier: Any = None

    # -- recording ---------------------------------------------------------
    def record(self, kind: str, **fields: Any) -> None:
        event = {
            "ts": time.time(),
            "mono": time.monotonic(),
            "kind": kind,
        }
        event.update(fields)
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._ring.append(event)

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def configure(
        self,
        *,
        root: str | None = None,
        worker: int | None = None,
        run_id: str | None = None,
        trace_parent: str | None = None,
        attempt: int | None = None,
        incarnation: int | None = None,
    ) -> None:
        """Attach dump context; each keyword only overwrites when given."""
        with self._lock:
            if root is not None:
                self.root = root
            if worker is not None:
                self.worker = worker
            if run_id is not None:
                self.run_id = run_id
            if trace_parent is not None:
                self.trace_parent = trace_parent
            if attempt is not None:
                self.attempt = attempt
            if incarnation is not None:
                self.incarnation = incarnation

    def set_profile_supplier(self, fn: Any) -> None:
        """Attach (or clear, with ``None``) the callable whose snapshot
        dict rides every subsequent dump under the ``profiler`` key.  The
        runner sets it for the run's lifetime and clears it on exit, so
        the global recorder never outlives a run's node arena."""
        self._profile_supplier = fn

    def set_freshness_supplier(self, fn: Any) -> None:
        """Attach (or clear) the callable whose watermark/backlog snapshot
        rides every subsequent dump under the ``freshness`` key (same
        lifetime contract as :meth:`set_profile_supplier`)."""
        self._freshness_supplier = fn

    def set_device_supplier(self, fn: Any) -> None:
        """Attach (or clear) the callable whose DeviceExecutor snapshot
        rides every subsequent dump under the ``device`` key (same
        lifetime contract as :meth:`set_profile_supplier`)."""
        self._device_supplier = fn

    def set_tracing_supplier(self, fn: Any) -> None:
        """Attach (or clear) the callable whose finished-request ring
        rides every subsequent dump under the ``requests`` key."""
        self._tracing_supplier = fn

    def set_slo_supplier(self, fn: Any) -> None:
        """Attach (or clear) the callable whose SLO snapshot (objectives,
        burn rates, remaining budgets) rides every subsequent dump under
        the ``slo`` key."""
        self._slo_supplier = fn

    def set_autoscaler_supplier(self, fn: Any) -> None:
        """Attach (or clear) the callable whose autoscaler state (decision
        log, target topology, handoff phase) rides every subsequent dump
        under the ``autoscaler`` key (set for a run's lifetime and cleared on exit) —
        post-mortems say why the cluster was scaling, not just that it died mid-rescale."""
        self._autoscaler_supplier = fn

    def set_serving_supplier(self, fn: Any) -> None:
        """Attach (or clear) the callable whose admission-controller
        snapshot (in-flight/queue occupancy, degraded/draining flags,
        quarantine tail) rides every subsequent dump under the
        ``serving`` key (set for a run's lifetime) — post-mortems say what
        the serving edge was shedding, not just that clients saw errors."""
        self._serving_supplier = fn

    def set_generation_supplier(self, fn: Any) -> None:
        """Attach (or clear) the callable whose generation-scheduler
        snapshot (slot occupancy, page-pool utilization, queue depth,
        live/peak KV bytes) rides every subsequent dump under the
        ``generation`` key (set for the scheduler's lifetime) —
        post-mortems say which requests held slots and pages, not just that tokens stopped."""
        self._generation_supplier = fn

    def generation_snapshot(self) -> dict[str, Any] | None:
        fn = self._generation_supplier
        return fn() if fn is not None else None

    # -- dumping -----------------------------------------------------------
    def dump(self, reason: str, *, suffix: str | None = None) -> str | None:
        """Write the ring to ``<root>/blackbox/worker-<id>.attempt-<n>.json``
        and return the path; None when no root is configured or the write
        fails (a dying process must never die *harder* because its black
        box could not be written).  The write is staged + renamed so the
        gatherer never reads a torn dump.

        ``suffix`` gives a dump its own file (``...attempt-<n>.<suffix>``)
        so it cannot clobber — or be clobbered by — the attempt's crash
        dump: the watchdog's SIGUSR1 dump uses it, because a worker that
        stalls, gets dumped, and is then killed must leave BOTH stories.

        Fenced like every persistence-root write: when this process
        carries an incarnation and the root's lease shows a newer one, the
        dump is refused — a zombie's stale ring must not pollute the live
        cluster's post-mortems."""
        with self._lock:
            root = self.root
            if not root:
                return None
            payload = {
                "worker": self.worker,
                "attempt": self.attempt,
                "run_id": self.run_id,
                "trace_parent": self.trace_parent,
                "incarnation": self.incarnation,
                "reason": reason,
                "pid": os.getpid(),
                "dumped_at": time.time(),
                "events": list(self._ring),
            }
            suppliers = (
                ("profiler", self._profile_supplier),
                ("freshness", self._freshness_supplier),
                ("device", self._device_supplier),
                ("autoscaler", self._autoscaler_supplier),
                ("serving", self._serving_supplier),
                ("generation", self._generation_supplier),
                ("requests", self._tracing_supplier),
                ("slo", self._slo_supplier),
            )
        # outside the lock (a supplier may scan the node arena) and never
        # fatal: a dump without a section beats no dump
        for key, fn in suppliers:
            if fn is None:
                continue
            try:
                section = fn()
            except Exception:  # noqa: BLE001 - forensics must never fail
                section = None
            if section:
                payload[key] = section
        if payload["incarnation"] and self._fenced(
            root, payload["incarnation"], payload["worker"]
        ):
            return None
        try:
            dump_dir = os.path.join(root, _DUMP_DIR)
            os.makedirs(dump_dir, exist_ok=True)
            name = f"worker-{payload['worker']}.attempt-{payload['attempt']}"
            name += f".{suffix}.json" if suffix else ".json"
            path = os.path.join(dump_dir, name)
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                # default=repr: an event carrying a non-JSON value must
                # degrade to its repr, never take the dump (or the
                # injected SIGKILL behind it) down with a TypeError
                json.dump(payload, f, default=repr)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._dumped = path
            return path
        except (OSError, ValueError):
            return None

    @staticmethod
    def _fenced(root: str, incarnation: int, worker: int) -> bool:
        """True when the root's lease shows a newer incarnation than ours.
        Best-effort and never raising: a dying process must still get its
        dump out when the lease is unreadable — only a POSITIVE newer-lease
        reading fences.  (Lazy import: persistence imports this module at
        load, so the dependency must stay one-way at import time.)"""
        try:
            from pathway_tpu_torch.engine import persistence as _pz

            lease = _pz.read_lease(_pz.FileBackend(root))
            if lease is not None and lease["incarnation"] > incarnation:
                from pathway_tpu_torch.engine import metrics as _metrics

                # same labeled series persistence._check_fence counts into
                _metrics.get_registry().counter(
                    "persistence.fenced",
                    "commit-point writes rejected because a newer "
                    "incarnation owns the root",
                    worker=worker,
                ).inc()
                return True
        except Exception:  # noqa: BLE001 - forensics must never fail
            pass
        return False

    @property
    def last_dump(self) -> str | None:
        return self._dumped


# ---------------------------------------------------------------------------
# Gathering (supervisor / CLI side)
# ---------------------------------------------------------------------------


def gather_dumps(root: str) -> dict[int, list[dict[str, Any]]]:
    """Read every flight-recorder dump under ``root`` into
    ``{worker: [dump payloads, oldest attempt first]}``.  Torn or
    unparseable files are skipped — post-mortem data is best-effort."""
    out: dict[int, list[dict[str, Any]]] = {}
    dump_dir = os.path.join(root, _DUMP_DIR)
    try:
        names = sorted(os.listdir(dump_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(dump_dir, name)
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        payload["path"] = path
        try:
            worker = int(payload.get("worker", -1))
        except (TypeError, ValueError):
            worker = -1  # hand-edited/foreign dump: keep it, unattributed
        out.setdefault(worker, []).append(payload)
    for dumps in out.values():
        dumps.sort(key=lambda d: (d.get("attempt", 0), d.get("dumped_at", 0.0)))
    return out


def summarize_dumps(
    dumps: dict[int, list[dict[str, Any]]], *, tail: int = 5
) -> dict[str, Any]:
    """Compact ``SupervisorResult.post_mortem`` form of gathered dumps:
    per-worker dump files, reasons, and the last few events of the most
    recent dump — enough to read the crash story without reopening the
    files (the full rings stay on disk for ``python -m pathway_tpu_torch blackbox``)."""
    workers: dict[int, dict[str, Any]] = {}
    for worker, payloads in sorted(dumps.items()):
        last = payloads[-1]
        events = last.get("events") or []
        workers[worker] = {
            "dumps": [p["path"] for p in payloads],
            "reasons": [p.get("reason") for p in payloads],
            "attempt": last.get("attempt"),
            "events_recorded": len(events),
            "last_events": [
                {
                    k: v
                    for k, v in ev.items()
                    if k not in ("mono",)
                }
                for ev in events[-tail:]
            ],
        }
    return {"workers": workers}


# ---------------------------------------------------------------------------
# Process-wide recorder
# ---------------------------------------------------------------------------

_recorder: FlightRecorder | None = None
# reentrant like FlightRecorder._lock: the SIGUSR1 handler calls
# get_recorder() on the main thread and may interrupt a first-call
# construction already inside this lock (reentry double-creates a
# recorder whose events are lost; a plain Lock deadlocks the handler)
_recorder_lock = threading.RLock()


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


def configure(**kwargs: Any) -> None:
    get_recorder().configure(**kwargs)


def dump(reason: str) -> str | None:
    """Dump the process-wide ring; see :meth:`FlightRecorder.dump`."""
    return get_recorder().dump(reason)
