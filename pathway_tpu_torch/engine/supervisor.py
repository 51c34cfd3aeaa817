"""Supervised crash recovery for the multi-worker runtime.

The reference framework's ancestor survives worker death because its
persistence layer can always rewind a worker group to the last committed
snapshot frontier (``src/persistence/tracker.rs``).  This module is the
process-level half of that story for this engine: a **supervisor** that
watches the N SPMD worker processes of a cluster and, on a confirmed
worker death, rolls the whole group back to the last committed
checkpoint and replays.

Why whole-group restart (and not patching one worker back in)?  The
epoch loop is BSP: every worker walks the identical DAG in lockstep and
the collectives pair up positionally.  When a worker dies mid-epoch, the
survivors hold in-memory operator state for epochs the dead worker never
committed — state a respawned worker cannot reproduce.  The only
consistent rollback point every worker agrees on is the last committed
checkpoint (``engine/persistence.py`` commits are per-worker atomic
metadata writes gated on processed epochs).  So the supervisor:

1. detects the death (nonzero or signal exit);
2. terminates the surviving workers (their un-committed progress is
   exactly what must be rolled back — killing them IS the rollback);
3. respawns all N workers with the same run id, ports, comm secret and
   persistence root, after a backoff (the shared ``udfs`` retry
   schedule).  Each worker resumes from its own committed snapshot
   shard: committed events replay into the input sessions, readers seek
   to the stored offset frontier, and the mesh re-forms.

Sinks re-open their output files on restart, so the recovered run's
final output is identical to an unfaulted run's — the property the
kill-and-restart test in ``tests/test_supervised_recovery.py`` pins.

Whole-group restart is the **fallback tier**.  With warm standbys armed
(``spawn --supervise --standbys K`` / ``PATHWAY_STANDBY_COUNT``) the
supervisor first tries a **standby promotion** (``engine/standby.py``):
K extra processes tail the persistence root, deep-verifying every newly
committed generation, so each standby stays within one commit of any
shard.  On a worker death the supervisor bumps the dead worker's
per-worker fence token (``bump_worker_fence`` — the dead worker's
zombie can never publish again), posts a PROMOTE request on the root,
and the chosen standby adopts the dead worker's identity while the
SURVIVORS NEVER RESTART: each survivor's promote-watch poisons its mesh
(``TcpMesh.poison``), drains to a consistent commit, and rejoins a
fresh mesh in-process (``internals/runner.py``).  Only the dead
worker's uncommitted tail is replayed — sub-second where the restart
tier pays backoff plus a full N-worker resume.  A promotion that cannot
start (no live standby, no root/lease, spent
``PATHWAY_STANDBY_PROMOTIONS`` budget) or that faults mid-flight
(standby death, a second worker death, a blown
``PATHWAY_STANDBY_PROMOTE_DEADLINE_S``) falls back to the whole-group
restart below — the two-tier recovery contract
``tests/test_standby_promotion.py`` pins.

Restarted workers do not trust the newest checkpoint blindly: the
persistence layer (``engine/persistence.py``) verifies each generation's
integrity frames + digests and falls back generation-by-generation to
the newest VERIFIED one.  When the supervisor knows the persistence root
(``checkpoint_root``), it reads the per-worker provenance back after the
run and surfaces it on ``SupervisorResult.recovery`` for post-mortems,
alongside ``last_failure`` (why the last restart happened).

Restart attempts are announced to workers via ``PATHWAY_RESTART_ATTEMPT``
(the fault plan's ``attempt`` filter keys off it, so chaos tests can
inject a crash on attempt 0 and let attempt 1 run clean).

Two hazards the restart loop alone cannot handle, both covered here:

* **Split-brain zombies.**  A worker from a superseded attempt that is
  not actually dead yet (partitioned, SIGKILL in flight, wedged past its
  send deadline) could publish a stale checkpoint generation into the
  same persistence root the respawned cluster now writes.  Before every
  (re)launch the supervisor therefore bumps an **incarnation lease** on
  the root (``engine/persistence.py:acquire_lease``) and exports the new
  incarnation to the workers via ``PATHWAY_INCARNATION``; every
  commit-point write in the persistence layer re-checks the lease and a
  stale writer gets ``FencedError`` instead of a publish.

* **Silent hangs.**  A live-but-stuck worker (deadlocked epoch loop,
  wedged blob I/O) produces no exit code, so the death-watch never fires.
  Workers touch a progress beacon (``<root>/lease/progress.<id>``) from
  their epoch loop; the watch loop doubles as a **progress watchdog**:
  when a beacon goes stale past ``PATHWAY_EPOCH_DEADLINE_S`` the hung
  worker is sent SIGUSR1 (flight-recorder dump to ``<root>/blackbox/``),
  then SIGTERM, then SIGKILL — converting the hang into an ordinary
  supervised restart, with the hang recorded on
  ``SupervisorResult.last_failure`` and the dump in ``post_mortem``.

Worker handles are duck-typed: ``multiprocessing.Process`` (tests,
in-repo harnesses) and ``subprocess.Popen`` (``pathway spawn
--supervise``) both work.
"""

from __future__ import annotations

import inspect
import json
import logging
import os
import random
import signal as _signal_mod
import time
from typing import Any, Callable, Sequence

_log = logging.getLogger("pathway_tpu_torch.supervisor")

# one constant for the restart-attempt protocol: the fault plan's
# `attempt` filter and the torch.distributed rendezvous-port offset read
# the same var
from pathway_tpu_torch.engine.faults import ENV_ATTEMPT  # noqa: E402,F401
from pathway_tpu_torch.engine import metrics as _metrics  # noqa: E402

# mirrors persistence.ENV_INCARNATION (pinned equal by a test) — a literal
# here keeps this module's import-time persistence dependency lazy, like
# every other persistence touch in this file
ENV_INCARNATION = "PATHWAY_INCARNATION"

ENV_EPOCH_DEADLINE = "PATHWAY_EPOCH_DEADLINE_S"
# escalation pacing: SIGUSR1 (dump request) → this grace → SIGTERM; the
# SIGTERM → SIGKILL grace reuses the supervisor's grace_s
WATCHDOG_DUMP_GRACE_S = 1.0
# before a worker's FIRST beacon touch of an attempt, allow at least this
# long: worker startup (interpreter, torch import, mesh formation) produces
# no progress yet and must not read as a hang under a tight epoch deadline
WATCHDOG_BOOT_GRACE_S = 30.0


def _epoch_deadline_from_env() -> float | None:
    """``PATHWAY_EPOCH_DEADLINE_S`` as a positive float, else None (the
    watchdog stays off — a run with long legitimate gaps between epochs
    must opt in with a deadline that fits its cadence)."""
    from pathway_tpu_torch.internals.config import env_raw

    raw = env_raw(ENV_EPOCH_DEADLINE) or ""
    try:
        value = float(raw) if raw else 0.0
    except ValueError:
        return None
    return value if value > 0 else None


class SupervisorError(RuntimeError):
    """The cluster kept failing past the restart budget.

    ``post_mortem`` carries the flight-recorder summary gathered from the
    persistence root (same shape as ``SupervisorResult.post_mortem``) —
    a crash loop is exactly the case the black box exists for.
    """

    post_mortem: dict = {}


class SupervisorResult:
    __slots__ = (
        "attempts", "restarts", "exit_codes", "history", "recovery",
        "last_failure", "post_mortem", "rescales", "promotions",
    )

    def __init__(
        self,
        attempts: int,
        restarts: int,
        exit_codes: list[int],
        history: list[list[int | None]],
        recovery: dict[int, dict] | None = None,
        last_failure: str | None = None,
        post_mortem: dict | None = None,
        rescales: list[dict] | None = None,
        promotions: list[dict] | None = None,
    ):
        self.attempts = attempts  # launches performed (>= 1)
        self.restarts = restarts  # recoveries performed (attempts - 1)
        self.exit_codes = exit_codes  # final attempt's per-worker codes
        # per-attempt worker exit codes at teardown time (negative =
        # signal, e.g. -9 for the SIGKILL that triggered the recovery)
        self.history = history
        # post-mortem info read back from the persistence root (when the
        # supervisor knows it): per-worker checkpoint provenance —
        # {worker: {"generation", "recovered_from", "rejected", "attempt"}}.
        # "recovered_from" is the generation the final attempt VERIFIED and
        # resumed from; "rejected" lists [generation, reason] pairs the
        # integrity scan refused (torn/corrupt/missing artifacts).
        self.recovery = recovery or {}
        # human-readable reason for the last recovery, e.g.
        # "worker 1 exited -9 on attempt 0" — None for a clean first run
        self.last_failure = last_failure
        # flight-recorder post-mortem gathered from the persistence root
        # (engine/flight_recorder.py): {"workers": {wid: {"dumps": [...],
        # "reasons": [...], "last_events": [...]}}} — the last seconds of
        # every worker that dumped its black box before dying.  {} when no
        # root is known or no worker dumped.  ``pathway_tpu_torch blackbox ROOT``
        # renders the full dumps.
        self.post_mortem = post_mortem or {}
        # degraded-mode shrink provenance: one entry per rescale performed
        # by this run — {"from", "to", "lost_worker", "attempt", "reason"}.
        # Empty for a run that never lost a worker permanently.
        self.rescales = rescales or []
        # warm-standby promotion provenance: one entry per COMPLETED
        # promotion — {"worker", "standby", "seq", "fence", "attempt",
        # "duration_s", "reason"}.  A worker loss absorbed here never
        # shows up in ``restarts``; aborted promotions fall back to the
        # restart tier and are counted there instead.
        self.promotions = promotions or []

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"SupervisorResult(attempts={self.attempts}, "
            f"restarts={self.restarts}, exit_codes={self.exit_codes}, "
            f"last_failure={self.last_failure!r})"
        )


# -- handle duck-typing (multiprocessing.Process | subprocess.Popen) -------


def _exitcode(handle: Any) -> int | None:
    if hasattr(handle, "exitcode"):  # multiprocessing.Process
        return handle.exitcode
    return handle.poll()  # subprocess.Popen


def _alive(handle: Any) -> bool:
    return _exitcode(handle) is None


def _join(handle: Any, timeout: float) -> None:
    if hasattr(handle, "join"):
        handle.join(timeout)
        return
    try:
        handle.wait(timeout)
    except Exception:  # subprocess.TimeoutExpired
        pass


def _signal(handle: Any, *, hard: bool) -> None:
    try:
        if hard:
            handle.kill()
        else:
            handle.terminate()
    except (OSError, ValueError):
        pass  # already gone


def _pid(handle: Any) -> int | None:
    """OS pid of a worker handle (both Process and Popen expose .pid)."""
    return getattr(handle, "pid", None)


class _ProgressWatchdog:
    """Hung-worker detection riding the supervisor's watch loop.

    Workers touch a progress beacon — ``<root>/lease/progress.<id>``,
    mtime refreshed from the epoch loop (``internals/runner.py``) — so
    "no progress" is an on-disk fact the supervisor can read without any
    channel to the worker.  When a live worker's beacon age exceeds the
    epoch deadline, escalate:

    1. SIGUSR1 — the worker's runner dumps its flight recorder to
       ``<root>/blackbox/`` (a hang leaves no crash dump otherwise: the
       black box must be pulled OUT of the wreck before it is made one);
    2. after ``WATCHDOG_DUMP_GRACE_S``: SIGTERM;
    3. after the supervisor's ``grace_s``: SIGKILL.

    The death is then picked up by the ordinary death-watch and routed
    through the restart budget; the hang description lands in
    ``Supervisor._hangs`` so ``last_failure`` tells the real story.

    The beacon clock for a worker starts at attempt launch (a fresh
    worker has not touched anything yet), so the deadline must exceed
    worker startup time.  State is per-attempt: a new `_watch` call gets
    a new watchdog.
    """

    def __init__(self, supervisor: "Supervisor"):
        self.sup = supervisor
        self.deadline = float(supervisor.epoch_deadline_s or 0.0)
        self.started_at = time.time()
        # wid -> (phase, phase_entered_at); phases: sigusr1 -> term -> kill
        self._phase: dict[int, tuple[str, float]] = {}
        reg = _metrics.get_registry()
        self._kills = reg.counter(
            "supervisor.watchdog.kills",
            "hung workers killed by the progress watchdog",
        )
        self._age_gauges = {
            w: reg.gauge(
                "worker.last_progress.age_s",
                "seconds since the worker's last epoch-progress beacon",
                worker=w,
            )
            for w in range(supervisor.n_workers)
        }

    def _beacon_age(self, wid: int) -> tuple[float, bool]:
        """(seconds since last progress, touched-this-attempt).  A beacon
        older than the attempt start (or missing) belongs to a previous
        attempt: the clock then runs from attempt launch, and the boot
        grace applies."""
        path = os.path.join(
            self.sup.checkpoint_root, "lease", f"progress.{wid}"
        )
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            mtime = 0.0
        touched = mtime > self.started_at
        return time.time() - max(mtime, self.started_at), touched

    def poll(self, handles: Sequence[Any]) -> None:
        now = time.time()
        for wid, handle in enumerate(handles):
            if _exitcode(handle) is not None:
                continue  # dead workers are the death-watch's business
            age, touched = self._beacon_age(wid)
            gauge = self._age_gauges.get(wid)
            if gauge is not None:
                gauge.set(age)
            state = self._phase.get(wid)
            if state is None:
                threshold = (
                    self.deadline
                    if touched
                    else max(self.deadline, WATCHDOG_BOOT_GRACE_S)
                )
                if age <= threshold:
                    continue
                # stall confirmed: ask for the black box FIRST — the hung
                # process can often still run a signal handler even when
                # its epoch loop never returns
                reason = (
                    f"no epoch progress for {age:.1f}s "
                    f"(deadline {self.deadline:.1f}s)"
                )
                self.sup._hangs[wid] = reason
                _log.warning(
                    "watchdog: worker %d is hung (%s) — requesting a "
                    "flight-recorder dump (SIGUSR1), then killing it into "
                    "a supervised restart", wid, reason,
                )
                pid = _pid(handle)
                if pid is not None:
                    try:
                        os.kill(pid, _signal_mod.SIGUSR1)
                    except (OSError, ValueError):
                        pass
                self._phase[wid] = ("sigusr1", now)
            elif state[0] == "sigusr1":
                if age <= self.deadline:
                    # the worker resumed touching its beacon during the
                    # dump grace — a slow epoch, not a hang: stand down
                    # before anything lethal (only the SIGUSR1 dump
                    # happened, which is harmless forensics)
                    _log.warning(
                        "watchdog: worker %d resumed progress "
                        "(beacon age %.1fs) — aborting the kill escalation",
                        wid, age,
                    )
                    del self._phase[wid]
                    self.sup._hangs.pop(wid, None)
                elif now - state[1] >= WATCHDOG_DUMP_GRACE_S:
                    self._kills.inc()
                    _signal(handle, hard=False)
                    self._phase[wid] = ("term", now)
            elif state[0] == "term":
                if now - state[1] >= self.sup.grace_s:
                    _signal(handle, hard=True)
                    self._phase[wid] = ("kill", now)


class Supervisor:
    """Run one SPMD worker group to completion, restarting it on failure.

    ``spawn(worker_id, attempt)`` must start worker ``worker_id`` of the
    group and return its handle; it is responsible for wiring the cluster
    env (``PATHWAY_PROCESSES``/``PROCESS_ID``/``FIRST_PORT``/…) and for
    exporting ``PATHWAY_RESTART_ATTEMPT=attempt`` into the worker.
    """

    def __init__(
        self,
        spawn: Callable[[int, int], Any],
        n_workers: int,
        *,
        max_restarts: int = 3,
        grace_s: float = 5.0,
        poll_interval_s: float = 0.05,
        restart_jitter_s: float = 0.5,
        checkpoint_root: str | None = None,
        epoch_deadline_s: float | None = None,
        shrink_on_loss: bool | None = None,
        autoscale: bool | None = None,
        standbys: int | None = None,
    ):
        self.spawn = spawn
        self.n_workers = n_workers
        self.max_restarts = max_restarts
        # load-adaptive autoscaling (opt-in): a ScaleController rides the
        # watch loop, reading the workers' load beacons and triggering
        # grow/shrink rescales via live shard handoff (with restart
        # fallback).  None reads the PATHWAY_AUTOSCALE knob.  Needs a
        # checkpoint root — both the sensor feed (lease/load.<w>) and the
        # actuator (lease/HANDOFF + repartition resume) live there.
        from pathway_tpu_torch.internals.config import env_bool, env_float, env_int

        if autoscale is None:
            autoscale = env_bool("PATHWAY_AUTOSCALE")
        self.autoscale = bool(autoscale)
        self.handoff_deadline_s = env_float(
            "PATHWAY_AUTOSCALE_HANDOFF_DEADLINE_S"
        )
        self._controller: Any = None
        # outcome of a handoff the last _watch call observed:
        # {"kind": "live", ...} = all workers drained + acked, relaunch at
        # the target without charging the restart budget; {"kind":
        # "fallback", ...} = the handoff faulted mid-flight, fall back to
        # a restart-based rescale at the same target topology
        self._handoff_outcome: dict[str, Any] | None = None
        self._as_last_observe = 0.0
        self._as_last_state = 0.0
        # degraded-mode shrink (opt-in): when the SAME worker failed on
        # every attempt of a spent restart budget — the permanently-lost-
        # host signature, not an ordinary crash loop — rescale the cluster
        # to the surviving count instead of failing the run.  The resumed
        # workers re-partition checkpointed state by shard range
        # (engine/persistence.py repartition resume).  None reads the
        # PATHWAY_DEGRADED_SHRINK knob.
        if shrink_on_loss is None:
            from pathway_tpu_torch.internals.config import env_bool

            shrink_on_loss = env_bool("PATHWAY_DEGRADED_SHRINK")
        self.shrink_on_loss = bool(shrink_on_loss)
        # rescale provenance (mirrored onto SupervisorResult.rescales)
        self.rescales: list[dict] = []
        # warm-standby pool (tier-one recovery): K extra processes tail
        # the persistence root (engine/standby.py) so a worker death can
        # be absorbed by promoting one instead of restarting the group.
        # None reads the PATHWAY_STANDBY_COUNT knob; needs a checkpoint
        # root (the PROMOTE protocol and the tail both live there).
        if standbys is None:
            standbys = env_int("PATHWAY_STANDBY_COUNT")
        self.standbys = max(0, int(standbys or 0))
        self.promote_deadline_s = env_float(
            "PATHWAY_STANDBY_PROMOTE_DEADLINE_S"
        )
        self.max_promotions = env_int("PATHWAY_STANDBY_PROMOTIONS")
        # completed-promotion provenance (mirrored onto
        # SupervisorResult.promotions and the root's promotion history)
        self.promotions: list[dict] = []
        self._standby_handles: dict[int, Any] = {}
        # the in-flight promotion's bookkeeping (None when idle) — also
        # the autoscaler gate: no scale decisions while a shard changes
        # owners via promotion
        self._promotion: dict[str, Any] | None = None
        self._promote_seq = 0
        self._attempt = 0
        # does the spawn callback accept the CURRENT cluster size?  A
        # shrink changes n_workers between attempts, and the spawner must
        # export the new PATHWAY_PROCESSES; two-arg spawners (fixed-size
        # callers, older tests) keep working unchanged.
        try:
            params = inspect.signature(spawn).parameters
            self._spawn_takes_workers = any(
                p.kind is inspect.Parameter.VAR_KEYWORD or name == "n_workers"
                for name, p in params.items()
            )
        except (TypeError, ValueError):
            self._spawn_takes_workers = False
        self.grace_s = grace_s
        self.poll_interval_s = poll_interval_s
        # extra uniform jitter on top of the backoff schedule: when many
        # supervised clusters share infrastructure (one storage service,
        # one k8s node pool), a correlated failure must not produce a
        # thundering herd of simultaneous restarts
        self.restart_jitter_s = restart_jitter_s
        # filesystem persistence root (when known): lets the supervisor
        # read back per-worker checkpoint provenance for post-mortems,
        # own the incarnation lease, and watch the progress beacons
        self.checkpoint_root = checkpoint_root
        # progress-watchdog deadline: a worker whose epoch loop makes no
        # progress for this long is dumped (SIGUSR1) and then killed into
        # an ordinary supervised restart.  None (and no env override)
        # disables the watchdog.  The deadline must exceed worker startup
        # time: the clock for a worker starts at attempt launch until its
        # first beacon touch.
        self.epoch_deadline_s = (
            epoch_deadline_s
            if epoch_deadline_s is not None
            else _epoch_deadline_from_env()
        )
        # the incarnation this attempt's workers were launched under
        # (None when no checkpoint root is known — fencing needs a root)
        self.incarnation: int | None = None
        # {worker id: hang description} for the CURRENT attempt — filled
        # by the watchdog when it starts killing a stalled worker, read by
        # run() to put hang provenance on last_failure
        self._hangs: dict[int, str] = {}

    def _backoff_delays(self):
        # the udfs backoff schedule — the same policy the comm mesh uses
        # for link reconnects, applied between cluster restart attempts
        from pathway_tpu_torch.internals.udfs.retries import (
            ExponentialBackoffRetryStrategy,
        )

        return ExponentialBackoffRetryStrategy(
            max_retries=max(self.max_restarts, 1),
            initial_delay=200,
            backoff_factor=2,
            jitter_ms=100,
        ).delays()

    def _recovery_info(self) -> dict[int, dict]:
        """Per-worker checkpoint provenance from the persistence root; {}
        when the root is unknown or unreadable — post-mortem data is
        best-effort.

        The authoritative record is the newest readable generation
        MANIFEST (provenance fields ride every commit); the advisory
        ``metadata.json.<worker>`` pointer is only a fallback, since its
        refresh is best-effort and may lag the real commit."""
        if not self.checkpoint_root:
            return {}
        try:
            import os

            if not os.path.isdir(self.checkpoint_root):
                # read-only forensics must not create a (possibly mistyped)
                # root as a side effect of FileBackend's makedirs
                _log.warning(
                    "checkpoint root %s does not exist; no recovery "
                    "provenance available", self.checkpoint_root,
                )
                return {}
            from pathway_tpu_torch.engine.persistence import (
                METADATA_FILE,
                FileBackend,
                _read_manifest,
            )

            backend = FileBackend(self.checkpoint_root)
            out: dict[int, dict] = {}
            manifests: dict[int, list[str]] = {}
            pointers: dict[int, str] = {}
            for key in backend.list_keys(""):
                parts = key.split("/")
                if (
                    parts[0] == "manifests"
                    and len(parts) == 3
                    and parts[1].isdigit()
                    and parts[2].isdigit()
                ):
                    manifests.setdefault(int(parts[1]), []).append(key)
                elif len(parts) == 1 and parts[0].startswith(
                    METADATA_FILE + "."
                ):
                    tail = parts[0].rsplit(".", 1)[-1]
                    if tail.isdigit():
                        pointers[int(tail)] = key
            for wid in sorted(set(manifests) | set(pointers)):
                obj = None
                for key in sorted(manifests.get(wid, []), reverse=True):
                    obj, _reason = _read_manifest(backend, key)
                    if obj is not None:
                        break
                if obj is None and wid in pointers:
                    raw = backend.get(pointers[wid])
                    if raw is not None:
                        try:
                            obj = json.loads(raw.decode())
                        except ValueError:
                            obj = None
                if obj is not None and "generation" in obj:
                    out[wid] = {
                        "generation": obj.get("generation"),
                        "recovered_from": obj.get("recovered_from"),
                        "rejected": obj.get("rejected") or [],
                        "attempt": obj.get("attempt"),
                        # elastic-rescale provenance: the topology this
                        # worker last committed under, and the superseded
                        # topology it re-partitioned from (None = never
                        # rescaled)
                        "topology": obj.get("topology"),
                        "repartitioned_from": obj.get("repartitioned_from"),
                    }
            return out
        except Exception:  # noqa: BLE001 - never fail a run for forensics
            return {}

    def _post_mortem(self) -> dict:
        """Flight-recorder dumps gathered from the persistence root into
        the compact ``SupervisorResult.post_mortem`` form; {} when no root
        is known or nothing dumped — like recovery provenance, post-mortem
        data is best-effort and must never fail a run."""
        if not self.checkpoint_root:
            return {}
        try:
            from pathway_tpu_torch.engine.flight_recorder import (
                gather_dumps,
                summarize_dumps,
            )

            dumps = gather_dumps(self.checkpoint_root)
            # only THIS run's dumps: anything written before run() started
            # (or missing its stamp — an older format) is a previous run's
            # story and would misattribute old crashes to a clean run
            cutoff = getattr(self, "_run_started_at", 0.0)
            dumps = {
                w: [p for p in ps if p.get("dumped_at", 0.0) >= cutoff]
                for w, ps in dumps.items()
            }
            dumps = {w: ps for w, ps in dumps.items() if ps}
            if not dumps:
                return {}
            summary = summarize_dumps(dumps)
            for wid, info in sorted(summary.get("workers", {}).items()):
                _log.info(
                    "worker %d left %d flight-recorder dump(s); last "
                    "reason: %s", wid, len(info.get("dumps", [])),
                    (info.get("reasons") or [None])[-1],
                )
            return summary
        except Exception:  # noqa: BLE001 - forensics only
            return {}

    def _settle_checkpoints(self) -> None:
        """Settle async-commit residue on the persistence root after the
        whole group is confirmed dead, before the restart is accounted.

        A worker killed mid-pipelined-commit can leave two kinds of debris:
        ``*.tmp`` staging files from a ``put_atomic`` that never renamed
        (invisible to resume — ``list_keys`` skips them — but accumulating
        across restarts), and unreferenced partial generations (chunks
        whose manifest never published).  The staging files are swept here;
        partial generations are deliberately left alone — the respawned
        workers overwrite the orphaned chunk slots in place and operator GC
        collects unreferenced dumps, and deleting them here would race a
        slow-dying writer thread's last put."""
        if not self.checkpoint_root:
            return
        import os

        if not os.path.isdir(self.checkpoint_root):
            return
        removed = 0
        for dirpath, _dirs, files in os.walk(self.checkpoint_root):
            for name in files:
                if not name.endswith(".tmp"):
                    continue
                try:
                    os.remove(os.path.join(dirpath, name))
                    removed += 1
                except OSError:
                    pass  # best-effort sweep, never fail a restart for it
        if removed:
            _log.info(
                "settled %d stale checkpoint staging file(s) under %s "
                "before restart", removed, self.checkpoint_root,
            )

    def _acquire_incarnation(self, attempt: int) -> None:
        """Bump the root's incarnation lease for this attempt and export it
        to the workers about to spawn (``PATHWAY_INCARNATION`` — fork-based
        spawners inherit the supervisor's environ; ``cli spawn`` copies it
        into the subprocess env explicitly).  Acquired BEFORE the group
        launches, so by the time any new worker can write, every writer of
        a previous attempt is already fenced.  Best-effort: a root that
        cannot hold a lease (read-only, no root at all) degrades to the
        pre-fencing behavior with a warning rather than refusing to run."""
        self._hangs = {}
        if not self.checkpoint_root:
            return
        try:
            from pathway_tpu_torch.engine import persistence as pz

            self.incarnation = pz.acquire_lease(
                pz.FileBackend(self.checkpoint_root),
                owner=f"supervisor pid {os.getpid()} attempt {attempt}",
                # the lease records the TARGET TOPOLOGY of this attempt:
                # workers verify PATHWAY_PROCESSES against it at boot (the
                # topology handshake), and scrub renders the rescale
                # history it accumulates
                workers=self.n_workers,
            )
            os.environ[ENV_INCARNATION] = str(self.incarnation)
            _log.info(
                "attempt %d runs as incarnation %d over %d worker(s) "
                "(lease on %s)",
                attempt, self.incarnation, self.n_workers,
                self.checkpoint_root,
            )
        except Exception as exc:  # noqa: BLE001 - fencing is best-effort
            _log.warning(
                "could not acquire the incarnation lease on %s (%s); "
                "zombie-writer fencing is OFF for this run",
                self.checkpoint_root, exc,
            )

    def _spawn_one(self, worker_id: int, attempt: int) -> Any:
        if self._spawn_takes_workers:
            return self.spawn(worker_id, attempt, n_workers=self.n_workers)
        return self.spawn(worker_id, attempt)

    def _spawn_standbys(self, attempt: int) -> None:
        """(Re)fill the warm-standby pool: any missing/dead standby is
        respawned through the ordinary spawn callback with an id above
        the worker range; the ``PATHWAY_STANDBY_ID`` export (same
        env-export trick as the incarnation) flips the process into the
        tail loop (``engine/standby.py``) instead of the worker boot
        path.  Standbys are per-incarnation — a restart-all stops and
        respawns them so their inherited ``PATHWAY_INCARNATION`` matches
        the new lease and they honor its PROMOTE requests."""
        if not self.standbys or not self.checkpoint_root:
            return
        for sid in range(self.standbys):
            handle = self._standby_handles.get(sid)
            if handle is not None and _alive(handle):
                continue
            os.environ["PATHWAY_STANDBY_ID"] = str(sid)
            try:
                self._standby_handles[sid] = self._spawn_one(
                    self.n_workers + sid, attempt
                )
            except Exception as exc:  # noqa: BLE001 - a missing standby
                # only narrows recovery to the restart tier; never fail
                # the run for it
                _log.warning("could not spawn standby %d: %s", sid, exc)
            finally:
                os.environ.pop("PATHWAY_STANDBY_ID", None)

    def _stop_standbys(self) -> None:
        handles = list(self._standby_handles.values())
        self._standby_handles.clear()
        if handles:
            self._stop_all(handles)

    def _begin_promotion(
        self, wid: int, handles: Sequence[Any]
    ) -> dict[str, Any] | None:
        """Tier-one recovery: try to hand dead worker ``wid``'s shard to
        a warm standby.  Bumps the dead worker's per-worker fence (its
        zombie can never publish again) and posts the PROMOTE request
        the standby and the survivors coordinate on.  Returns the
        in-flight promotion's bookkeeping, or None when promotion cannot
        start — no root/lease, no live standby, spent promotion budget —
        in which case the caller takes the restart tier."""
        if not self.checkpoint_root or self.incarnation is None:
            return None
        if len(self.promotions) >= self.max_promotions:
            _log.warning(
                "promotion budget spent (%d); worker %d's death takes "
                "the restart tier", self.max_promotions, wid,
            )
            return None
        live = {
            sid: h for sid, h in self._standby_handles.items() if _alive(h)
        }
        if not live:
            return None
        from pathway_tpu_torch.engine import persistence as pz

        try:
            beacons = pz.read_standby_beacons(self.checkpoint_root)
        except Exception:  # noqa: BLE001 - advisory files, never fatal
            beacons = {}
        # freshest standby first: the smallest published apply lag means
        # the least uncommitted tail to replay (no beacon sorts last)
        sid = min(
            live,
            key=lambda s: (
                s not in beacons,
                float(beacons.get(s, {}).get("lag_s") or 0.0),
                s,
            ),
        )
        reason = (
            f"worker {wid} exited {_exitcode(handles[wid])} on attempt "
            f"{self._attempt}"
        )
        try:
            fence = pz.bump_worker_fence(
                pz.FileBackend(self.checkpoint_root), wid
            )
            self._promote_seq += 1
            seq = self._promote_seq
            pz.post_promote_request(
                self.checkpoint_root,
                incarnation=self.incarnation,
                worker=wid,
                standby=sid,
                fence=fence,
                seq=seq,
                workers=self.n_workers,
                reason=reason,
            )
        except Exception as exc:  # noqa: BLE001 - unleased/read-only root
            _log.warning(
                "could not post a promotion for worker %d (%s); taking "
                "the restart tier", wid, exc,
            )
            return None
        now = time.monotonic()
        _log.warning(
            "%s — promoting standby %d into its place (promotion %d, "
            "fence %d, deadline %.1fs); survivors rejoin in place",
            reason, sid, seq, fence, self.promote_deadline_s,
        )
        return {
            "worker": wid,
            "standby": sid,
            "handle": live[sid],
            "seq": seq,
            "fence": fence,
            "reason": reason,
            "started": now,
            "deadline": now + self.promote_deadline_s,
        }

    def _poll_promotion(
        self, promo: dict[str, Any], handles: list[Any]
    ) -> dict[str, Any] | None:
        """One watch-loop poll of the in-flight promotion.  Returns None
        once the standby has adopted (its handle is swapped into the dead
        worker's slot and the pool refilled); returns ``promo`` while
        still pending, with ``promo["failed"]`` set after an abort
        (standby death, blown deadline) — the caller then routes the
        original death through the restart tier."""
        from pathway_tpu_torch.engine import persistence as pz

        now = time.monotonic()
        try:
            acks = pz.read_promote_acks(self.checkpoint_root, self.n_workers)
        except Exception:  # noqa: BLE001 - advisory files, never fatal
            acks = {}
        adopted = acks.get("adopted")
        if adopted is not None and adopted.get("seq") == promo["seq"]:
            # the adopted marker is written strictly after the standby's
            # survivor wait, so clearing the coordination files here can
            # never race the standby's own reads of them
            wid, sid = promo["worker"], promo["standby"]
            handles[wid] = promo["handle"]
            self._standby_handles.pop(sid, None)
            record = {
                "worker": wid,
                "standby": sid,
                "seq": promo["seq"],
                "fence": promo["fence"],
                "attempt": self._attempt,
                "duration_s": round(now - promo["started"], 3),
                "reason": promo["reason"],
            }
            self.promotions.append(record)
            try:
                pz.append_promotion(self.checkpoint_root, record)
                pz.clear_promote(self.checkpoint_root, self.n_workers)
            except Exception:  # noqa: BLE001 - advisory files
                pass
            _metrics.get_registry().counter(
                "supervisor.promotions",
                "standby promotions performed (worker loss absorbed "
                "without a group restart)",
            ).inc()
            _log.warning(
                "standby %d adopted worker %d in %.3fs (%s); the group "
                "never restarted", sid, wid, record["duration_s"],
                promo["reason"],
            )
            self._spawn_standbys(self._attempt)  # refill the pool
            return None
        abort = None
        standby_code = _exitcode(promo["handle"])
        if standby_code is not None:
            abort = (
                f"standby {promo['standby']} died mid-promotion "
                f"(exit {standby_code})"
            )
        elif now >= promo["deadline"]:
            abort = (
                f"not adopted within {self.promote_deadline_s:.1f}s"
            )
        if abort is not None:
            self._abort_promotion(promo, abort)
            promo["failed"] = abort
        return promo

    def _abort_promotion(self, promo: dict[str, Any], why: str) -> None:
        """Fall from the promotion tier to the restart tier: kill the
        chosen standby (it may be mid-adoption holding the dead worker's
        identity) and clear the coordination files so nothing half-done
        outlives the abort.  The bumped fence needs no undo — the next
        attempt's ``acquire_lease`` rewrites the lease without it."""
        from pathway_tpu_torch.engine import persistence as pz

        _metrics.get_registry().counter(
            "supervisor.promotion.fallbacks",
            "standby promotions that aborted and fell back to a "
            "whole-group restart",
        ).inc()
        _log.warning(
            "promotion %d (standby %d -> worker %d) aborted: %s; "
            "falling back to a whole-group restart",
            promo["seq"], promo["standby"], promo["worker"], why,
        )
        handle = promo["handle"]
        if _alive(handle):
            _signal(handle, hard=True)
            _join(handle, 2.0)
        self._standby_handles.pop(promo["standby"], None)
        try:
            pz.clear_promote(self.checkpoint_root, self.n_workers)
        except Exception:  # noqa: BLE001 - advisory files, never fatal
            pass

    def run(self) -> SupervisorResult:
        delays = self._backoff_delays()
        history: list[list[int | None]] = []
        attempt = 0
        handles: list[Any] = []
        last_failure: str | None = None
        # degraded-mode shrink bookkeeping: the attempt the current restart
        # budget started at (a shrink grants the smaller cluster a fresh
        # budget), and the same-worker failure streak that distinguishes a
        # permanently lost host from an ordinary crash loop
        budget_anchor = 0
        last_failed: int | None = None
        same_fail_streak = 0
        # post_mortem cutoff: dumps already on the root when THIS run
        # starts belong to a previous run and must not be re-attributed
        # to it (they stay on disk for `pathway_tpu_torch blackbox`)
        self._run_started_at = time.time()
        self._controller = None
        if self.autoscale and self.checkpoint_root:
            from pathway_tpu_torch.engine.autoscaler import ScaleController

            self._controller = ScaleController(current=self.n_workers)
            _log.info(
                "autoscaler armed: %d..%d worker(s), staleness threshold "
                "%.1fs, rescale budget %d",
                self._controller.min_workers, self._controller.max_workers,
                self._controller.staleness_hi_s, self._controller.budget,
            )
        try:
            while True:
                self._acquire_incarnation(attempt)
                self._attempt = attempt
                # the standby pool is per-incarnation: spawned after the
                # lease bump so each standby inherits THIS attempt's
                # PATHWAY_INCARNATION and honors its PROMOTE requests
                self._spawn_standbys(attempt)
                handles = []
                spawn_failure: tuple[int, BaseException] | None = None
                for w in range(self.n_workers):
                    try:
                        handles.append(self._spawn_one(w, attempt))
                    except Exception as exc:  # noqa: BLE001 - a dead host
                        # a spawn that cannot even launch (host gone,
                        # scheduler refusal) is a worker failure, not a
                        # supervisor crash: route it through the restart /
                        # shrink machinery like any other death
                        spawn_failure = (w, exc)
                        break
                first_failed = (
                    self._watch(handles)
                    if spawn_failure is None
                    else spawn_failure[0]
                )
                if first_failed is None:
                    outcome = self._handoff_outcome
                    self._handoff_outcome = None
                    if outcome is not None:
                        # planned rescale, not a crash: every worker
                        # exited 0.  Live = drain + ack completed, just
                        # relaunch at N'; fallback = split exit (some
                        # drained, some finished), restart at N' anyway.
                        live = outcome["kind"] == "live"
                        codes = [_exitcode(h) for h in handles]
                        history.append(codes)
                        self._settle_checkpoints()
                        self._finish_handoff(
                            outcome, attempt, live=live,
                            failure=None if live else (
                                "split exit: worker(s) "
                                f"{outcome.get('partial_acks')} drained for "
                                "the handoff while the rest finished"
                            ),
                        )
                        # a planned rescale never charges the restart
                        # budget: the resized cluster starts fresh
                        budget_anchor = attempt + 1
                        last_failed, same_fail_streak = None, 0
                        delays = self._backoff_delays()
                        attempt += 1
                        continue  # no backoff: relaunch immediately
                    if self._controller is not None and self.checkpoint_root:
                        # clean finish with the autoscaler armed: drop any
                        # unanswered request + beacons, persist the final
                        # decision log for post-run inspection
                        try:
                            from pathway_tpu_torch.engine import autoscaler as _as
                            from pathway_tpu_torch.engine import persistence as pz

                            pz.clear_handoff(
                                self.checkpoint_root, self.n_workers
                            )
                            _as.clear_load_beacons(
                                self.checkpoint_root, self.n_workers
                            )
                            self._controller.write_state(
                                self.checkpoint_root, time.monotonic()
                            )
                        except Exception:  # noqa: BLE001 - advisory only
                            pass
                    codes = [_exitcode(h) for h in handles]
                    history.append(codes)
                    recovery = self._recovery_info()
                    for wid, info in sorted(recovery.items()):
                        if info.get("rejected"):
                            _log.warning(
                                "worker %d recovered from VERIFIED generation "
                                "%s after rejecting damaged generation(s) %s",
                                wid, info.get("recovered_from"),
                                [g for g, _ in info["rejected"]],
                            )
                    return SupervisorResult(
                        attempt + 1, attempt, codes, history,  # type: ignore[arg-type]
                        recovery=recovery, last_failure=last_failure,
                        post_mortem=self._post_mortem(),
                        rescales=list(self.rescales),
                        promotions=list(self.promotions),
                    )
                hang = self._hangs.get(first_failed)
                if spawn_failure is not None:
                    last_failure = (
                        f"worker {first_failed} failed to spawn on attempt "
                        f"{attempt}: {spawn_failure[1]}"
                    )
                elif hang is not None:
                    # the exit code alone would read like an ordinary crash;
                    # the restart was actually the watchdog converting a
                    # silent stall into a supervised recovery
                    last_failure = (
                        f"worker {first_failed} hung ({hang}) on attempt "
                        f"{attempt}; watchdog killed it (exit "
                        f"{_exitcode(handles[first_failed])})"
                    )
                else:
                    last_failure = (
                        f"worker {first_failed} exited "
                        f"{_exitcode(handles[first_failed])} on attempt "
                        f"{attempt}"
                    )
                outcome = self._handoff_outcome
                self._handoff_outcome = None
                if outcome is not None:
                    # the live handoff faulted mid-flight (a death during
                    # the drain, or the ack deadline blew): fall back to
                    # the restart-based rescale at the SAME target
                    # topology.  Still a planned rescale — the resized
                    # cluster gets a fresh restart budget, like
                    # degraded-mode shrink does.
                    last_failure = (
                        f"live handoff to {outcome['to']} worker(s) "
                        f"faulted ({last_failure}); falling back to a "
                        f"restart-based rescale"
                    )
                    _log.warning("%s", last_failure)
                    self._stop_all(handles)
                    self._stop_standbys()
                    self._settle_checkpoints()
                    codes = [_exitcode(h) for h in handles]
                    codes += [None] * (self.n_workers - len(codes))
                    history.append(codes)
                    self._finish_handoff(
                        outcome, attempt, live=False, failure=last_failure
                    )
                    budget_anchor = attempt + 1
                    last_failed, same_fail_streak = None, 0
                    delays = self._backoff_delays()
                    time.sleep(
                        next(delays)
                        + random.uniform(0, self.restart_jitter_s)
                    )
                    attempt += 1
                    continue
                _metrics.get_registry().counter(
                    "supervisor.restarts",
                    "cluster rollback-and-respawn recoveries performed",
                ).inc()
                _log.warning(
                    "worker %d failed (%s) on attempt %d; rolling the "
                    "group back to the last committed checkpoint",
                    first_failed, last_failure, attempt,
                )
                self._stop_all(handles)
                # standbys are per-incarnation: stop them too so the next
                # attempt's respawn hands them the bumped incarnation
                self._stop_standbys()
                # every worker process is dead: in-flight async commits are
                # drained by construction, so settle their residue on the
                # root BEFORE this attempt is accounted and the respawn
                # resumes from what actually landed
                self._settle_checkpoints()
                codes = [_exitcode(h) for h in handles]
                codes += [None] * (self.n_workers - len(codes))
                history.append(codes)
                if first_failed == last_failed:
                    same_fail_streak += 1
                else:
                    last_failed, same_fail_streak = first_failed, 1
                if attempt - budget_anchor >= self.max_restarts:
                    # restart budget spent.  The permanently-lost-host
                    # signature — the SAME worker failed every attempt of
                    # the budget — can be absorbed by degraded-mode shrink
                    # (opt-in); anything else is a crash loop and fails.
                    consistent_loss = (
                        same_fail_streak >= attempt - budget_anchor + 1
                    )
                    if (
                        self.shrink_on_loss
                        and self.n_workers > 1
                        and consistent_loss
                    ):
                        new_n = self.n_workers - 1
                        self.rescales.append(
                            {
                                "from": self.n_workers,
                                "to": new_n,
                                "lost_worker": first_failed,
                                "attempt": attempt,
                                "reason": last_failure,
                            }
                        )
                        _metrics.get_registry().counter(
                            "supervisor.rescales",
                            "degraded-mode cluster rescales performed "
                            "(worker-loss shrink)",
                        ).inc()
                        _log.warning(
                            "worker %d failed on every attempt of the spent "
                            "restart budget — treating it as permanently "
                            "lost and rescaling the cluster %d -> %d "
                            "worker(s); checkpointed state re-partitions by "
                            "shard range on resume",
                            first_failed, self.n_workers, new_n,
                        )
                        self.n_workers = new_n
                        budget_anchor = attempt + 1
                        last_failed, same_fail_streak = None, 0
                        delays = self._backoff_delays()  # fresh schedule
                    else:
                        hint = (
                            " (the same worker failed every attempt — a "
                            "permanently lost host can be absorbed with "
                            "degraded-mode shrink: PATHWAY_DEGRADED_SHRINK=1 "
                            "or `spawn --supervise --shrink-on-loss`)"
                            if consistent_loss
                            and not self.shrink_on_loss
                            and self.n_workers > 1
                            else ""
                        )
                        err = SupervisorError(
                            f"cluster failed {attempt + 1} time(s) "
                            f"(restart budget {self.max_restarts}); last exit "
                            f"codes {history[-1]}; last failure: "
                            f"{last_failure}{hint}"
                        )
                        # a crash loop is exactly when the black box matters
                        # most: the dumps ride the exception so callers (and
                        # `spawn --supervise`) can point the operator at them
                        err.post_mortem = self._post_mortem()
                        raise err
                time.sleep(
                    next(delays) + random.uniform(0, self.restart_jitter_s)
                )
                attempt += 1
        finally:
            # any escape — Ctrl-C in _watch, a spawn() failure partway
            # through launching the group — must not orphan live workers
            # (they would wait on mesh peers forever); redundant stops of
            # already-exited workers are no-ops
            self._stop_all(handles)
            self._stop_standbys()
            # do not leak THIS run's incarnation into the host process:
            # later (unsupervised) runs in the same process would stamp
            # and fence against a lease they do not participate in
            if self.incarnation is not None:
                os.environ.pop(ENV_INCARNATION, None)

    # pathway-lint: context=watchdog
    def _watch(self, handles: Sequence[Any]) -> int | None:
        """Block until all workers exit 0 (None) or one fails (its id).

        The loop doubles as the progress watchdog: each poll also checks
        every live worker's progress beacon and escalates
        SIGUSR1 → SIGTERM → SIGKILL on a stalled one, whose death the
        death-watch above then routes through the ordinary restart path.

        When autoscaling is armed it is ALSO the scale controller's
        sensor→actuator tick: each poll reads the workers' load beacons,
        feeds them to the controller, and — on a decision — posts the
        handoff request the workers drain against.  A pending handoff's
        outcome is reported out-of-band on ``self._handoff_outcome``
        (the int/None return keeps its original failure meaning)."""
        watchdog = (
            _ProgressWatchdog(self)
            if self.epoch_deadline_s and self.checkpoint_root
            else None
        )
        self._handoff_outcome = None
        self._promotion = None
        controller = self._controller
        pending: dict[str, Any] | None = None
        if controller is not None:
            # re-sync after any rescale (ours or degraded-mode shrink)
            controller.current = self.n_workers
            controller.handoff_state = ""
        while True:
            all_done = True
            promo = self._promotion
            for wid, handle in enumerate(handles):
                code = _exitcode(handle)
                if code is None:
                    all_done = False
                elif promo is not None and wid == promo["worker"]:
                    # tier-one recovery in flight for this very death:
                    # the dead handle stays in its slot until the chosen
                    # standby adopts (or the promotion aborts below)
                    all_done = False
                elif code != 0:
                    if pending is not None:
                        # a death while the handoff drains poisons it:
                        # all-or-nothing, so fall back to a restart rescale
                        pending["kind"] = "fallback"
                        self._handoff_outcome = pending
                        return wid
                    if promo is not None:
                        # a SECOND death while a promotion drains: the
                        # survivors' rejoin can never complete — abort
                        # the promotion, take the restart tier for both
                        self._abort_promotion(
                            promo,
                            f"worker {wid} also died (exit {code}) while "
                            f"promotion {promo['seq']} was in flight",
                        )
                        self._promotion = None
                        return wid
                    # a death with no handoff pending: try the promotion
                    # tier first; only when it cannot start does the
                    # death surface to run()'s restart machinery
                    self._promotion = promo = self._begin_promotion(
                        wid, handles
                    )
                    if promo is None:
                        return wid
                    all_done = False
            if all_done:
                if pending is not None:
                    self._classify_handoff_exit(pending)
                return None
            if promo is not None:
                promo = self._poll_promotion(promo, handles)
                if promo is not None and promo.get("failed"):
                    self._promotion = None
                    return promo["worker"]
                self._promotion = promo
            if watchdog is not None:
                watchdog.poll(handles)
            if (
                controller is not None
                and self.incarnation is not None
                # no scale decisions while a shard changes owners via
                # promotion: the two actuators share the worker set and
                # must not interleave (the race tests pin both orders)
                and self._promotion is None
            ):
                pending = self._autoscale_tick(controller, pending)
                if pending is not None and pending.get("expired"):
                    # deadline blown: a worker is wedged mid-drain.
                    # Convert the wedge into an ordinary failure; run()
                    # applies the target topology via the restart path
                    # (the fallback contract).
                    wid = int(pending.get("straggler", 0))
                    self._hangs[wid] = (
                        f"handoff to {pending['to']} worker(s) not "
                        f"acknowledged within {self.handoff_deadline_s:.1f}s"
                    )
                    pending["kind"] = "fallback"
                    self._handoff_outcome = pending
                    return wid
            time.sleep(self.poll_interval_s)

    def _autoscale_tick(
        self, controller: Any, pending: dict[str, Any] | None
    ) -> dict[str, Any] | None:
        """One sensor→actuator poll: read load beacons, feed the
        controller, post a handoff request on a decision.  Returns the
        pending-handoff bookkeeping (None when no handoff is in flight)."""
        now = time.monotonic()
        if pending is not None:
            # actuation in flight: no new decisions until it settles —
            # just watch the deadline
            if now >= pending["deadline"] and "expired" not in pending:
                pending["expired"] = True
                pending["straggler"] = self._first_unacked(pending["to"])
            return pending
        if now - self._as_last_observe < 0.1:
            return None
        self._as_last_observe = now
        from pathway_tpu_torch.engine import autoscaler as _as

        beacons = _as.read_load_beacons(self.checkpoint_root, self.n_workers)
        decision = None
        if beacons:
            # no fresh beacons = booting or torn-down workers, not calm:
            # feed the controller only when the sensors are live, so an
            # instrumentation gap can never read as sustained idleness
            staleness_s, backlog = _as.worst_load(beacons)
            decision = controller.observe(now, staleness_s, backlog)
        if decision is not None:
            from pathway_tpu_torch.engine import persistence as pz

            to_n = int(decision["to"])
            pz.post_handoff_request(
                self.checkpoint_root,
                incarnation=self.incarnation,
                from_workers=self.n_workers,
                to_workers=to_n,
                reason=str(decision.get("reason", "")),
            )
            controller.handoff_state = "handoff-requested"
            _log.warning(
                "autoscaler: posted live handoff request %d -> %d "
                "worker(s) (%s; deadline %.1fs)",
                self.n_workers, to_n, decision.get("reason", ""),
                self.handoff_deadline_s,
            )
            pending = {
                "to": to_n,
                "decision": decision,
                "deadline": now + self.handoff_deadline_s,
            }
        if decision is not None or now - self._as_last_state >= 0.5:
            self._as_last_state = now
            controller.write_state(self.checkpoint_root, now)
        return pending

    def _ack_valid(self, ack: dict | None, to_n: int) -> bool:
        return (
            ack is not None
            and ack.get("incarnation") == self.incarnation
            and ack.get("to_workers") == to_n
        )

    def _handoff_acks(self, to_n: int) -> list[int]:
        """Worker ids that wrote a valid ack for the pending handoff."""
        try:
            from pathway_tpu_torch.engine import persistence as pz

            acks = pz.read_handoff_acks(self.checkpoint_root, self.n_workers)
        except Exception:  # noqa: BLE001 - advisory files, never fatal
            acks = {}
        return [
            w
            for w in range(self.n_workers)
            if self._ack_valid(acks.get(w), to_n)
        ]

    def _first_unacked(self, to_n: int) -> int:
        acked = set(self._handoff_acks(to_n))
        for w in range(self.n_workers):
            if w not in acked:
                return w
        return 0

    def _classify_handoff_exit(self, pending: dict[str, Any]) -> None:
        """All workers exited 0 with a handoff pending — decide what
        actually happened from the acks on the root."""
        acked = self._handoff_acks(pending["to"])
        if len(acked) == self.n_workers:
            # every worker fenced, committed and acked: the live handoff
            # completed — relaunch at the target picks the frontier up
            pending["kind"] = "live"
            self._handoff_outcome = pending
        elif acked:
            # split exit: some workers drained for the handoff, others
            # finished for real.  The topology must still land at the
            # target, but only a restart rescale can take it there.
            pending["kind"] = "fallback"
            pending["partial_acks"] = acked
            self._handoff_outcome = pending
        # zero acks: the sources finished before any worker saw the
        # request — a genuine clean finish; run() clears the residue

    def _finish_handoff(
        self,
        outcome: dict[str, Any],
        attempt: int,
        *,
        live: bool,
        failure: str | None = None,
    ) -> None:
        """Account a settled handoff (either path) and adopt the target
        topology: rescale provenance + counters, decision-log note,
        coordination-file cleanup, and ``self.n_workers = N'``."""
        from pathway_tpu_torch.engine import autoscaler as _as
        from pathway_tpu_torch.engine import comm as _comm
        from pathway_tpu_torch.engine import persistence as pz

        from_n, to_n = self.n_workers, int(outcome["to"])
        decision = outcome.get("decision") or {}
        self.rescales.append(
            {
                "kind": "autoscale" if live else "autoscale-fallback",
                "from": from_n,
                "to": to_n,
                "attempt": attempt,
                "reason": failure or str(decision.get("reason", "")),
                "action": str(decision.get("action", "")),
                "moving_shards": _comm.moving_shards(from_n, to_n),
            }
        )
        if live:
            _metrics.get_registry().counter(
                "supervisor.handoffs",
                "live shard-range handoffs completed (rescale without a "
                "rollback restart)",
            ).inc()
        else:
            _metrics.get_registry().counter(
                "supervisor.handoff.fallbacks",
                "live handoffs that faulted mid-flight and fell back to "
                "a restart-based rescale",
            ).inc()
        now = time.monotonic()
        controller = self._controller
        if controller is not None:
            controller.current = to_n
            controller.handoff_state = "done" if live else "fallback"
            if live:
                controller.note(now, "handoff-complete", to=to_n)
            else:
                controller.note(
                    now, "handoff-fallback", to=to_n, failure=failure or ""
                )
        scope = max(from_n, to_n)
        try:
            pz.clear_handoff(self.checkpoint_root, scope)
            _as.clear_load_beacons(self.checkpoint_root, scope)
        except Exception:  # noqa: BLE001 - advisory files, never fatal
            pass
        if controller is not None and self.checkpoint_root:
            controller.write_state(self.checkpoint_root, now)
        _log.warning(
            "rescaled %d -> %d worker(s) via %s (attempt %d); %d of %d "
            "shard(s) change owners on resume",
            from_n, to_n,
            "live handoff" if live else "handoff fallback (restart)",
            attempt, self.rescales[-1]["moving_shards"],
            1 << _comm.SHARD_BITS,
        )
        self.n_workers = to_n

    def _stop_all(self, handles: Sequence[Any]) -> None:
        """Terminate survivors: their uncommitted progress IS the rollback."""
        for handle in handles:
            if _alive(handle):
                _signal(handle, hard=False)
        deadline = time.monotonic() + self.grace_s
        for handle in handles:
            _join(handle, max(0.1, deadline - time.monotonic()))
        for handle in handles:
            if _alive(handle):
                _signal(handle, hard=True)
                _join(handle, 2.0)
