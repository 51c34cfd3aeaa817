"""Deterministic fault injection for the engine and runtime layers.

A copy of ``pathway_tpu/engine/faults.py``: one plan JSON drives both
packages the same way, kind by kind and event by event.

The reference framework earns its consistency story with a Rust engine
that is exercised by chaos-style integration tests (the wordcount
recovery harness SIGKILLs pipeline processes mid-run).  This module is
the equivalent lever for this engine: a seeded, declarative **fault
plan** that the comm mesh, the persistence backends, the connector read
loop, and the epoch loop all consult, so failure paths are exercised
deterministically from unit tests — and from soak runs via the
``PATHWAY_FAULT_PLAN`` environment variable.

Plan format (JSON, also accepted as a Python list of dicts)::

    {"seed": 7, "faults": [
        {"kind": "comm_drop",    "worker": 0, "peer": 1, "nth": 2},
        {"kind": "comm_reset",   "worker": 1, "nth": 5},
        {"kind": "comm_corrupt", "worker": 0, "peer": 1, "nth": 1},
        {"kind": "comm_delay",   "worker": 0, "delay_ms": 50, "prob": 0.2},
        {"kind": "crash",        "worker": 1, "at_epoch": 3, "attempt": 0},
        {"kind": "hang",         "worker": 1, "at_epoch": 3, "attempt": 0},
        {"kind": "zombie",       "worker": 0, "nth": 3, "attempt": 0},
        {"kind": "blob_put",     "nth": 2, "key": "manifests"},
        {"kind": "blob_get",     "prob": 0.1, "max_times": 3},
        {"kind": "blob_bitflip", "key": "manifests/0/", "from_nth": 3},
        {"kind": "blob_torn",    "key": "snapshots", "nth": 2, "frac": 0.5},
        {"kind": "blob_truncate", "key": "operators", "nth": 1},
        {"kind": "connector_read", "source": "CsvReader", "nth": 4},
        {"kind": "connector_stall", "source": "SubjectReader", "nth": 3,
         "delay_ms": 500},
        {"kind": "load_spike", "source": "SubjectReader", "nth": 5,
         "delay_ms": 2000},
        {"kind": "handoff_crash", "worker": 1, "attempt": 0},
        {"kind": "device_stall", "source": "encoder", "nth": 1,
         "delay_ms": 500},
        {"kind": "device_error", "source": "rowsum", "from_nth": 1,
         "max_times": 5},
        {"kind": "device_oom", "source": "rowsum", "nth": 2},
        {"kind": "device_compile_fail", "source": "rowsum", "nth": 1},
        {"kind": "device_hang", "source": "embed", "nth": 1,
         "delay_ms": 10000},
        {"kind": "request_churn", "source": "pw-tiny-decoder", "nth": 3,
         "count": 6},
        {"kind": "standby_lag",   "worker": 2, "delay_ms": 400},
        {"kind": "promote_crash", "worker": 2}
    ]}

Matching rules:

* ``worker``/``peer``/``attempt`` match exactly when present (``attempt``
  is the supervisor restart attempt, ``PATHWAY_RESTART_ATTEMPT``; a spec
  without it fires on any attempt).
* ``key``/``source`` are substring filters on the blob key / reader name.
* ``nth`` fires exactly once, on the Nth **matching** event (1-based).
* ``from_nth`` fires on EVERY matching event from the Nth onward (bounded
  by ``max_times``) — e.g. "corrupt every checkpoint generation after the
  second", the lever the corrupt-recovery chaos tests use.
* ``prob`` fires with the given probability per matching event, from a
  per-spec seeded RNG (same seed → same firing pattern), bounded by
  ``max_times`` (default unbounded).
* ``at_epoch`` (crash only) matches the 0-based processed-epoch index.

Fault kinds and their injection sites:

========== =============================================================
comm_drop    ``TcpMesh.send``: the frame is NOT written and the link is
             severed — simulates a frame lost to a TCP reset.  The
             retransmit buffer + reconnect resync must re-deliver it.
comm_reset   ``TcpMesh.send``: the frame IS written, then the link is
             severed — resync must not re-deliver it twice (seq dedup).
comm_corrupt ``TcpMesh.send``: a bit-flipped copy goes on the wire; the
             receiver's decode failure must drop the link, and resync
             must re-deliver the pristine frame from the send buffer.
comm_delay   ``TcpMesh.send``: sleep ``delay_ms`` before the write.
crash        ``Scope.run_epoch``: SIGKILL the current process at the
             chosen epoch boundary (a hard worker death, not an
             exception — nothing gets to flush).
hang         ``Scope.run_epoch``: WEDGE the epoch loop at the chosen epoch
             boundary — the process stays alive but makes no progress (a
             deadlock / stuck blob I/O stand-in).  Only a signal ends it:
             the supervisor's progress watchdog must detect the stall,
             SIGUSR1 a flight-recorder dump out of it, then escalate
             SIGTERM → SIGKILL and restart the group.
zombie       ``persistence._publish_manifest``: stall the Nth manifest
             publish until the root's lease shows a NEWER incarnation
             (bounded by ``delay_ms``, default 30 s) — a stale writer from
             a superseded restart attempt publishing late.  The
             incarnation fence must then reject the publish
             (``FencedError``) and the worker must self-terminate.
writer_crash ``persistence._WriterPool``: SIGKILL from a checkpoint
             writer thread mid-async-commit (artifact hashed, upload
             pending) — the staged generation must stay unreferenced
             because its manifest never published.  ``key`` filters on
             the artifact key (e.g. ``"snapshots"``).
blob_put /   ``FlakyBackend``: the wrapped ``BlobBackend`` call raises
blob_get /   ``InjectedFault`` instead of performing the I/O.
blob_delete
blob_torn    ``FlakyBackend.put/put_atomic``: the write SUCCEEDS but only
             a prefix of the data lands (``frac``, default 0.5) — a torn
             write a power cut leaves behind.  The integrity frame
             (``engine/codec.py``) must flag it on read.
blob_truncate  Like blob_torn but keeps only ``keep_bytes`` (default 0):
             the zero-length/short blob some filesystems leave after a
             crash between create and write-back.
blob_bitflip ``FlakyBackend.put/put_atomic``: one bit of the written data
             is flipped (``bit`` index, default seeded) — storage-medium
             bit rot.  CRC32C framing must flag it on read.
connector_read  The reader supervision loop (``io/_utils.py``): the Nth
             emitted item raises before it is enqueued, exercising the
             consecutive-error budget + restart/reseek path.
connector_stall  The reader supervision loop: the Nth emitted item is
             DELAYED by ``delay_ms`` (required for any effect; a spec
             without it stalls 0 ms) before enqueue — a
             stuck broker / slow upstream stand-in.  No error is raised
             and no epoch slows down; only the data-plane freshness
             layer (``engine/freshness.py``: ``output.staleness.s``)
             can see it — exactly what its chaos tests prove.
load_spike   The reader supervision loop: from the Nth emitted item, the
             reader BUFFERS its output for a ``delay_ms`` window and then
             flushes everything in one instantaneous burst.  No error, no
             data change — delivered rows are byte-identical to an
             unfaulted run — but downstream sees silence followed by a
             backlog wall, so ``output.staleness.s`` and ``backlog.*``
             climb deterministically.  The reproducible load wave the
             autoscaler chaos tests (``engine/autoscaler.py``) drive the
             scale controller with.
handoff_crash  The live-handoff participation point in the epoch loop
             (``internals/runner.py``): SIGKILL this worker AFTER its
             handoff drain-commit fenced the storage but BEFORE its ack —
             the mid-handoff death that must make the supervisor fall
             back to the restart-based rescale, with nothing spliced.
device_stall  The DeviceExecutor dispatch thread (``pathway_tpu_torch/device/
             executor.py``): the Nth dispatched batch job is DELAYED by
             ``delay_ms`` before it runs — a slow device / saturated
             interconnect stand-in.  No error, and the epoch thread is
             never slowed (dispatch is async): only ``backlog.device.*``
             and the freshness layer can see it, which is exactly what
             the device-executor chaos test proves.  ``source`` filters
             on the submitted job name (e.g. the batcher name).
device_error The DeviceExecutor's fixed-shape dispatch
             (``_dispatch_fixed``): the Nth matching device call raises
             an INTERNAL-flavored transient failure *inside* the
             dispatch, so it takes the real classify → retry → breaker
             → host-fallback path (``device/resilience.py``).  Repeated
             with ``from_nth``/``max_times`` it trips the per-callable
             circuit breaker — the device-fault chaos tests' lever.
             ``source`` filters on the registered callable name.
device_oom   Same site: the call raises RESOURCE_EXHAUSTED — the
             executor must SPLIT the chunk onto a smaller bucket and
             ratchet the callable's max-bucket cap
             (``device.oom.splits`` / ``device.bucket.cap``) instead of
             failing the stream.
device_compile_fail  Same site: the call raises a compilation
             failure — deterministic, never retried; counts toward the
             breaker and the batch serves from the host fallback.
device_hang  The dispatch thread: the Nth matching batch job WEDGES
             (bounded by ``delay_ms``, default 60 s) without raising —
             a stuck device call / driver deadlock.  Only the hard
             dispatch deadline (``PATHWAY_DEVICE_DISPATCH_DEADLINE_S``)
             ends it: the job's waiters get a typed hang error and the
             dispatch thread is torn down and respawned
             (``device.dispatch.restarts``).  ``source`` filters on the
             submitted job name.
request_flood  The REST admission path (``engine/serving.py``): a firing
             spec saturates the whole admission budget with synthetic
             in-flight requests for ``delay_ms`` (default 1000) — a
             request flood without real sockets.  Real arrivals behind
             it queue and overflow answers 429 + Retry-After, which is
             exactly the serving-overload contract the chaos tests pin.
             ``source`` filters on the route path.
slow_handler  The REST request handler (``io/http/_server.py``): the Nth
             matching request stalls ``delay_ms`` (async — the event
             loop keeps serving) while holding its admission slot — a
             slow pipeline / slow client stand-in that drives queue
             delay up so shedding, degraded mode and 429/504 paths fire
             deterministically.  ``source`` filters on the route path.
request_churn  The continuous-batching generation scheduler
             (``serving/generation.py``): a firing spec injects a burst
             of ``count`` (default 4) short synthetic requests into the
             admission queue mid-tick — new arrivals landing while a
             long generation holds slots.  The chaos test pins that the
             burst's TTFT stays bounded (chunked prefill + per-step
             admission: no head-of-line blocking) while the long
             generation keeps producing.  ``source`` filters on the
             model name.
trace_storm  The request-tracing layer (``engine/tracing.py``): a firing
             spec bursts ``count`` (default 64) synthetic traced
             requests, each carrying a deep chained span tree, through
             the bounded telemetry export queue — proving the queue
             drops oldest (``telemetry.export.dropped``) without ever
             blocking the serving path.  ``source`` filters on the
             route path.
standby_lag  The warm-standby tail loop (``engine/standby.py``): each
             matching apply tick is DELAYED by ``delay_ms`` before the
             standby verifies newly committed generations — a cold/
             starved standby stand-in.  No error and nothing observable
             to the primaries; only ``standby.lag.s`` (and a promotion's
             replay tail) grows.  ``worker`` matches the STANDBY id.
promote_crash  The promotion adoption point (``engine/standby.py``): a
             standby that just acked a PROMOTE request — the dead
             worker already fenced, the standby's ack already durable —
             is SIGKILLed BEFORE it publishes anything as its new
             worker id.  The narrowest window of the promotion
             protocol: the supervisor must see the missing boot,
             abort at the promote deadline, and fall back to the
             whole-group restart (tier two), with the root left clean.
             ``worker`` matches the STANDBY id.
========== =============================================================
"""

from __future__ import annotations

import json as _json
import os
import random
import signal
import threading
import time as _time
from typing import Any

from pathway_tpu_torch.engine import flight_recorder as _blackbox
from pathway_tpu_torch.engine.persistence import BlobBackend

ENV_PLAN = "PATHWAY_FAULT_PLAN"
ENV_ATTEMPT = "PATHWAY_RESTART_ATTEMPT"

_COMM_KINDS = ("comm_drop", "comm_reset", "comm_corrupt", "comm_delay")
_BLOB_KINDS = ("blob_put", "blob_get", "blob_delete")
# write-corruption kinds: the I/O succeeds but the stored bytes are damaged
# (torn write / truncation / bit rot) — the persistence integrity frames
# must catch them on the read side
_BLOB_CORRUPT_KINDS = ("blob_torn", "blob_truncate", "blob_bitflip")
KINDS = (
    _COMM_KINDS
    + _BLOB_KINDS
    + _BLOB_CORRUPT_KINDS
    + (
        "crash", "writer_crash", "hang", "zombie", "connector_read",
        "connector_stall", "load_spike", "handoff_crash", "device_stall",
        "device_error", "device_oom", "device_compile_fail", "device_hang",
        "request_flood", "slow_handler", "request_churn", "trace_storm",
        "standby_lag", "promote_crash",
    )
)


class InjectedFault(IOError):
    """An error raised by the fault plan, never by real infrastructure."""


def restart_attempt() -> int:
    """Supervisor restart attempt of this process (0 = first launch)."""
    from pathway_tpu_torch.internals.config import env_int

    return env_int(ENV_ATTEMPT)


class FaultSpec:
    """One declarative fault; counts its own matches and firings."""

    __slots__ = (
        "kind", "worker", "peer", "nth", "from_nth", "prob", "delay_ms",
        "at_epoch", "key", "source", "attempt", "max_times", "frac",
        "keep_bytes", "bit", "count", "seen", "fired", "_rng",
    )

    def __init__(self, spec: dict[str, Any], *, seed: int, index: int):
        kind = spec.get("kind")
        if kind not in KINDS:
            raise ValueError(
                f"fault plan: unknown kind {kind!r} (valid: {', '.join(KINDS)})"
            )
        self.kind = kind
        self.worker = spec.get("worker")
        self.peer = spec.get("peer")
        self.nth = spec.get("nth")
        self.from_nth = spec.get("from_nth")
        self.prob = spec.get("prob")
        self.delay_ms = float(spec.get("delay_ms", 0.0))
        self.at_epoch = spec.get("at_epoch")
        self.key = spec.get("key")
        self.source = spec.get("source")
        self.attempt = spec.get("attempt")
        self.max_times = spec.get("max_times")
        # corruption-kind knobs (blob_torn / blob_truncate / blob_bitflip)
        self.frac = spec.get("frac")
        self.keep_bytes = spec.get("keep_bytes")
        self.bit = spec.get("bit")
        # request_churn burst size
        self.count = spec.get("count")
        if (
            self.nth is None
            and self.from_nth is None
            and self.prob is None
            and self.at_epoch is None
        ):
            self.nth = 1  # a bare spec fires once, on the first match
        self.seen = 0
        self.fired = 0
        # per-spec RNG: the firing pattern of a prob-spec depends only on
        # (plan seed, spec position), never on interleaving with other specs
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
        if self.source is not None and self.source not in str(
            ctx.get("source", "")
        ):
            return False
        if self.at_epoch is not None and ctx.get("epoch") != self.at_epoch:
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
        elif self.prob is not None:
            fire = self._rng.random() < self.prob
        else:  # at_epoch-only spec (crash): the match IS the trigger
            fire = self.fired == 0
        if fire:
            self.fired += 1
        return fire

    def describe(self) -> str:
        parts = [self.kind]
        for name in (
            "worker", "peer", "nth", "from_nth", "prob", "at_epoch", "key",
            "source",
        ):
            v = getattr(self, name)
            if v is not None:
                parts.append(f"{name}={v}")
        return " ".join(parts)


class FaultPlan:
    """A seeded set of :class:`FaultSpec`; thread-safe, deterministic."""

    def __init__(self, faults: list[dict[str, Any]], *, seed: int = 0):
        self.seed = seed
        self.specs = [
            FaultSpec(s, seed=seed, index=i) for i, s in enumerate(faults)
        ]
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
        from pathway_tpu_torch.internals.config import env_raw

        raw = env_raw(ENV_PLAN)
        if not raw:
            return None
        return cls.from_json(raw)

    def has(self, *kinds: str) -> bool:
        return any(k in self._kinds for k in kinds)

    def check(self, kind: str, **ctx: Any) -> FaultSpec | None:
        """The firing spec for this event, or None.  Exactly one spec fires
        per event (the first declared match), so plans stay readable."""
        if kind not in self._kinds:
            return None
        with self._lock:
            for spec in self.specs:
                if spec.kind == kind and spec.consider(ctx):
                    self.log.append(
                        f"{spec.describe()} @ "
                        + ",".join(f"{k}={v}" for k, v in sorted(ctx.items()))
                    )
                    # every fired injection lands in the crash flight
                    # recorder, so a post-mortem dump shows WHICH fault
                    # preceded the failure it is being read to explain
                    _blackbox.record("fault.injected", fault=kind, **ctx)
                    return spec
        return None


# ---------------------------------------------------------------------------
# Process-wide active plan
# ---------------------------------------------------------------------------

_active: FaultPlan | None = None
_env_loaded = False
_load_lock = threading.Lock()


def install_plan(plan: FaultPlan | None) -> None:
    """Set (or clear, with None) the process-wide plan — test entry point."""
    global _active, _env_loaded
    with _load_lock:
        _active = plan
        _env_loaded = True  # an explicit install wins over the env


def clear_plan() -> None:
    """Forget any installed/env plan; the env is re-read on next access."""
    global _active, _env_loaded
    with _load_lock:
        _active = None
        _env_loaded = False


def active_plan() -> FaultPlan | None:
    """The installed plan, else one parsed from PATHWAY_FAULT_PLAN (cached).

    Counters live on the plan object, so every injection site shares one
    instance per process — "the 3rd put" means the 3rd put anywhere.
    """
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


def maybe_crash(*, worker: int, epoch: int) -> None:
    """Epoch-boundary crash injection: SIGKILL this process — a hard worker
    death (no flush, no atexit), exactly what the supervisor must survive."""
    plan = active_plan()
    if plan is None or not plan.has("crash"):
        return
    if plan.check("crash", worker=worker, epoch=epoch) is not None:
        # the black box is the only record that survives a SIGKILL: dump
        # it BEFORE the kill (a real external SIGKILL leaves no dump,
        # like a real flight recorder losing power)
        _blackbox.dump(f"injected crash (worker {worker}, epoch {epoch})")
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_hang(*, worker: int, epoch: int) -> None:
    """Epoch-boundary hang injection: WEDGE the epoch loop forever — the
    process stays alive, heartbeats may even keep flowing on comm threads,
    but no epoch ever completes.  Exactly the silent-stall failure mode
    the supervisor's progress watchdog exists for: no exit code, no
    exception, just a progress file whose mtime stops moving.

    The wedge is a plain interruptible sleep loop so the watchdog's
    SIGUSR1 (flight-recorder dump) still runs in this main thread before
    SIGTERM/SIGKILL ends the process."""
    plan = active_plan()
    if plan is None or not plan.has("hang"):
        return
    if plan.check("hang", worker=worker, epoch=epoch) is not None:
        _blackbox.record("fault.hang", worker=worker, epoch=epoch)
        while True:  # only a signal ends this — that is the point
            # pathway-lint: disable=ctx-blocking-call — the hang injector exists to wedge the epoch loop (watchdog chaos tests); blocking IS the feature
            _time.sleep(0.05)


def maybe_crash_handoff(*, worker: int, to_workers: int) -> None:
    """Mid-handoff crash injection: SIGKILL this worker between its handoff
    drain-commit (storage already fenced, frontier already durable) and its
    ack — the narrowest window of the live-handoff protocol.  The
    supervisor must see the nonzero death inside the handoff window and
    fall back to the restart-based rescale at the same target topology;
    the fenced drain-commit stays the (valid) newest generation, so
    nothing is spliced and ``python -m pathway_tpu_torch scrub`` stays clean."""
    plan = active_plan()
    if plan is None or not plan.has("handoff_crash"):
        return
    if plan.check("handoff_crash", worker=worker) is not None:
        _blackbox.dump(
            f"injected handoff crash (worker {worker}, "
            f"handoff to {to_workers} worker(s))"
        )
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_standby_lag(*, standby: int) -> None:
    """Warm-standby lag injection: delay this standby's apply tick by
    ``delay_ms`` — no error, nothing the primaries can observe.  Only the
    standby's apply-cursor beacon (``standby.lag.s``) grows, and a
    promotion that lands during the window has a correspondingly longer
    uncommitted tail to replay.  ``worker`` in the spec matches the
    standby id (standbys have no worker id until promoted)."""
    plan = active_plan()
    if plan is None or not plan.has("standby_lag"):
        return
    spec = plan.check("standby_lag", worker=standby)
    if spec is not None:
        _blackbox.record(
            "fault.standby_lag", standby=standby,
            delay_ms=spec.delay_ms or 0,
        )
        _time.sleep((spec.delay_ms or 0) / 1000.0)


def maybe_crash_promote(*, standby: int, worker: int) -> None:
    """Mid-promotion crash injection: SIGKILL the adopting standby in the
    narrowest window of the promotion protocol — AFTER its PROMOTE ack is
    durable and the dead worker's fence is bumped, BEFORE it publishes
    anything as its new worker id.  The supervisor must detect the
    standby's death (or the missing boot at the promote deadline), abort
    the promotion, and fall back to the whole-group restart, leaving the
    root clean for the tier-two recovery.  ``worker`` in the spec matches
    the standby id."""
    plan = active_plan()
    if plan is None or not plan.has("promote_crash"):
        return
    if plan.check("promote_crash", worker=standby) is not None:
        _blackbox.dump(
            f"injected promote crash (standby {standby}, adopting "
            f"worker {worker})"
        )
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_crash_writer(*, worker: int, key: str) -> None:
    """Async-commit crash injection: SIGKILL from a checkpoint writer-pool
    thread MID-FLIGHT — after the artifact was framed and hashed, before
    its upload.  Some chunks of the staged generation may already be on the
    store, the generation manifest is not: the crash must leave only an
    unreferenced partial generation (invisible to resume and to
    ``python -m pathway_tpu_torch scrub``), which supervised recovery rolls past."""
    plan = active_plan()
    if plan is None or not plan.has("writer_crash"):
        return
    if plan.check("writer_crash", worker=worker, key=key) is not None:
        _blackbox.dump(
            f"injected writer crash (worker {worker}, key {key!r})"
        )
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
