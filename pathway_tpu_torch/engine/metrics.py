"""Unified runtime metrics registry: counters, gauges, histograms.

The port's copy of ``pathway_tpu/engine/metrics.py``.  The declared name
table (:data:`METRICS`) is the JAX package's but for five renames: the
jit accounting ``jax.compile.count``, ``jax.compile.seconds``,
``jax.cache.miss`` and ``jax.transfer.{h2d,d2h}.bytes`` become the port's
``device.kernel.builds``, ``device.kernel.build.seconds``,
``device.kernel.loads`` and ``device.transfer.{h2d,d2h}.bytes``.  The port
emits no ``jax.*`` name.

Parity target: ``src/engine/telemetry.rs`` registers process gauges into
one OTel meter and ``http_server.rs`` serves the latest ``ProberStats``;
this module is the layer both lean on here — ONE registry per process
that the comm mesh (``engine/comm.py``), the persistence pipeline
(``engine/persistence.py``), the supervisor (``engine/supervisor.py``)
and the runner/probes (``internals/runner.py``) all register into, and
that every exporter reads from:

* Prometheus text exposition — appended to ``/metrics`` on the
  monitoring HTTP server (``engine/http_server.py``),
* OTLP/HTTP+JSON — scalar metrics ride the gauge datapoints and
  histograms map to real OTLP histogram datapoints
  (``engine/telemetry.py``),
* the console dashboard footer (``internals/monitoring.py``).

Design constraints, in order:

1. **Lock-cheap on hot paths.**  ``Counter.inc`` / ``Gauge.set`` are a
   guarded float add / store — no lock.  CPython's GIL makes the single
   ``+=`` on an instance slot atomic enough for telemetry (a torn
   increment under free-threaded builds would cost one count, never a
   crash); ``Histogram.observe`` takes a per-child lock because its
   bucket-array update is multi-step, and it is called at epoch/commit
   cadence, not per row.
2. **Labels are first-class** but resolved once: ``family.labels(...)``
   returns a child handle the caller keeps, so steady-state updates
   never touch a dict.
3. **Disable switch**: ``set_enabled(False)`` (or
   ``PATHWAY_METRICS_DISABLED=1``) turns every update into an immediate
   return, the lever that prices the instrumentation itself.

Metric names are canonical **dotted** OTel-style names
(``comm.bytes.sent``); the Prometheus renderer derives the exposition
name by prefixing ``pathway_`` and mapping dots to underscores
(``pathway_comm_bytes_sent``).
"""

from __future__ import annotations

import math
import threading
import time as _time
import weakref
from bisect import bisect_left
from typing import Any, Callable, Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_enabled",
    "otlp_gauge",
    "otlp_histogram",
    "escape_label",
    "DEFAULT_BUCKETS",
]

# Default histogram bounds (seconds-ish / ms-ish magnitudes): wide enough
# for µs frame encodes and multi-second commit barriers alike.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0,
    500.0, 1000.0, 5000.0,
)

# Millisecond-scale bounds for the epoch/commit/profiler histograms: host
# epochs and manifest publishes cluster in 0.1–100 ms, where the default
# bounds collapse everything into two buckets and flatten the quantile
# estimates derived from them (Histogram.quantile).
MS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

# Occupancy-fraction bounds for the device bucket-efficiency histogram
# (device/executor.py): each dispatched bucket observes real_rows/bucket
# in (0, 1] — 1.0 means a full bucket, low buckets mean padding waste.
OCCUPANCY_BUCKETS = (
    0.0625, 0.125, 0.1875, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0,
)

# Quantiles derived from every histogram's fixed buckets at read time,
# surfaced as synthetic gauges (`<name>.p50` …) in the Prometheus
# exposition, OTLP export, and the console dashboard footer.
QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))

# ---------------------------------------------------------------------------
# The declared metric-name registry.
#
# Every dotted metric name the process exports — registered directly
# (counter/gauge/histogram), emitted by a pull-time collector, or merged
# into telemetry samples — is declared here: name -> (kind, doc).
# ``tests/test_torch_observability.py`` holds it to the JAX package's
# table (with the port's renames and its one added counter) and fails a monitored run that
# registers an undeclared family, so dashboards and alerts can trust this
# table to be the complete, stable namespace.  Kinds: counter | gauge | histogram | collector
# (collector = a register_collector() supplier name; its emitted gauges
# are declared individually as kind "gauge").
# ---------------------------------------------------------------------------

METRICS: dict[str, tuple[str, str]] = {
    # comm mesh (engine/comm.py)
    "comm.frames.sent": ("counter", "data/control frames written to peers"),
    "comm.frames.received": ("counter", "frames read from peers"),
    "comm.bytes.sent": ("counter", "bytes written to peers (headers included)"),
    "comm.bytes.received": ("counter", "bytes read from peers"),
    "comm.reconnects": ("counter", "link reconnect attempts"),
    "comm.retransmits": ("counter", "frames retransmitted after a resync"),
    "comm.retransmit.evictions": (
        "counter", "unacked frames evicted from a full retransmit buffer"),
    "comm.peers.dead": ("counter", "peers declared dead past the reconnect window"),
    "comm.heartbeat.staleness.s": (
        "gauge", "max seconds since any live peer was last heard from"),
    # epoch loop / dataflow (internals/runner.py, engine/probes.py)
    "epoch.duration.ms": ("histogram", "wall time of one processed epoch (ms)"),
    "commit.duration.ms": (
        "histogram", "wall time of one generation-manifest publish (ms)"),
    "dataflow.prober": ("collector", "dataflow progress totals supplier"),
    "dataflow.epochs": ("gauge", "epochs processed by this worker"),
    "dataflow.input.rows": ("gauge", "rows ingested across input nodes"),
    "dataflow.output.rows": ("gauge", "rows delivered across output nodes"),
    "dataflow.operators": ("gauge", "operator count of the lowered graph"),
    "dataflow.errors": ("gauge", "rows poisoned/logged by operators"),
    "dataflow.input.lag.ms": ("gauge", "input-side processing lag"),
    "dataflow.output.lag.ms": ("gauge", "output-side processing lag"),
    # persistence commit pipeline (engine/persistence.py, CommitMetrics)
    "persistence.fenced": (
        "counter", "commit-point writes rejected: a newer incarnation owns the root"),
    "persistence.scrub.runs": ("counter", "offline scrub audits run"),
    "persistence.scrub.damaged": (
        "counter", "scrub audits that found damage"),
    # elastic rescale (engine/persistence.py repartition resume)
    "persistence.repartition.sources": (
        "counter", "base sources re-partitioned by a topology-rescale resume"),
    "persistence.repartition.rows": (
        "counter", "rows replayed from superseded-topology logs (post shard "
        "filter)"),
    "persistence.repartition.chunks": (
        "counter", "superseded-topology chunks read during refs replay"),
    "checkpoint.commit.buffer": ("gauge", "cumulative encode/join seconds"),
    "checkpoint.commit.frame": ("gauge", "cumulative integrity-framing seconds"),
    "checkpoint.commit.hash": ("gauge", "cumulative SHA-256 seconds"),
    "checkpoint.commit.upload": ("gauge", "cumulative blob upload seconds"),
    "checkpoint.commit.barrier": ("gauge", "cumulative commit-barrier seconds"),
    "checkpoint.commit.backpressure": (
        "gauge", "seconds the epoch thread stalled on the in-flight byte cap"),
    "checkpoint.inflight.bytes": ("gauge", "snapshot bytes in flight to the store"),
    "checkpoint.inflight.jobs": ("gauge", "artifact writes in flight"),
    "checkpoint.inflight.bytes.max": ("gauge", "high-water mark of in-flight bytes"),
    "checkpoint.artifacts": ("gauge", "artifacts durably written"),
    "checkpoint.bytes": ("gauge", "artifact bytes durably written"),
    "checkpoint.commits": ("gauge", "generation manifests published"),
    "checkpoint.commits.noop": ("gauge", "commits confirmed as no-ops"),
    "checkpoint.gc.runs": ("gauge", "deferred-GC sweeps run"),
    "checkpoint.gc.deleted": ("gauge", "artifacts deleted by GC"),
    "checkpoint.gc.deferred": (
        "gauge", "GC sweeps deferred: newest generation failed read-back"),
    # supervisor (engine/supervisor.py)
    "supervisor.restarts": (
        "counter", "cluster rollback-and-respawn recoveries performed"),
    "supervisor.rescales": (
        "counter", "degraded-mode cluster rescales performed (worker-loss "
        "shrink)"),
    "supervisor.watchdog.kills": (
        "counter", "hung workers killed by the progress watchdog"),
    "supervisor.handoffs": (
        "counter", "planned rescales completed by LIVE shard handoff "
        "(coordinated drain + relaunch, no recovery rollback)"),
    "supervisor.handoff.fallbacks": (
        "counter", "live handoffs that faulted mid-flight and fell back "
        "to the restart-based rescale"),
    # warm-standby promotion (engine/standby.py, engine/supervisor.py)
    "supervisor.promotions": (
        "counter", "standby promotions performed (worker loss absorbed "
        "without a group restart)"),
    "supervisor.promotion.fallbacks": (
        "counter", "standby promotions that aborted and fell back to a "
        "whole-group restart"),
    "standby.state": (
        "collector", "warm-standby panel gauge supplier (reads the "
        "root's lease/standby.<sid> beacons + promotion history): "
        "standby.pool, standby.lag.s{standby=}, "
        "standby.verified.chunks{standby=}, supervisor.promotions and "
        "supervisor.promotions.last.worker"),
    "standby.pool": (
        "gauge", "standbys currently publishing an apply-cursor beacon"),
    "standby.lag.s": (
        "gauge", "age of the oldest committed generation the standby "
        "has not yet verified, by standby= (0 = within one commit of "
        "every shard)"),
    "standby.verified.chunks": (
        "gauge", "event-chunks deep-verified by the standby's tail "
        "loop since it started, by standby="),
    "supervisor.promotions.last.worker": (
        "gauge", "worker id adopted by the newest completed promotion"),
    # load-adaptive autoscaler (engine/autoscaler.py)
    "autoscaler.decisions": (
        "counter", "scaling decisions fired (grow + shrink)"),
    "autoscaler.budget.exhausted": (
        "counter", "scaling decisions suppressed because the rescale "
        "budget was spent"),
    "autoscaler.state": (
        "collector", "autoscaler panel gauge supplier (reads the "
        "supervisor-maintained lease/autoscaler.json state file)"),
    "autoscaler.target.workers": (
        "gauge", "the worker count the scale controller currently targets"),
    "autoscaler.budget.left": (
        "gauge", "rescale decisions remaining in this supervisor run's "
        "budget"),
    "autoscaler.cooldown.remaining.s": (
        "gauge", "seconds until the controller may fire again after the "
        "last rescale"),
    "autoscaler.phase": (
        "gauge", "controller phase: 0 steady, 1 hot-dwell, 2 cooldown, "
        "3 handoff in flight"),
    "autoscaler.decisions.logged": (
        "gauge", "entries in the bounded scaling-decision provenance log"),
    "autoscaler.last.decision": (
        "gauge", "target worker count of the newest decision, labelled "
        "with its action (grow/shrink/suppressed-*)"),
    "worker.restart.attempt": (
        "gauge", "supervisor restarts performed before this worker launch"),
    "worker.last_progress.age_s": (
        "gauge", "seconds since the worker's last epoch-progress beacon"),
    # serving-path robustness (engine/serving.py, io/http/_server.py)
    "serve.requests": (
        "counter", "REST requests answered, by code= (200/400/429/500/"
        "503/504) and route= — the by-status view of the serving front "
        "door"),
    "serve.inflight": (
        "gauge", "REST requests admitted into the pipeline and not yet "
        "answered (the count axis of the admission budget)"),
    "serve.inflight.bytes": (
        "gauge", "summed request-body bytes of in-flight REST requests "
        "(the bytes axis of the admission budget)"),
    "serve.queue.depth": (
        "gauge", "REST requests waiting in the admission pending queue"),
    "serve.queue.wait.ms": (
        "histogram", "time a request spent queued before admission (ms) "
        "— the CoDel-style delay signal the shedder watches"),
    "serve.latency.ms": (
        "histogram", "admitted-request end-to-end latency by route= (ms); "
        "its p50 sizes the Retry-After hint on 429/503 rejects"),
    "serve.shed": (
        "counter", "requests shed before doing pipeline work, by reason= "
        "(queue-full/degraded/queue-deadline/staged-expired/batcher/"
        "device/draining/drain-timeout)"),
    "serve.deadline.exceeded": (
        "counter", "requests answered 504, by where= the deadline lapse "
        "was caught (handler/queue/staging/batcher/device/"
        "generate-queue/decode)"),
    "serve.degraded": (
        "gauge", "1 while the load shedder is engaged (sustained queue "
        "delay above PATHWAY_SERVE_QUEUE_DELAY_MS); degraded-handler "
        "routes serve their cheap path while set"),
    "serve.degraded.transitions": (
        "counter", "degraded-mode engage/disengage edges (flapping here "
        "means the hysteresis knobs are too tight)"),
    "serve.degraded.served": (
        "counter", "requests answered by a registered degraded_handler "
        "instead of the full pipeline, by route="),
    "serve.draining": (
        "gauge", "1 while the webserver is draining (stop-accept 503; "
        "shutdown or live-handoff fence)"),
    "serve.drain.ms": (
        "histogram", "wall time from drain start to the last in-flight "
        "request completing (ms)"),
    "serve.quarantined": (
        "counter", "request rows failed by the pipeline (poisoned cells "
        "or row errors) completed as typed 500s and quarantined"),
    "serve.flood.synthetic": (
        "counter", "synthetic admissions injected by the request_flood "
        "chaos fault kind"),
    "serve.state": (
        "collector", "serving admission/shedder/drain state gauge "
        "supplier (engine/serving.py controller)"),
    # continuous-batching generation (serving/generation.py)
    "generate.requests": (
        "counter", "generation requests accepted into the continuous-"
        "batching queue"),
    "generate.queue.depth": (
        "gauge", "requests waiting for a generation slot (bounded by "
        "PATHWAY_GENERATE_QUEUE; overflow answers 429)"),
    "generate.slots.active": (
        "gauge", "generation slots occupied by a prefilling or decoding "
        "request"),
    "generate.slots.total": (
        "gauge", "configured generation slot count "
        "(PATHWAY_GENERATE_SLOTS — the device batch width)"),
    "generate.pages.used": (
        "gauge", "KV pool pages holding live tokens (page 0, the null "
        "page, is never counted)"),
    "generate.pages.total": (
        "gauge", "allocatable KV pool pages (PATHWAY_GENERATE_PAGES "
        "minus the reserved null page)"),
    "generate.kv.bytes.live": (
        "gauge", "bytes of KV pool backing live tokens — the paged "
        "cache's actual footprint, vs generate.kv.bytes.dense"),
    "generate.kv.bytes.peak": (
        "gauge", "high-water mark of generate.kv.bytes.live since "
        "scheduler start"),
    "generate.kv.bytes.dense": (
        "gauge", "what a dense slots x max_cache KV layout would hold "
        "resident — the baseline the paged pool is measured against"),
    "generate.tokens": (
        "counter", "tokens generated across all requests (EOS not "
        "counted)"),
    "generate.tokens_per_s": (
        "gauge", "sustained decode throughput over the trailing 5 s "
        "window"),
    "generate.ttft.ms": (
        "histogram", "request submit to first generated token (ms) — "
        "the latency continuous batching exists to bound under churn"),
    "generate.prefill.chunks": (
        "counter", "chunked-prefill programs dispatched (fixed "
        "PATHWAY_GENERATE_PREFILL_CHUNK width, interleaved with decode "
        "ticks)"),
    "generate.decode.steps": (
        "counter", "continuous decode ticks dispatched (one token per "
        "active slot per tick)"),
    "generate.churn.synthetic": (
        "counter", "synthetic burst requests injected by the "
        "request_churn chaos fault kind"),
    "generate.prompt.truncated": (
        "counter", "prompts cut to their tail to fit the cache budget "
        "(the port's own count: the JAX package cuts them uncounted)"),
    # columnar execution path (internals/vector_compiler.py)
    "columnar.bail.count": (
        "counter", "columnar fast-path batches that fell back to the "
        "row-wise evaluator, by op= and reason= (a silently bailing "
        "pipeline runs at row speed while benchmarking columnar)"),
    # per-operator epoch profiler (engine/profiler.py)
    "profiler.operators": (
        "collector", "top-N per-operator attribution snapshot supplier"),
    "profiler.operator.seconds": (
        "gauge", "cumulative step seconds of a top-N operator"),
    "profiler.operator.rows": (
        "gauge", "cumulative rows consumed by a top-N operator"),
    "profiler.epochs.sampled": (
        "gauge", "profiler sampling passes taken this run"),
    # kernel-build and transfer accounting (engine/profiler.py): the port's
    # counterparts of the JAX package's jax.compile.* / jax.cache.miss /
    # jax.transfer.* counters
    "device.kernel.builds": (
        "counter", "nvcc builds of the port's CUDA sources (ops/_build.py), "
        "by source="),
    "device.kernel.build.seconds": (
        "counter", "cumulative nvcc wall seconds of those builds"),
    "device.kernel.loads": (
        "counter", "kernel libraries loaded into this process (ctypes), "
        "by source="),
    "device.transfer.h2d.bytes": (
        "counter", "host-to-device bytes staged by the executor's dispatch "
        "path (PATHWAY_PROFILE_TRANSFERS)"),
    "device.transfer.d2h.bytes": (
        "counter", "device-to-host bytes copied back by the executor's "
        "dispatch path (PATHWAY_PROFILE_TRANSFERS)"),
    # data-plane freshness & backpressure (engine/freshness.py)
    "freshness.tracker": (
        "collector", "freshness/backlog gauge supplier (the run's tracker)"),
    "freshness.e2e.ms": (
        "histogram", "ingest-to-delivery latency of output updates (ms)"),
    "output.staleness.s": (
        "gauge", "seconds since the ingest stamp of the newest data an "
        "output reflects"),
    "freshness.mesh.staleness.s": (
        "gauge", "worst output staleness across the worker mesh (worker 0)"),
    "backlog.connector.queue": (
        "gauge", "items waiting in a connector's reader queue"),
    "backlog.connector.idle.s": (
        "gauge", "seconds since an unfinished source last staged a row "
        "(the one-branch-stall signal)"),
    "backlog.ingest.rows": (
        "gauge", "rows staged at an input, not yet folded into an epoch"),
    "backlog.ingest.age.s": (
        "gauge", "age of the oldest staged row waiting at an input"),
    "backlog.epochs.pending": (
        "gauge", "distinct staged epoch timestamps awaiting processing"),
    "backlog.comm.inbox": (
        "gauge", "frames waiting in per-peer mesh inboxes (engine/comm.py)"),
    "backlog.checkpoint.bytes": (
        "gauge", "snapshot bytes in flight to the store (backlog alias of "
        "checkpoint.inflight.bytes)"),
    "backlog.checkpoint.jobs": (
        "gauge", "artifact writes in flight (backlog alias of "
        "checkpoint.inflight.jobs)"),
    # device executor (pathway_tpu_torch/device/executor.py)
    "device.dispatch.batches": (
        "counter", "fixed-shape device batches dispatched by the executor"),
    "device.dispatch.rows": (
        "counter", "real rows dispatched through the executor"),
    "device.dispatch.ms": (
        "histogram", "wall time of one dispatched device call (ms)"),
    "device.job.ms": (
        "histogram", "wall time of one async host-side batch job (ms) — "
        "host prep included, unlike device.dispatch.ms"),
    "device.pad.rows": (
        "counter", "padding rows added by batch bucketing"),
    "device.cache.cold": (
        "counter", "first dispatches of a new compile-cache key (a cold "
        "compile paid in the serving path rather than by warmup)"),
    "device.warmup.compiles": (
        "counter", "compile-cache keys paid ahead of traffic by warmup()"),
    "device.jobs": (
        "counter", "async host-side batch jobs run by the dispatch thread"),
    "device.backpressure.s": (
        "counter", "seconds submitters stalled on the executor's in-flight "
        "budget"),
    "device.executor": (
        "collector", "device-dispatch backlog gauge supplier (the process "
        "executor)"),
    "backlog.device.queue": (
        "gauge", "batch jobs queued or running on the device-dispatch "
        "thread"),
    "backlog.device.bytes": (
        "gauge", "submitted batch bytes in flight through the dispatch "
        "queue"),
    "backlog.device.age.s": (
        "gauge", "age of the oldest batch job still in the dispatch queue"),
    # device cost accounting / roofline / HBM (pathway_tpu_torch/device/telemetry.py)
    "device.flops.total": (
        "counter", "cost-analysis FLOPs moved by dispatched device batches"),
    "device.bytes.accessed": (
        "counter", "cost-analysis bytes accessed by dispatched device "
        "batches (the counted operations' operand and result bytes)"),
    "device.achieved.flops_per_s": (
        "gauge", "cumulative FLOPs over cumulative device-call wall seconds"),
    "device.utilization": (
        "gauge", "roofline utilization estimate: achieved FLOP/s over the "
        "configured/auto-detected per-device peak"),
    "device.peak.flops_per_s": (
        "gauge", "the roofline denominator in use (PATHWAY_DEVICE_PEAK_FLOPS "
        "or the device-kind table; CPU gets a measured-peak default)"),
    "device.bucket.occupancy": (
        "histogram", "real-row fraction of each dispatched bucket (1.0 = "
        "no padding)"),
    "device.padding.waste.rows": (
        "gauge", "cumulative padding rows this executor dispatched"),
    "device.padding.waste.fraction": (
        "gauge", "padding rows over all dispatched rows — the bucket-set "
        "efficiency `pathway_tpu_torch buckets` optimizes"),
    "device.batch.rows": (
        "gauge", "observed ragged batch-size distribution (rows= label; "
        "top sizes only) — the `pathway_tpu_torch buckets` live feed"),
    "device.batch.max": (
        "gauge", "the default bucket-policy cap this process runs with "
        "(PATHWAY_DEVICE_MAX_BATCH) — `pathway_tpu_torch buckets` replays "
        "against the analyzed run's value, not the analyst's env"),
    "device.hbm.bytes_in_use": (
        "gauge", "device memory in use: allocator memory_stats() where "
        "available, the executor's in-flight footprint elsewhere"),
    "device.hbm.peak": (
        "gauge", "peak device memory observed (same source rules as "
        "device.hbm.bytes_in_use)"),
    "device.trace.captures": (
        "counter", "on-demand torch.profiler traces captured (GET /trace, "
        "`pathway_tpu_torch trace`)"),
    # device fault tolerance (pathway_tpu_torch/device/resilience.py)
    "device.failures": (
        "counter", "classified device-path failures observed, labeled by "
        "kind (transient/oom/compile/hang)"),
    "device.retry.attempts": (
        "counter", "transient device failures retried by the dispatch "
        "wrapper (bounded jittered backoff)"),
    "device.oom.splits": (
        "counter", "RESOURCE_EXHAUSTED chunks split onto smaller buckets "
        "by the OOM ratchet"),
    "device.bucket.cap": (
        "gauge", "largest bucket a callable may plan after OOM ratcheting "
        "(callable= label; absent while uncapped)"),
    "device.breaker.state": (
        "gauge", "per-callable circuit-breaker state (callable= label): "
        "0 closed, 0.5 half-open, 1 open"),
    "device.breaker.trips": (
        "counter", "circuit-breaker open transitions (K consecutive "
        "device failures, or a failed half-open probe)"),
    "device.fallback.batches": (
        "counter", "batches served by the un-jitted host-fallback path "
        "while a breaker is open (or after retries failed)"),
    "device.fallback.rows": (
        "counter", "real rows served by the host fallback"),
    "device.fallback.ms": (
        "histogram", "wall time of one host-fallback batch execution (ms)"),
    "device.quarantine.batches": (
        "counter", "poisoned batches quarantined: device retries AND host "
        "fallback failed (waiters get DeviceQuarantinedError)"),
    "device.quarantine.records": (
        "gauge", "quarantine records currently retained "
        "(PATHWAY_DEVICE_QUARANTINE_KEEP newest)"),
    "device.dispatch.restarts": (
        "counter", "dispatch threads torn down and respawned after a "
        "hard dispatch-deadline hang (PATHWAY_DEVICE_DISPATCH_DEADLINE_S)"),
    # request-scoped tracing (engine/tracing.py)
    "trace.requests": (
        "counter", "request traces created by the serving path (W3C "
        "traceparent adopted on ingress, minted otherwise)"),
    "trace.spans": (
        "counter", "request-scoped spans recorded (admission, coalesce, "
        "device dispatch, generation stages)"),
    "trace.spans.dropped": (
        "counter", "request spans dropped by the per-trace span cap"),
    "trace.storm.synthetic": (
        "counter", "synthetic traces injected by the trace_storm chaos "
        "fault kind"),
    "trace.requests.state": (
        "collector", "finished-request ring gauge supplier "
        "(engine/tracing.py)"),
    "trace.requests.buffered": (
        "gauge", "finished request traces held in the bounded ring the "
        "`pathway_tpu_torch requests` CLI reads"),
    "trace.requests.slowest.ms": (
        "gauge", "duration of the slowest buffered request trace (ms)"),
    "trace.requests.newest.ms": (
        "gauge", "duration of the newest buffered request trace (ms)"),
    # SLO engine (engine/slo.py)
    "slo.state": (
        "collector", "declared-SLO evaluation supplier (engine/slo.py)"),
    "slo.budget.remaining": (
        "gauge", "error-budget fraction remaining over the SLO's window, "
        "by slo= (1 = untouched, 0 = exhausted, negative = overspent)"),
    "slo.burn.rate": (
        "gauge", "error-budget burn rate by slo= and window= (1.0 = "
        "burning exactly the budget; sustained >1 exhausts it before the "
        "window ends)"),
    "slo.violations": (
        "counter", "burn-rate threshold crossings (burn > 1 rising edges) "
        "by slo= — each one also lands a flight-recorder slo.violation "
        "event"),
    # telemetry (engine/telemetry.py)
    "telemetry.export.dropped": (
        "counter", "telemetry payloads dropped by the bounded export queue"),
    "process.memory.usage": ("gauge", "resident set size in bytes"),
    "process.cpu.utime": ("gauge", "user CPU seconds"),
    "process.cpu.stime": ("gauge", "system CPU seconds"),
    "latency.input": ("gauge", "input lag of the latest ProberStats (ms)"),
    "latency.output": ("gauge", "output lag of the latest ProberStats (ms)"),
}


class _Enabled:
    """Shared mutable on/off flag — one attribute read per update."""

    __slots__ = ("on",)

    def __init__(self, on: bool):
        self.on = on


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter child (one label set)."""

    __slots__ = ("_value", "_enabled")

    def __init__(self, enabled: _Enabled):
        self._value = 0.0
        self._enabled = enabled

    def inc(self, amount: float = 1.0) -> None:
        if self._enabled.on:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time gauge child (one label set)."""

    __slots__ = ("_value", "_enabled")

    def __init__(self, enabled: _Enabled):
        self._value = 0.0
        self._enabled = enabled

    def set(self, value: float) -> None:
        if self._enabled.on:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if self._enabled.on:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self._enabled.on:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram child (one label set).

    Buckets are cumulative-on-read (Prometheus ``le`` semantics) but
    stored per-interval, so ``observe`` touches exactly one slot.
    """

    __slots__ = (
        "_enabled", "_bounds", "_counts", "_sum", "_count", "_lock",
        "_exemplars",
    )

    def __init__(self, enabled: _Enabled, bounds: tuple[float, ...]):
        self._enabled = enabled
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        # bucket index -> (trace_id, value, unix ts): the LAST traced
        # observation per bucket, rendered as an OpenMetrics exemplar
        # (`# {trace_id=...}`) so a slow bucket links to a real request
        # trace.  Lazily allocated — untraced histograms pay nothing.
        self._exemplars: dict[int, tuple[str, float, float]] | None = None

    def observe(self, value: float, trace_id: str | None = None) -> None:
        if not self._enabled.on:
            return
        i = bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if trace_id:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[i] = (trace_id, value, _time.time())

    def snapshot(self) -> tuple[tuple[float, ...], list[int], float, int]:
        """(bounds, per-interval counts, sum, count) — a consistent read."""
        with self._lock:
            return self._bounds, list(self._counts), self._sum, self._count

    def exemplars(self) -> dict[int, tuple[str, float, float]]:
        """``{bucket index: (trace_id, value, ts)}`` — the +Inf bucket is
        index ``len(bounds)``."""
        with self._lock:
            return dict(self._exemplars) if self._exemplars else {}

    def quantile(self, q: float) -> float | None:
        """Estimate the ``q``-quantile from the fixed buckets (linear
        interpolation within the holding bucket — Prometheus
        ``histogram_quantile`` semantics).  Observations in the +Inf
        bucket clamp to the highest finite bound; ``None`` when empty."""
        bounds, counts, _total, n = self.snapshot()
        if n == 0 or not bounds:
            return None
        rank = q * n
        cum = 0
        lo = 0.0
        for bound, c in zip(bounds, counts):
            if c and cum + c >= rank:
                return lo + (rank - cum) / c * (bound - lo)
            cum += c
            lo = bound
        return float(bounds[-1])


class _Family:
    """One named metric family holding children keyed by label set."""

    __slots__ = ("name", "help", "kind", "buckets", "_children", "_enabled", "_lock")

    def __init__(
        self,
        name: str,
        help_: str,
        kind: str,
        enabled: _Enabled,
        buckets: tuple[float, ...] | None = None,
    ):
        self.name = name
        self.help = help_
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.buckets = buckets
        self._children: dict[tuple, Any] = {}
        self._enabled = enabled
        # reentrant: counters are registered from the SIGUSR1 flight-
        # recorder path (persistence.fenced via FlightRecorder._fenced),
        # and the handler may interrupt the main thread inside labels() —
        # a plain Lock would deadlock the worker in the handler.  The
        # worst reentrant outcome is a double-created child (one lost
        # count), never a crash.
        self._lock = threading.RLock()

    def labels(self, **labels: Any):
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if self.kind == "counter":
                        child = Counter(self._enabled)
                    elif self.kind == "gauge":
                        child = Gauge(self._enabled)
                    else:
                        child = Histogram(self._enabled, self.buckets or DEFAULT_BUCKETS)
                    self._children[key] = child
        return child

    def items(self) -> list[tuple[tuple, Any]]:
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Process-wide registry of metric families + pull-time collectors.

    ``collector`` functions return flat ``{dotted-name: float}`` gauge
    dicts read at render/export time — the bridge for subsystems that
    already keep their own counters (``persistence.CommitMetrics``) and
    for snapshot suppliers (``ProberStats`` totals).  They are held via
    weakref to their owner, so a storage or prober that dies simply
    drops out of the exposition.
    """

    def __init__(self, *, enabled: bool | None = None):
        if enabled is None:
            from pathway_tpu_torch.internals.config import env_bool

            enabled = not env_bool("PATHWAY_METRICS_DISABLED")
        self._enabled = _Enabled(enabled)
        self._families: dict[str, _Family] = {}
        # reentrant for the same reason as _Family._lock: the SIGUSR1
        # handler's fence-counter registration may interrupt a frame that
        # already holds this lock (a torn double-create loses one count;
        # a plain Lock loses the worker)
        self._lock = threading.RLock()
        # name -> weakref-able callable returning {name: value}
        self._collectors: dict[str, Any] = {}

    # -- family accessors --------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled.on

    def set_enabled(self, on: bool) -> None:
        self._enabled.on = bool(on)

    def _family(
        self,
        name: str,
        help_: str,
        kind: str,
        buckets: tuple[float, ...] | None = None,
    ) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(name, help_, kind, self._enabled, buckets)
                    self._families[name] = fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as a {fam.kind}, "
                f"not a {kind}"
            )
        return fam

    def family(self, name: str) -> _Family | None:
        """Read-only family lookup — ``None`` when nothing has touched
        the name yet (the SLO evaluator reads families without creating
        them, so a never-observed metric stays absent from exposition)."""
        return self._families.get(name)

    def counter(self, name: str, help_: str = "", **labels: Any) -> Counter:
        return self._family(name, help_, "counter").labels(**labels)

    def gauge(self, name: str, help_: str = "", **labels: Any) -> Gauge:
        return self._family(name, help_, "gauge").labels(**labels)

    def histogram(
        self,
        name: str,
        help_: str = "",
        buckets: Iterable[float] | None = None,
        **labels: Any,
    ) -> Histogram:
        bounds = tuple(buckets) if buckets is not None else None
        return self._family(name, help_, "histogram", bounds).labels(**labels)

    # -- collectors --------------------------------------------------------
    def register_collector(
        self, name: str, fn: Callable[[], dict[str, float] | None]
    ) -> None:
        """Register a pull-time gauge supplier under a unique name
        (re-registering the name replaces the previous supplier).  Bound
        methods are held through a ``WeakMethod`` so the collector dies
        with its owner."""
        ref: Any
        try:
            ref = weakref.WeakMethod(fn)  # bound method: weak to the owner
        except TypeError:
            ref = lambda f=fn: f  # plain function/lambda: hold strongly
        with self._lock:
            self._collectors[name] = ref

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def collect(self) -> dict[str, float]:
        """Evaluate every live collector into one flat gauge dict."""
        with self._lock:
            refs = list(self._collectors.items())
        out: dict[str, float] = {}
        dead: list[tuple[str, Any]] = []
        for name, ref in refs:
            fn = ref()
            if fn is None:
                dead.append((name, ref))
                continue
            try:
                out.update(fn() or {})
            except Exception:  # noqa: BLE001 - a supplier must never break export
                continue
        if dead:
            with self._lock:
                for name, ref in dead:
                    if self._collectors.get(name) is ref:  # unchanged slot
                        self._collectors.pop(name, None)
        return out

    # -- reads -------------------------------------------------------------
    def scalar_metrics(self) -> dict[str, float]:
        """Flat ``{name[{labels}]: value}`` of counters/gauges + collector
        output — the form the OTLP gauge exporter and the dashboard eat.
        Labeled children get a ``name{k=v,...}`` suffix so distinct label
        sets stay distinct.  Histogram quantile estimates ride along as
        derived ``<name>.p50/.p95/.p99`` gauges, so every scalar surface
        (OTLP, dashboard) sees latency percentiles for free."""
        out: dict[str, float] = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            if fam.kind == "histogram":
                continue
            for key, child in fam.items():
                if key:
                    label_str = ",".join(f"{k}={v}" for k, v in key)
                    out[f"{fam.name}{{{label_str}}}"] = child.value
                else:
                    out[fam.name] = child.value
        out.update(self.histogram_quantiles())
        out.update(self.collect())
        return out

    def histogram_quantiles(self) -> dict[str, float]:
        """Derived ``{name.pXX[{labels}]: value}`` gauges for every
        non-empty histogram child (see :data:`QUANTILES`)."""
        out: dict[str, float] = {}
        with self._lock:
            families = [f for f in self._families.values() if f.kind == "histogram"]
        for fam in families:
            for key, child in fam.items():
                for suffix, q in QUANTILES:
                    value = child.quantile(q)
                    if value is None:
                        continue
                    name = f"{fam.name}.{suffix}"
                    if key:
                        label_str = ",".join(f"{k}={v}" for k, v in key)
                        name = f"{name}{{{label_str}}}"
                    out[name] = value
        return out

    def histogram_points(self) -> list[dict[str, Any]]:
        """Histogram snapshots in exporter-neutral form:
        ``{name, labels, bounds, bucket_counts (per-interval), sum, count}``."""
        points: list[dict[str, Any]] = []
        with self._lock:
            families = [f for f in self._families.values() if f.kind == "histogram"]
        for fam in families:
            for key, child in fam.items():
                bounds, counts, total, n = child.snapshot()
                points.append(
                    {
                        "name": fam.name,
                        "labels": dict(key),
                        "bounds": list(bounds),
                        "bucket_counts": counts,
                        "sum": total,
                        "count": n,
                    }
                )
        return points

    # -- Prometheus text exposition ---------------------------------------
    def render_prometheus(self, extra_labels: dict[str, str] | None = None) -> str:
        """Exposition-format text for every family + collector gauge.

        No trailing ``# EOF`` — the caller composing a full scrape body
        (``engine/http_server.py``) appends it once."""
        lines: list[str] = []
        extra = _label_key(extra_labels or {})
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        for fam in families:
            prom = _prom_name(fam.name)
            items = fam.items()
            if not items:
                continue
            lines.append(f"# HELP {prom} {fam.help or fam.name}")
            lines.append(f"# TYPE {prom} {fam.kind}")
            for key, child in items:
                label_str = _prom_labels(key + extra)
                if fam.kind == "histogram":
                    bounds, counts, total, n = child.snapshot()
                    exemplars = child.exemplars()
                    cum = 0
                    for i, (bound, c) in enumerate(zip(bounds, counts)):
                        cum += c
                        le = _prom_labels(
                            key + extra + (("le", _format_bound(bound)),)
                        )
                        lines.append(
                            f"{prom}_bucket{le} {cum}"
                            + _format_exemplar(exemplars.get(i))
                        )
                    cum += counts[-1]
                    le = _prom_labels(key + extra + (("le", "+Inf"),))
                    lines.append(
                        f"{prom}_bucket{le} {cum}"
                        + _format_exemplar(exemplars.get(len(bounds)))
                    )
                    lines.append(f"{prom}_sum{label_str} {_format_value(total)}")
                    lines.append(f"{prom}_count{label_str} {n}")
                else:
                    lines.append(
                        f"{prom}{label_str} {_format_value(child.value)}"
                    )
            if fam.kind == "histogram":
                # bucket-derived quantile gauges, one synthetic family per
                # quantile — scrapers that can't run histogram_quantile()
                # (and the dashboard footer) read percentiles directly
                for suffix, q in QUANTILES:
                    qsamples = [
                        (key, child.quantile(q)) for key, child in items
                    ]
                    qsamples = [(k, v) for k, v in qsamples if v is not None]
                    if not qsamples:
                        continue
                    lines.append(
                        f"# HELP {prom}_{suffix} {suffix} estimate of "
                        f"{fam.help or fam.name}"
                    )
                    lines.append(f"# TYPE {prom}_{suffix} gauge")
                    for key, value in qsamples:
                        lines.append(
                            f"{prom}_{suffix}{_prom_labels(key + extra)} "
                            f"{_format_value(value)}"
                        )
        collected = self.collect()
        if collected:
            # collector keys may carry a "{k=v,...}" label suffix (the
            # profiler's per-operator gauges do): split it into real
            # Prometheus labels — mangling it into the metric NAME would
            # mint a new family per label set (unbounded name cardinality)
            grouped: dict[str, list[tuple[tuple, float]]] = {}
            for name in sorted(collected):
                base, labels = split_labeled_name(name)
                grouped.setdefault(base, []).append(
                    (_label_key(labels), collected[name])
                )
            for base, samples in grouped.items():
                prom = _prom_name(base)
                lines.append(f"# HELP {prom} {base}")
                lines.append(f"# TYPE {prom} gauge")
                for key, value in samples:
                    lines.append(
                        f"{prom}{_prom_labels(key + extra)} "
                        f"{_format_value(value)}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    def exemplar_points(self) -> dict[str, list[dict[str, Any]]]:
        """Every histogram child's bucket exemplars, keyed by the
        ``name{labels}`` scalar form — the ``/status`` exemplar view
        (``engine/http_server.py``'s ``requests`` section)."""
        out: dict[str, list[dict[str, Any]]] = {}
        with self._lock:
            families = [f for f in self._families.values() if f.kind == "histogram"]
        for fam in families:
            for key, child in fam.items():
                exemplars = child.exemplars()
                if not exemplars:
                    continue
                bounds = child.snapshot()[0]
                name = fam.name
                if key:
                    label_str = ",".join(f"{k}={v}" for k, v in key)
                    name = f"{name}{{{label_str}}}"
                out[name] = [
                    {
                        "le": (
                            _format_bound(bounds[i])
                            if i < len(bounds)
                            else "+Inf"
                        ),
                        "trace_id": trace_id,
                        "value": value,
                        "ts": ts,
                    }
                    for i, (trace_id, value, ts) in sorted(exemplars.items())
                ]
        return out

    # -- OTLP mapping ------------------------------------------------------
    def otlp_metrics(self, ts: float | None = None) -> list[dict]:
        """This registry's families as OTLP JSON ``metrics`` entries —
        scalars as gauge datapoints, histograms as histogram datapoints
        (the opentelemetry-proto JSON mapping).  The caller wraps them in
        its ``resourceMetrics`` envelope (``engine/telemetry.py``)."""
        t_ns = str(int((ts if ts is not None else _time.time()) * 1e9))
        out: list[dict] = []
        for name, value in self.scalar_metrics().items():
            out.append(otlp_gauge(name, value, t_ns))
        for point in self.histogram_points():
            out.append(otlp_histogram(point, t_ns))
        return out


def otlp_gauge(name: str, value: float, t_ns: str) -> dict:
    """One scalar metric as an OTLP JSON gauge ``metrics`` entry.  A
    ``"{k=v,...}"`` label suffix on the name (the ``scalar_metrics`` form)
    becomes datapoint attributes — OTLP wants the clean base name."""
    base, labels = split_labeled_name(name)
    dp: dict[str, Any] = {"asDouble": float(value), "timeUnixNano": t_ns}
    if labels:
        dp["attributes"] = [
            {"key": k, "value": {"stringValue": v}} for k, v in labels.items()
        ]
    return {"name": base, "gauge": {"dataPoints": [dp]}}


def otlp_histogram(point: dict[str, Any], t_ns: str) -> dict:
    """One exporter-neutral histogram point (``histogram_points`` form) as
    an OTLP JSON ``metrics`` entry with a real histogram datapoint."""
    dp: dict[str, Any] = {
        "startTimeUnixNano": t_ns,
        "timeUnixNano": t_ns,
        "count": str(point["count"]),
        "sum": point["sum"],
        "bucketCounts": [str(c) for c in point["bucket_counts"]],
        "explicitBounds": list(point["bounds"]),
    }
    if point.get("labels"):
        dp["attributes"] = [
            {"key": k, "value": {"stringValue": str(v)}}
            for k, v in point["labels"].items()
        ]
    return {
        "name": point["name"],
        "histogram": {
            "dataPoints": [dp],
            "aggregationTemporality": 2,  # CUMULATIVE
        },
    }


def _prom_name(name: str) -> str:
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return safe if safe.startswith("pathway_") else f"pathway_{safe}"


def escape_label(value: str) -> str:
    """Escape a Prometheus label value per the exposition format."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{escape_label(str(v))}"' for k, v in key)
    return "{" + inner + "}"


def _format_bound(bound: float) -> str:
    if bound == int(bound):
        return str(int(bound)) + ".0"
    return repr(bound)


def _format_exemplar(ex: tuple[str, float, float] | None) -> str:
    """OpenMetrics exemplar suffix for one bucket line (empty when the
    bucket never saw a traced observation):
    ``# {trace_id="..."} <value> <ts>``."""
    if ex is None:
        return ""
    trace_id, value, ts = ex
    return (
        f' # {{trace_id="{escape_label(str(trace_id))}"}} '
        f"{_format_value(value)} {ts:.3f}"
    )


def _format_value(value: float) -> str:
    if isinstance(value, float) and math.isfinite(value) and value == int(value):
        return str(int(value))
    return repr(float(value))


def split_labeled_name(name: str) -> tuple[str, dict[str, str]]:
    """``"a.b{k=v,k2=v2}"`` → ``("a.b", {"k": "v", "k2": "v2"})``."""
    if not name.endswith("}") or "{" not in name:
        return name, {}
    base, _, rest = name.partition("{")
    labels: dict[str, str] = {}
    for pair in rest[:-1].split(","):
        k, _, v = pair.partition("=")
        if k:
            labels[k] = v
    return base, labels


# ---------------------------------------------------------------------------
# Process-wide default registry
# ---------------------------------------------------------------------------

_registry: MetricsRegistry | None = None
# reentrant: get_registry() sits on the SIGUSR1 flight-recorder path and
# may interrupt a first-call construction on the main thread
_registry_lock = threading.RLock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem registers into."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
    return _registry


def set_enabled(on: bool) -> None:
    """Flip instrumentation on/off process-wide (benchmark lever)."""
    get_registry().set_enabled(on)
