"""The ``PATHWAY_DEVICE_*`` environment knobs of the device executor, the
worker topology that ``parallel/mesh.py::initialize_distributed`` reads,
the dataflow engine's switches (``PATHWAY_NATIVE``, ``PATHWAY_COLUMNAR``),
the serving edge's (``PATHWAY_SERVE_*``, ``PATHWAY_TRACE_*``), the
persistence group (``PATHWAY_CHECKPOINT_*``, ``PATHWAY_BLOB_*``, the
record/replay root) and the part of ``PathwayConfig`` that the expression
evaluator and the runner's storage path read.

A copy of the executor's part of ``pathway_tpu/internals/config.py``
(``ENV_KNOBS`` and the typed accessors) and of its worker-topology fields
(``processes``, ``process_id``, ``first_port``, ``peer_hosts``): the same
names, types, defaults and parsing, so one environment configures both
packages alike.  Only the knobs the port reads are declared; reading any
other name raises ``KeyError``.  Accessors read ``os.environ`` live, so
tests can monkeypatch between runs.

Not carried over: ``PATHWAY_DEVICE_DONATE`` (buffer donation is an XLA
notion; an eager PyTorch call never donates its inputs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from contextvars import ContextVar
from typing import Any


@dataclasses.dataclass(frozen=True)
class EnvKnob:
    """One declared ``PATHWAY_*`` environment knob."""

    name: str
    kind: str  # "bool" | "int" | "float" | "str"
    default: Any
    doc: str


ENV_KNOBS: tuple[EnvKnob, ...] = (
    EnvKnob("PATHWAY_DEVICE_MAX_BATCH", "int", 512,
            "largest batch bucket of the executor's default bucketing policy"),
    EnvKnob("PATHWAY_DEVICE_INFLIGHT_MB", "float", 256.0,
            "in-flight byte budget of the async dispatch queue"),
    EnvKnob("PATHWAY_DEVICE_INFLIGHT_REQUESTS", "int", 64,
            "in-flight request budget of the async dispatch queue"),
    EnvKnob("PATHWAY_DEVICE_COST_ANALYSIS", "bool", True,
            "count FLOPs once per cache key; `0` leaves every dispatch uncosted"),
    EnvKnob("PATHWAY_DEVICE_PEAK_FLOPS", "float", None,
            "peak FLOP/s for the utilization estimate (default: the device-kind table)"),
    EnvKnob("PATHWAY_DEVICE_TRACE_DIR", "str", None,
            "base directory for on-demand torch.profiler traces; unset disables capture"),
    EnvKnob("PATHWAY_DEVICE_RESILIENCE", "bool", True,
            "the typed failure rail (retry, OOM ratchet, breaker, quarantine)"),
    EnvKnob("PATHWAY_DEVICE_RETRIES", "int", 2,
            "bounded retries of a transient device failure per dispatch"),
    EnvKnob("PATHWAY_DEVICE_RETRY_DEADLINE_S", "float", 30.0,
            "wall-clock cap on one dispatch's retries"),
    EnvKnob("PATHWAY_DEVICE_RETRY_BACKOFF_MS", "float", 50.0,
            "initial retry backoff (doubles per attempt, jittered by half)"),
    EnvKnob("PATHWAY_DEVICE_BREAKER_THRESHOLD", "int", 5,
            "consecutive device failures that trip a callable's breaker open"),
    EnvKnob("PATHWAY_DEVICE_BREAKER_COOLDOWN_S", "float", 10.0,
            "open-breaker cooldown before one half-open probe"),
    EnvKnob("PATHWAY_DEVICE_DISPATCH_DEADLINE_S", "float", 0.0,
            "hard per-job dispatch deadline; 0 disables hang escalation"),
    EnvKnob("PATHWAY_DEVICE_QUARANTINE_KEEP", "int", 32,
            "poisoned-batch quarantine records kept per executor"),
    EnvKnob("PATHWAY_DEVICE_COORDINATOR", "str", None,
            "host:port of the multi-process device group's rendezvous"),
    EnvKnob("PATHWAY_PROCESSES", "int", 1, "worker processes of the cluster"),
    EnvKnob("PATHWAY_PROCESS_ID", "int", 0, "this worker's process id"),
    EnvKnob("PATHWAY_FIRST_PORT", "int", 10000, "first port of the workers' TCP mesh"),
    EnvKnob("PATHWAY_PEER_HOSTS", "str", None,
            "comma-separated hostname per worker id; unset = localhost"),
    EnvKnob("PATHWAY_TERMINATE_ON_ERROR", "bool", True,
            "terminate the run on the first operator error (else poison rows "
            "and continue)"),
    EnvKnob("PATHWAY_NATIVE", "bool", True,
            "`0` disables the native C++ core (pure-Python fallback)"),
    EnvKnob("PATHWAY_NATIVE_BUILD_DIR", "str", None,
            "directory of the native core's build (default: native/build)"),
    EnvKnob("PATHWAY_COLUMNAR", "bool", True,
            "`0` forces every operator onto the row-wise reference evaluator"),
    # -- models and generation (models/encoder.py, serving/generation.py) ---
    EnvKnob("PATHWAY_FUSED_ENCODER", "bool", True,
            "use the fused encoder trunk; `0` runs the module forward (host only)"),
    EnvKnob("PATHWAY_ENCODER_QUANTIZE", "str", None,
            "`int8` enables W8A8 sentence-encoder inference"),
    EnvKnob("PATHWAY_GENERATE_CONTINUOUS", "bool", True,
            "route `JaxChat` decoder generation through the continuous-batching "
            "scheduler (paged KV, per-step admission); `0` reverts to the static "
            "per-config `AsyncMicroBatcher` path"),
    EnvKnob("PATHWAY_GENERATE_SLOTS", "int", 8,
            "generation slot count: the fixed batch width of the continuous decode step"),
    EnvKnob("PATHWAY_GENERATE_PAGE_SIZE", "int", 16,
            "tokens per KV page; KV memory is allocated and freed in pages"),
    EnvKnob("PATHWAY_GENERATE_PAGES", "int", 0,
            "KV pool size in pages (page 0 is the reserved null page); 0 auto-sizes "
            "to half the dense worst case, floored so one full-cache request fits"),
    EnvKnob("PATHWAY_GENERATE_PREFILL_CHUNK", "int", 32,
            "prompt tokens prefilled per tick per slot (chunked prefill)"),
    EnvKnob("PATHWAY_GENERATE_QUEUE", "int", 128,
            "max requests queued for a generation slot; overflow is answered 429"),
    # -- observability (engine/metrics.py, telemetry.py, slo.py, profiler.py,
    # freshness.py, http_server.py, internals/license.py) -------------------
    EnvKnob("PATHWAY_METRICS_DISABLED", "bool", False,
            "kill switch: turn every metric update into an immediate return"),
    EnvKnob("PATHWAY_MONITORING_SERVER", "str", None,
            "OTLP/HTTP collector endpoint for telemetry export (zero egress when unset)"),
    EnvKnob("PATHWAY_MONITORING_HTTP_PORT", "int", None,
            "serve `GET /metrics`, `/status` and `/trace` on this port (worker i uses port + i)"),
    EnvKnob("PATHWAY_LICENSE_KEY", "str", None,
            "license key for entitlement checks (internals/license.py)"),
    EnvKnob("PATHWAY_TELEMETRY_PROTOCOL", "str", "otlp-json",
            "telemetry wire format: `otlp-json` | `pathway-json` (legacy line JSON)"),
    EnvKnob("PATHWAY_SERVICE_INSTANCE_ID", "str", None,
            "OTel `service.instance.id` resource attribute (default: random per process)"),
    EnvKnob("PATHWAY_SERVICE_NAMESPACE", "str", "local-dev",
            "OTel `service.namespace` resource attribute"),
    EnvKnob("PATHWAY_SLOS", "str", None,
            "extra SLO declarations (`name: metric pNN < threshold over window`; "
            "semicolon-separated) merged over the built-in registry"),
    EnvKnob("PATHWAY_PROFILE", "bool", False,
            "the per-operator epoch profiler (top-N `profiler.operator.*` snapshots)"),
    EnvKnob("PATHWAY_PROFILE_SAMPLE_EVERY", "int", 16,
            "profiler cadence: aggregate operator totals every N processed epochs"),
    EnvKnob("PATHWAY_PROFILE_TOP", "int", 20,
            "operators kept per profiler snapshot"),
    EnvKnob("PATHWAY_PROFILE_OUTPUT", "str", None,
            "write the run's final profiler snapshot to this JSON path "
            "(render it with `python -m pathway_tpu_torch profile <path>`)"),
    EnvKnob("PATHWAY_PROFILE_TRANSFERS", "bool", False,
            "count the executor's host<->device staging bytes (`device.transfer.*`)"),
    EnvKnob("PATHWAY_FRESHNESS", "bool", True,
            "ingest-time freshness (`freshness.e2e.ms`, `output.staleness.s`) and "
            "`backlog.*` gauges; `0` removes the per-epoch watermark pass"),
    EnvKnob("PATHWAY_STATUS_REFRESH_S", "float", 1.0,
            "default poll interval of `python -m pathway_tpu_torch top` (`GET /status`)"),
    EnvKnob("PATHWAY_TRACE_REQUESTS", "bool", True,
            "request-scoped tracing of the serving path; `0` removes the span layer"),
    EnvKnob("PATHWAY_TRACE_BUFFER", "int", 256,
            "finished request traces kept in the in-process ring"),
    EnvKnob("PATHWAY_SERVE_ADMISSION", "bool", True,
            "`0` disables the serving admission controller (every request admitted)"),
    EnvKnob("PATHWAY_SERVE_DEADLINE_MS", "float", 30000.0,
            "default per-request deadline of REST queries (`X-Pathway-Deadline-Ms` overrides)"),
    EnvKnob("PATHWAY_SERVE_INFLIGHT", "int", 64,
            "admission: max REST requests inside the pipeline at once"),
    EnvKnob("PATHWAY_SERVE_INFLIGHT_MB", "float", 32.0,
            "admission: max summed request-body MB in flight"),
    EnvKnob("PATHWAY_SERVE_QUEUE", "int", 128,
            "admission: max requests waiting for an in-flight slot; overflow is 429"),
    EnvKnob("PATHWAY_SERVE_QUEUE_DELAY_MS", "float", 250.0,
            "load shedding: target queue delay that arms the shedder"),
    EnvKnob("PATHWAY_SERVE_SHED_DWELL_S", "float", 1.0,
            "load shedding: seconds above target before degraded mode engages"),
    EnvKnob("PATHWAY_SERVE_RECOVER_S", "float", 5.0,
            "load shedding: seconds back under target before degraded mode ends"),
    EnvKnob("PATHWAY_SERVE_DRAIN_S", "float", 10.0,
            "graceful drain budget of in-flight requests on stop-accept"),
    EnvKnob("PATHWAY_REPLAY_STORAGE", "str", None,
            "persistence root for record/replay runs (enables persistence "
            "without an explicit `pw.persistence.Config`)"),
    EnvKnob("PATHWAY_SNAPSHOT_ACCESS", "str", None,
            "`record` | `replay` — connector snapshot mode for record/replay runs"),
    EnvKnob("PATHWAY_CONTINUE_AFTER_REPLAY", "bool", False,
            "keep consuming live connector data after a recorded stream drains"),
    EnvKnob("PATHWAY_RESTART_ATTEMPT", "int", 0,
            "supervisor restart attempt of this process (0 = first launch)"),
    EnvKnob("PATHWAY_INCARNATION", "int", 0,
            "cluster incarnation lease this worker runs under (exported by the "
            "supervisor; fences zombie writers out of the root)"),
    EnvKnob("PATHWAY_WORKER_FENCE", "int", 0,
            "per-worker fence token of a promoted standby (0 otherwise)"),
    EnvKnob("PATHWAY_CHECKPOINT_GENERATIONS", "int", 3,
            "committed checkpoint generations retained (the deferred-GC "
            "fallback window)"),
    EnvKnob("PATHWAY_CHECKPOINT_WRITERS", "int", 2,
            "background checkpoint writer threads; 0 = fully synchronous commits"),
    EnvKnob("PATHWAY_CHECKPOINT_INFLIGHT_MB", "int", 256,
            "cap of in-flight snapshot bytes before commit staging "
            "backpressures the epoch thread"),
    EnvKnob("PATHWAY_CHECKPOINT_PUBLISH_INTERVAL_MS", "float", 20.0,
            "minimum spacing between pipelined manifest publishes (staged "
            "frontiers conflate while the committer waits)"),
    EnvKnob("PATHWAY_BLOB_RETRIES", "int", 3,
            "bounded retries for transient object-store errors"),
    EnvKnob("PATHWAY_BLOB_RETRY_INITIAL_MS", "int", 200,
            "initial backoff of the blob retry schedule"),
    EnvKnob("PATHWAY_PERSISTENT_STORAGE", "str", None,
            "filesystem root for the UDF DiskCache when no persistence config "
            "is active"),
    EnvKnob("PATHWAY_PERSISTENCE_MODE", "str", None,
            "persistence/replay pacing mode (`batch` | `speedrun`)"),
    EnvKnob("PATHWAY_REPLAY_MODE", "str", None,
            "legacy alias of PATHWAY_PERSISTENCE_MODE written by `python -m "
            "pathway_tpu_torch replay --mode`"),
    EnvKnob("PATHWAY_THREADS", "int", 1,
            "worker threads per spawned process (accepted for parity; the "
            "device mesh is what scales compute)"),
    EnvKnob("PATHWAY_RUN_ID", "str", None,
            "cluster run id minted by `python -m pathway_tpu_torch spawn` "
            "(one per run, kept across supervised restarts)"),
    EnvKnob("PATHWAY_COMM_SECRET", "str", '',
            "shared mesh handshake secret (`spawn` mints one per run); empty "
            "disables authentication and pickled frame values"),
    EnvKnob("PATHWAY_COMM_MAX_FRAME_MB", "int", 256,
            "frame-size cap in MiB — a corrupt or hostile length field must not "
            "OOM the worker"),
    EnvKnob("PATHWAY_COMM_RECV_TIMEOUT_S", "float", 300.0,
            "deadline for `recv()` waiting on a tagged frame"),
    EnvKnob("PATHWAY_COMM_HEARTBEAT_S", "float", 2.0,
            "heartbeat send interval per link"),
    EnvKnob("PATHWAY_COMM_HEARTBEAT_TIMEOUT_S", "float", 30.0,
            "force-fail a link whose peer was silent (or stopped acking) for "
            "this long"),
    EnvKnob("PATHWAY_COMM_RECONNECT_WINDOW_S", "float", 15.0,
            "window a failed link may reconnect + resync before the peer is "
            "declared dead and its inbox purged"),
    EnvKnob("PATHWAY_COMM_SEND_DEADLINE_S", "float", None,
            "SO_SNDTIMEO deadline on any single blocking socket write (default: "
            "the heartbeat timeout; 0 disables)"),
    EnvKnob("PATHWAY_COMM_SEND_BUFFER_MB", "float", 64.0,
            "per-link retransmit buffer in MiB (unacked frames kept for "
            "reconnect resync)"),
    EnvKnob("PATHWAY_FAULT_PLAN", "str", None,
            "seeded fault-injection plan (JSON) for chaos/soak runs"),
    EnvKnob("PATHWAY_EPOCH_DEADLINE_S", "float", None,
            "hung-worker watchdog: no epoch progress for this long → SIGUSR1 "
            "(flight-recorder dump) → SIGTERM → SIGKILL into a supervised "
            "restart (unset or <= 0 disables)"),
    EnvKnob("PATHWAY_DEGRADED_SHRINK", "bool", False,
            "degraded-mode shrink (opt-in): when the same worker fails every "
            "attempt of a spent restart budget, rescale the supervised cluster "
            "to the surviving count instead of failing — checkpointed state re- "
            "partitions by shard range on resume"),
    EnvKnob("PATHWAY_STANDBY_COUNT", "int", 0,
            "warm-standby pool size (opt-in, `spawn --supervise --standbys`): K "
            "extra processes tail the persistence root so unplanned worker loss "
            "promotes a standby instead of restarting the group"),
    EnvKnob("PATHWAY_STANDBY_ID", "int", None,
            "exported by the supervisor into each standby process; its presence "
            "is what routes a spawned worker into standby-tailer mode instead "
            "of the event loop"),
    EnvKnob("PATHWAY_STANDBY_POLL_S", "float", 0.2,
            "standby tail cadence: how often a standby re-lists manifests, "
            "verifies newly committed generations, and refreshes its apply- "
            "cursor beacon"),
    EnvKnob("PATHWAY_STANDBY_PROMOTE_DEADLINE_S", "float", 20.0,
            "promotion deadline: if the standby + every survivor have not acked "
            "the PROMOTE request within this budget, the supervisor aborts the "
            "promotion and falls back to whole-group restart"),
    EnvKnob("PATHWAY_STANDBY_PROMOTIONS", "int", 8,
            "per-run promotion budget (separate from the restart budget): once "
            "spent, further worker deaths fall back to whole-group restart"),
    EnvKnob("PATHWAY_AUTOSCALE", "bool", False,
            "load-adaptive autoscaling (opt-in): the supervisor polls worker "
            "load beacons and grows/shrinks the cluster via live shard handoff "
            "under the PATHWAY_AUTOSCALE_* budgets below"),
    EnvKnob("PATHWAY_AUTOSCALE_MIN_WORKERS", "int", 1,
            "shrink floor: the controller never targets fewer workers than this "
            "(and never below 1 regardless)"),
    EnvKnob("PATHWAY_AUTOSCALE_MAX_WORKERS", "int", 8,
            "grow ceiling: the controller never targets more workers than this"),
    EnvKnob("PATHWAY_AUTOSCALE_STALENESS_S", "float", 5.0,
            "grow trigger: worst per-worker output staleness above this for a "
            "full dwell window means the cluster is falling behind"),
    EnvKnob("PATHWAY_AUTOSCALE_DWELL_S", "float", 10.0,
            "hysteresis dwell: the grow trigger must hold CONTINUOUSLY for this "
            "long before a rescale fires (one dip below threshold resets the "
            "clock) — oscillating load never flaps"),
    EnvKnob("PATHWAY_AUTOSCALE_COOLDOWN_S", "float", 60.0,
            "post-rescale cooldown: no further scaling decision (either "
            "direction) for this long after a rescale fires"),
    EnvKnob("PATHWAY_AUTOSCALE_IDLE_S", "float", 30.0,
            "shrink trigger: staleness comfortably low AND backlog ~empty "
            "continuously for this long shrinks the cluster one step"),
    EnvKnob("PATHWAY_AUTOSCALE_BUDGET", "int", 4,
            "rescale budget: total grow/shrink decisions this supervisor run "
            "may fire; exhaustion logs loudly and pins the topology"),
    EnvKnob("PATHWAY_AUTOSCALE_HANDOFF_DEADLINE_S", "float", 30.0,
            "live-handoff deadline: a posted handoff the workers have not fully "
            "acked within this window falls back to the restart-based rescale"),
    EnvKnob("PATHWAY_SPAWN_ARGS", "str", None,
            "arguments for `python -m pathway_tpu_torch spawn-from-env` "
            "(the k8s-operator hook)"),
    EnvKnob("PATHWAY_TORCH_DISTRIBUTED", "bool", False,
            "the host workers also join one torch.distributed world "
            "(`spawn --torch-distributed`), the port's counterpart of "
            "PATHWAY_JAX_DISTRIBUTED"),
)

ENV_REGISTRY: dict[str, EnvKnob] = {k.name: k for k in ENV_KNOBS}

_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")


def _knob(name: str) -> EnvKnob:
    knob = ENV_REGISTRY.get(name)
    if knob is None:
        raise KeyError(f"{name} is not a declared environment knob of the port")
    return knob


def env_raw(name: str) -> str | None:
    """The raw environment value of a declared knob (None when unset), for
    knobs whose parse is deliberately custom."""
    _knob(name)
    return os.environ.get(name)


def env_str(name: str, default: Any = ...) -> Any:
    knob = _knob(name)
    raw = os.environ.get(name)
    if raw is None:
        return knob.default if default is ... else default
    return raw


def env_bool(name: str, default: Any = ...) -> bool:
    knob = _knob(name)
    fallback = knob.default if default is ... else default
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return bool(fallback)  # empty = unset, as env_int/env_float read it
    v = raw.strip().lower()
    if v in _TRUTHY:
        return True
    if v in _FALSY:
        return False
    return bool(fallback)


def env_int(name: str, default: Any = ...) -> Any:
    knob = _knob(name)
    fallback = knob.default if default is ... else default
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return fallback
    try:
        return int(raw)
    except ValueError:
        return fallback


def env_float(name: str, default: Any = ...) -> Any:
    knob = _knob(name)
    fallback = knob.default if default is ... else default
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return fallback
    try:
        return float(raw)
    except ValueError:
        return fallback


def render_env_docs() -> str:
    """``docs/torch_configuration.md``, generated.  The lint gate pins the
    file byte-identical to this render (rule ``env-docs-stale``)."""
    lines = [
        "# Configuration knobs of pathway_tpu_torch",
        "",
        "<!-- GENERATED FILE — do not edit. -->",
        "<!-- Source: pathway_tpu_torch/internals/config.py:ENV_KNOBS. -->",
        "<!-- Regenerate: python -m pathway_tpu_torch lint --update-config-docs -->",
        "",
        "Every `PATHWAY_*` environment variable the port reads, in one",
        "declared registry (`internals/config.py:ENV_KNOBS`).  Code reads",
        "these through typed accessors (`config.env_bool` / `env_int` /",
        "`env_float` / `env_str` / `env_raw`); `python -m pathway_tpu_torch",
        "lint` rejects direct `os.environ` reads (`env-direct-read`) and",
        "undeclared names (`env-undeclared`), so this page is complete by",
        "construction.  The JAX package's page is `docs/configuration.md`.",
        "",
        "| Variable | Type | Default | Meaning |",
        "|---|---|---|---|",
    ]
    for k in ENV_KNOBS:
        default = "—" if k.default is None else repr(k.default)
        lines.append(f"| `{k.name}` | {k.kind} | `{default}` | {k.doc} |")
    lines.append("")
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class WorkerTopology:
    """The worker-topology fields of the JAX package's ``PathwayConfig``
    (``config.rs:88-120`` in the reference), read from the environment."""

    processes: int
    process_id: int
    first_port: int
    peer_hosts: list | None


def worker_topology() -> WorkerTopology:
    hosts = env_str("PATHWAY_PEER_HOSTS")
    return WorkerTopology(
        processes=env_int("PATHWAY_PROCESSES"),
        process_id=env_int("PATHWAY_PROCESS_ID"),
        first_port=env_int("PATHWAY_FIRST_PORT"),
        peer_hosts=[h.strip() for h in hosts.split(",")] if hosts else None,
    )


@dataclasses.dataclass
class PathwayConfig:
    """The fields of the JAX package's ``PathwayConfig`` that the port's
    dataflow, its storage path and its multi-worker runner read; the rest
    arrive with the slices that read them."""

    terminate_on_error: bool = dataclasses.field(
        default_factory=lambda: env_bool("PATHWAY_TERMINATE_ON_ERROR")
    )
    replay_storage: str | None = dataclasses.field(
        default_factory=lambda: env_str("PATHWAY_REPLAY_STORAGE")
    )
    snapshot_access: str | None = dataclasses.field(
        default_factory=lambda: env_str("PATHWAY_SNAPSHOT_ACCESS")
    )
    continue_after_replay: bool = dataclasses.field(
        default_factory=lambda: env_bool("PATHWAY_CONTINUE_AFTER_REPLAY")
    )
    processes: int = dataclasses.field(
        default_factory=lambda: env_int("PATHWAY_PROCESSES")
    )
    process_id: int = dataclasses.field(
        default_factory=lambda: env_int("PATHWAY_PROCESS_ID")
    )
    threads: int = dataclasses.field(default_factory=lambda: env_int("PATHWAY_THREADS"))
    first_port: int = dataclasses.field(
        default_factory=lambda: env_int("PATHWAY_FIRST_PORT")
    )
    # multi-host clusters: comma-separated hostname per worker id
    # (PATHWAY_PEER_HOSTS=pod-0.svc,pod-1.svc,...); empty = localhost mesh
    peer_hosts: list | None = dataclasses.field(
        default_factory=lambda: worker_topology().peer_hosts
    )
    run_id: str | None = dataclasses.field(
        default_factory=lambda: env_str("PATHWAY_RUN_ID")
    )
    license_key: str | None = dataclasses.field(
        default_factory=lambda: env_str("PATHWAY_LICENSE_KEY")
    )
    monitoring_server: str | None = dataclasses.field(
        default_factory=lambda: env_str("PATHWAY_MONITORING_SERVER")
    )
    monitoring_http_port: int | None = dataclasses.field(
        default_factory=lambda: env_int("PATHWAY_MONITORING_HTTP_PORT")
    )

    @property
    def worker_count(self) -> int:
        return self.threads * self.processes


_config_var: ContextVar[PathwayConfig | None] = ContextVar("pathway_config", default=None)
_global_config: PathwayConfig | None = None


def get_config() -> PathwayConfig:
    cfg = _config_var.get()
    if cfg is not None:
        return cfg
    global _global_config
    if _global_config is None:
        _global_config = PathwayConfig()
    return _global_config


@contextlib.contextmanager
def local_pathway_config(**overrides: Any):
    cfg = dataclasses.replace(get_config(), **overrides)
    token = _config_var.set(cfg)
    try:
        yield cfg
    finally:
        _config_var.reset(token)


def refresh_config() -> None:
    """Re-read the process-wide config from the environment."""
    global _global_config
    _global_config = PathwayConfig()


def set_license_key(key: str | None) -> None:
    get_config().license_key = key


def set_monitoring_config(*, server_endpoint: str | None = None) -> None:
    """Point this process's telemetry at an OTLP/HTTP collector (``None``
    turns export off); read when the next ``pw.run`` starts."""
    get_config().monitoring_server = server_endpoint


def pathway_config() -> PathwayConfig:
    return get_config()
