"""The ``PATHWAY_DEVICE_*`` environment knobs of the device executor, the
worker topology that ``parallel/mesh.py::initialize_distributed`` reads,
the dataflow engine's switches (``PATHWAY_NATIVE``, ``PATHWAY_COLUMNAR``),
the serving edge's (``PATHWAY_SERVE_*``, ``PATHWAY_TRACE_*``)
and the part of ``PathwayConfig`` that the expression evaluator reads.

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
)

ENV_REGISTRY: dict[str, EnvKnob] = {k.name: k for k in ENV_KNOBS}

_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")


def _knob(name: str) -> EnvKnob:
    knob = ENV_REGISTRY.get(name)
    if knob is None:
        raise KeyError(f"{name} is not a declared environment knob of the port")
    return knob


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
    dataflow reads; the rest arrive with the slices that read them."""

    terminate_on_error: bool = dataclasses.field(
        default_factory=lambda: env_bool("PATHWAY_TERMINATE_ON_ERROR")
    )


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
