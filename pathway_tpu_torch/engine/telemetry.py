"""Telemetry: periodic process metrics and run spans, license-gated.

The port's copy of ``pathway_tpu/engine/telemetry.py``; its OTLP bodies
name the instrumentation scope ``pathway_tpu_torch``.

Parity target: ``src/engine/telemetry.rs`` — gauges ``process.memory.
usage``, ``process.cpu.utime``, ``process.cpu.stime``, ``latency.input``,
``latency.output`` sampled on a periodic reader (60 s default,
``telemetry.rs:39``), resource attributes ``service.*``/``run.id``/
``root.trace.id``/``license.key`` shortcut, and tracing spans carrying a
``traceparent`` from the Python layer (``graph_runner/telemetry.py``).

Differences by design: the reference exports OTLP/gRPC to
``usage.pathway.com`` by default when the license requires telemetry;
this build has **zero egress**, so nothing is ever sent unless the user
explicitly configures an endpoint (``pw.set_monitoring_config`` /
``TelemetryConfig.create(monitoring_server=...)``).

Wire format: **OTLP/HTTP+JSON** by default (the JSON mapping of the
opentelemetry-proto ``ExportMetricsServiceRequest`` /
``ExportTraceServiceRequest``, POSTed to ``/v1/metrics`` and
``/v1/traces``) — any stock OpenTelemetry collector ingests it, closing
the parity gap with ``telemetry.rs``'s OTLP exporter without needing the
absent opentelemetry wheels.  ``protocol="pathway-json"``
(``PATHWAY_TELEMETRY_PROTOCOL``) keeps the legacy line-JSON format.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import threading
import time
import urllib.request
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable

from pathway_tpu_torch.engine import metrics as _metrics

PERIODIC_READER_INTERVAL_S = 60.0
EXPORT_TIMEOUT_S = 3.0
# bounded non-blocking export queue: a slow or dead collector must never
# stall the sampler or (worse) a span-emitting caller thread — when the
# queue is full the OLDEST payload is dropped and counted in the
# ``telemetry.export.dropped`` metric (freshness beats completeness)
EXPORT_QUEUE_MAX = 256
# in-process span retention: exported spans also land on ``Telemetry.spans``
# for introspection/tests, but sampled per-epoch spans arrive forever in a
# streaming run — keep only the most recent ones
SPAN_BUFFER_MAX = 1024

PROCESS_MEMORY_USAGE = "process.memory.usage"
PROCESS_CPU_USER_TIME = "process.cpu.utime"
PROCESS_CPU_SYSTEM_TIME = "process.cpu.stime"
INPUT_LATENCY = "latency.input"
OUTPUT_LATENCY = "latency.output"
# checkpoint-commit pipeline gauges (engine/persistence.CommitMetrics):
# cumulative stage seconds under "checkpoint.commit.<stage>" for the
# stages below, plus the in-flight gauges — how much durability work is
# overlapping the epoch loop right now
CHECKPOINT_COMMIT_PREFIX = "checkpoint.commit."
CHECKPOINT_COMMIT_STAGES = ("buffer", "frame", "hash", "upload", "barrier")
CHECKPOINT_INFLIGHT_BYTES = "checkpoint.inflight.bytes"
CHECKPOINT_INFLIGHT_JOBS = "checkpoint.inflight.jobs"
# device-path observability gauges (pathway_tpu_torch/device/telemetry.py):
# exported through the unified registry like every family above, so they
# ride every OTLP metrics sample automatically — named here so the
# ``/status`` device section (engine/http_server.py), the dashboard
# footer (internals/monitoring.py) and `pathway_tpu_torch top` agree on one
# spelling with the exporter
DEVICE_SECTION_PREFIX = "device."
DEVICE_UTILIZATION = "device.utilization"
DEVICE_PADDING_WASTE_FRACTION = "device.padding.waste.fraction"
DEVICE_HBM_BYTES_IN_USE = "device.hbm.bytes_in_use"
DEVICE_HBM_PEAK = "device.hbm.peak"

LOCAL_DEV_NAMESPACE = "local-dev"

logger = logging.getLogger("pathway_tpu_torch.telemetry")


class TelemetryError(RuntimeError):
    pass


@dataclass(frozen=True)
class TelemetryConfig:
    """Where (if anywhere) to deliver metrics/spans for this run."""

    telemetry_enabled: bool = False
    metrics_servers: tuple[str, ...] = ()
    tracing_servers: tuple[str, ...] = ()
    service_name: str = "pathway"
    service_version: str = "0.0.0"
    service_instance_id: str = ""
    service_namespace: str = LOCAL_DEV_NAMESPACE
    run_id: str = ""
    trace_parent: str | None = None
    license_shortcut: str = ""
    protocol: str = "otlp-json"  # or "pathway-json" (legacy line JSON)

    @classmethod
    def create(
        cls,
        *,
        license: Any = None,
        run_id: str | None = None,
        monitoring_server: str | None = None,
        trace_parent: str | None = None,
        protocol: str | None = None,
    ) -> "TelemetryConfig":
        """Mirror of ``TelemetryConfig::create`` (telemetry.rs): a
        monitoring endpoint requires the MONITORING entitlement; with no
        endpoint configured telemetry stays fully off (zero egress)."""
        from pathway_tpu_torch import __version__

        if monitoring_server is not None and license is not None:
            license.check_entitlements(["monitoring"])
        servers = (monitoring_server,) if monitoring_server else ()
        from pathway_tpu_torch.internals.config import env_str

        requested = (
            protocol
            if protocol is not None
            else env_str("PATHWAY_TELEMETRY_PROTOCOL")
        )
        instance_id = env_str("PATHWAY_SERVICE_INSTANCE_ID") or secrets.token_hex(8)
        namespace = env_str("PATHWAY_SERVICE_NAMESPACE") or LOCAL_DEV_NAMESPACE
        return cls(
            telemetry_enabled=bool(servers),
            metrics_servers=tuple(servers),
            tracing_servers=tuple(servers),
            service_name="pathway",
            service_version=__version__,
            service_instance_id=instance_id,
            service_namespace=namespace,
            run_id=run_id or secrets.token_hex(8),
            trace_parent=trace_parent,
            license_shortcut=license.shortcut() if license is not None else "",
            # validate only when something will actually be exported: a
            # typo'd env var must not crash zero-egress runs that never
            # touch the wire format
            protocol=(
                _validate_protocol(requested)
                if servers
                else (requested if requested in _PROTOCOLS else "otlp-json")
            ),
        )

    def resource(self) -> dict[str, str]:
        return {
            "service.name": self.service_name,
            "service.version": self.service_version,
            "service.instance.id": self.service_instance_id,
            "service.namespace": self.service_namespace,
            "run.id": self.run_id,
            "root.trace.id": _root_trace_id(self.trace_parent) or "",
            "license.key": self.license_shortcut,
        }


_PROTOCOLS = ("otlp-json", "pathway-json")


def _validate_protocol(value: str) -> str:
    """Reject unknown wire formats loudly: a typo falling back silently
    would make every export 400 at the collector with only debug logs."""
    if value not in _PROTOCOLS:
        raise TelemetryError(
            f"unknown telemetry protocol {value!r}; expected one of {_PROTOCOLS}"
        )
    return value


def _root_trace_id(trace_parent: str | None) -> str | None:
    """trace-id field of a W3C ``traceparent`` header value."""
    if not trace_parent:
        return None
    parts = trace_parent.split("-")
    return parts[1] if len(parts) >= 3 and len(parts[1]) == 32 else None


def mint_traceparent() -> str:
    """A fresh W3C ``traceparent`` header value (sampled flag set).

    One per run: ``cli spawn`` mints it into the cluster environment and
    worker 0 broadcasts it over the mesh to any worker that missed it
    (``internals/runner.py``), so epoch/commit/recovery spans from every
    worker of the run share one trace id in the collector."""
    return f"00-{secrets.token_hex(16)}-{secrets.token_hex(8)}-01"


def _process_metrics() -> dict[str, float]:
    utime, stime = os.times()[:2]
    metrics = {PROCESS_CPU_USER_TIME: utime, PROCESS_CPU_SYSTEM_TIME: stime}
    try:
        with open("/proc/self/statm") as f:
            metrics[PROCESS_MEMORY_USAGE] = (
                int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
            )
    except (OSError, ValueError, IndexError):
        import resource

        metrics[PROCESS_MEMORY_USAGE] = (
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        )
    return metrics


# ---------------------------------------------------------------------------
# OTLP/HTTP+JSON encoding — the official JSON mapping of opentelemetry-proto
# (ExportMetricsServiceRequest / ExportTraceServiceRequest), hand-encoded so
# any stock OTel collector ingests our payloads with zero extra wheels.
# ---------------------------------------------------------------------------


def _otlp_value(v) -> dict:
    # bool first: it is an int subclass
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # proto JSON maps int64 to string
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_attrs(d: dict) -> list[dict]:
    return [{"key": k, "value": _otlp_value(v)} for k, v in d.items()]


def _otlp_metrics(payload: dict) -> dict:
    t_ns = str(int(payload.get("ts", time.time()) * 1e9))
    entries = [
        _metrics.otlp_gauge(name, value, t_ns)
        for name, value in payload["metrics"].items()
    ]
    # registry histograms (epoch latency, step time) map to REAL OTLP
    # histogram datapoints, not flattened gauges — a collector can compute
    # quantiles from the bucket counts
    for point in payload.get("histograms") or ():
        entries.append(_metrics.otlp_histogram(point, t_ns))
    return {
        "resourceMetrics": [
            {
                "resource": {"attributes": _otlp_attrs(payload["resource"])},
                "scopeMetrics": [
                    {
                        "scope": {"name": "pathway_tpu_torch"},
                        "metrics": entries,
                    }
                ],
            }
        ]
    }


def _parent_span_id(trace_parent: str | None) -> str:
    """span-id field of a W3C ``traceparent`` header value."""
    parts = (trace_parent or "").split("-")
    return parts[2] if len(parts) >= 4 and len(parts[2]) == 16 else ""


def _otlp_traces(payload: dict) -> dict:
    span = payload["span"]
    # ids are minted at span CREATION and carried on the record
    # (emit_span); minting here at export time would break parent/child
    # links and exemplar trace-id correlation.  The fallbacks below only
    # serve legacy records constructed outside Telemetry.span().
    trace_id = (
        span.get("trace_id")
        or _root_trace_id(span.get("trace_parent"))
        or payload.get("fallback_trace_id")
        or secrets.token_hex(16)
    )
    parent_span_id = span.get("parent_span_id")
    if parent_span_id is None:
        parent_span_id = _parent_span_id(span.get("trace_parent"))
    start_ns = int(span["start"] * 1e9)
    end_ns = start_ns + int(span["duration_s"] * 1e9)
    return {
        "resourceSpans": [
            {
                "resource": {"attributes": _otlp_attrs(payload["resource"])},
                "scopeSpans": [
                    {
                        "scope": {"name": "pathway_tpu_torch"},
                        "spans": [
                            {
                                "traceId": trace_id,
                                "spanId": span.get("span_id")
                                or secrets.token_hex(8),
                                "parentSpanId": parent_span_id,
                                "name": span["name"],
                                "kind": 1,  # SPAN_KIND_INTERNAL
                                "startTimeUnixNano": str(start_ns),
                                "endTimeUnixNano": str(end_ns),
                                "attributes": _otlp_attrs(
                                    span.get("attributes", {})
                                ),
                            }
                        ],
                    }
                ],
            }
        ]
    }


class Telemetry:
    """Samples metrics on a timer and POSTs them; collects spans.

    One instance per run (``maybe_run_telemetry_thread`` analog).
    ``stats_supplier`` returns the latest ProberStats (or None) — the
    prober feeds it, exactly like the reference's ``ArcSwapOption``.
    """

    def __init__(
        self,
        config: TelemetryConfig,
        stats_supplier: Callable[[], Any] | None = None,
        *,
        interval_s: float = PERIODIC_READER_INTERVAL_S,
        extra_metrics: Callable[[], dict[str, float] | None] | None = None,
        registry: "_metrics.MetricsRegistry | None" = None,
    ):
        self.config = config
        self.stats_supplier = stats_supplier
        # extra gauge supplier (name → value), merged into every sample;
        # the runner wires the persistence CommitMetrics snapshot here so
        # commit-stage timings and in-flight bytes ride the same exports
        self.extra_metrics = extra_metrics
        # the unified metrics registry (engine/metrics.py): its counters/
        # gauges merge into every sample and its histograms export as OTLP
        # histogram datapoints.  None keeps the pre-registry behavior
        # (direct Telemetry constructions in tests).
        self.registry = registry
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # bounded: a streaming run emits sampled epoch spans indefinitely
        self.spans: deque[dict] = deque(maxlen=SPAN_BUFFER_MAX)
        self._span_lock = threading.Lock()
        # one trace per run when no traceparent was propagated: all this
        # run's spans must correlate in the collector
        self._fallback_trace_id = secrets.token_hex(16)
        # bounded non-blocking export queue (metrics AND spans): the
        # sampler/span caller thread never blocks on a slow collector —
        # it enqueues; one daemon thread drains; overflow drops the
        # oldest payload and counts it
        self.dropped_exports = 0
        self._q: deque[tuple[str, dict, tuple[str, ...]]] = deque()
        self._q_cv = threading.Condition()
        self._q_thread: threading.Thread | None = None
        self._q_closing = False

    # -- metrics -----------------------------------------------------------
    def sample(self) -> dict[str, Any]:
        metrics = dict(_process_metrics())
        stats = self.stats_supplier() if self.stats_supplier is not None else None
        if stats is not None:
            if stats.input_stats.lag_ms is not None:
                metrics[INPUT_LATENCY] = stats.input_stats.lag_ms
            if stats.output_stats.lag_ms is not None:
                metrics[OUTPUT_LATENCY] = stats.output_stats.lag_ms
        if self.extra_metrics is not None:
            try:
                metrics.update(self.extra_metrics() or {})
            except Exception as exc:  # noqa: BLE001
                # a gauge supplier must never break the sampler
                logger.debug("extra metrics supplier failed: %s", exc)
        payload: dict[str, Any] = {
            "resource": self.config.resource(),
            "metrics": metrics,
            "ts": time.time(),
        }
        if self.registry is not None:
            try:
                metrics.update(self.registry.scalar_metrics())
                payload["histograms"] = self.registry.histogram_points()
            except Exception as exc:  # noqa: BLE001 - same rule as suppliers
                logger.debug("metrics registry read failed: %s", exc)
        return payload

    def _export(self, kind: str, payload: dict, servers: tuple[str, ...]) -> None:
        if self.config.protocol == "otlp-json":
            body = json.dumps(
                _otlp_metrics(payload) if kind == "metrics" else _otlp_traces(payload)
            ).encode()
        elif self.config.protocol == "pathway-json":
            # legacy line-JSON — exactly that format:
            # fallback_trace_id and the registry histogram points are
            # otlp-only payload hints, not part of it
            legacy = {
                k: v
                for k, v in payload.items()
                if k not in ("fallback_trace_id", "histograms")
            }
            body = json.dumps({"kind": kind, **legacy}).encode()
        else:
            # a directly-constructed config can bypass create()'s check;
            # never fall back silently to a format the endpoint will 400
            raise TelemetryError(
                f"unknown telemetry protocol {self.config.protocol!r}"
            )
        for endpoint in servers:
            url = endpoint.rstrip("/") + f"/v1/{kind}"
            try:
                req = urllib.request.Request(
                    url, data=body, headers={"Content-Type": "application/json"}
                )
                urllib.request.urlopen(req, timeout=EXPORT_TIMEOUT_S).read()
            except Exception as exc:
                logger.debug("telemetry export to %s failed: %s", url, exc)

    # -- bounded export queue ----------------------------------------------
    def _enqueue_export(
        self, kind: str, payload: dict, servers: tuple[str, ...]
    ) -> None:
        """Queue one export without ever blocking the caller.  Overflow
        drops the OLDEST queued payload (a fresh sample is worth more than
        a stale one) and counts the drop — never silently."""
        if not servers:
            return
        with self._q_cv:
            if self._q_closing:
                return
            if len(self._q) >= EXPORT_QUEUE_MAX:
                self._q.popleft()
                self._record_drop()
            self._q.append((kind, payload, servers))
            if self._q_thread is None or not self._q_thread.is_alive():
                self._q_thread = threading.Thread(
                    target=self._q_loop, name="pathway:telemetry-export",
                    daemon=True,
                )
                self._q_thread.start()
            self._q_cv.notify_all()

    def _record_drop(self) -> None:
        self.dropped_exports += 1
        # the drop is itself a metric: it rides /metrics and the next
        # successful export, so a lossy collector link is visible — on
        # THIS Telemetry's registry when one was wired (isolated-registry
        # constructions must not cross-contaminate the global one)
        (self.registry or _metrics.get_registry()).counter(
            "telemetry.export.dropped",
            "telemetry payloads dropped by the bounded export queue",
        ).inc()

    # pathway-lint: context=telemetry
    def _q_loop(self) -> None:
        while True:
            with self._q_cv:
                while not self._q and not self._q_closing:
                    # timed re-check: producers (_enqueue_export) and the
                    # closer (_drain_queue) notify under this cv, but a
                    # supervised background thread never waits unbounded —
                    # the loop condition decides, the timeout only paces
                    self._q_cv.wait(timeout=1.0)
                if not self._q:
                    return  # closing and drained
                kind, payload, servers = self._q.popleft()
            try:
                self._export(kind, payload, servers)
            finally:
                with self._q_cv:
                    self._q_cv.notify_all()

    def _drain_queue(self, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        with self._q_cv:
            self._q_closing = True
            self._q_cv.notify_all()
            while self._q and time.monotonic() < deadline:
                self._q_cv.wait(0.1)
            leftovers = len(self._q)
            self._q.clear()
        for _ in range(leftovers):
            self._record_drop()
        thread = self._q_thread
        if thread is not None:
            thread.join(timeout=max(0.1, deadline - time.monotonic()))
            self._q_thread = None

    # -- spans -------------------------------------------------------------
    @contextmanager
    def span(self, name: str, **attributes: Any):
        # ids are minted HERE, at creation, and carried on the record:
        # an export-time mint could never parent-link two spans of one
        # request or correlate a histogram exemplar back to its trace
        start = time.time()
        span_id = secrets.token_hex(8)
        try:
            yield
        finally:
            self.emit_span(
                {
                    "name": name,
                    "start": start,
                    "duration_s": time.time() - start,
                    "attributes": attributes,
                    "trace_parent": self.config.trace_parent,
                    "trace_id": _root_trace_id(self.config.trace_parent)
                    or self._fallback_trace_id,
                    "span_id": span_id,
                    "parent_span_id": _parent_span_id(
                        self.config.trace_parent
                    ),
                }
            )

    def emit_span(self, record: dict) -> None:
        """Record one finished span (buffer + bounded export queue).

        The record carries its own ``trace_id``/``span_id``/
        ``parent_span_id`` (minted at creation); request-scoped tracing
        (``engine/tracing.py``) feeds pre-built child-span records
        through here so they ride the same bounded queue as run spans."""
        with self._span_lock:
            self.spans.append(record)
        if self.config.telemetry_enabled:
            # spans ride the bounded queue too: a dead collector must
            # not add 3 s per endpoint to the span CALLER's thread
            self._enqueue_export(
                "traces",
                {
                    "resource": self.config.resource(),
                    "span": record,
                    "fallback_trace_id": self._fallback_trace_id,
                },
                self.config.tracing_servers,
            )

    def epoch_span(self, time_: int, index: int, *, every: int = 16):
        """A sampled per-epoch span context: every ``every``-th epoch gets
        a real ``pathway.epoch`` span (correlated into the run's trace via
        the propagated traceparent), the rest cost one modulo.  Only emits
        when telemetry has an endpoint — zero-egress runs must not grow
        the span list by one record per epoch."""
        if not self.config.telemetry_enabled or index % max(1, every):
            return nullcontext()
        return self.span("pathway.epoch", epoch=time_, index=index)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Telemetry":
        if not self.config.telemetry_enabled:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="pathway:telemetry", daemon=True
        )
        self._thread.start()
        return self

    # pathway-lint: context=telemetry
    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._enqueue_export(
                "metrics", self.sample(), self.config.metrics_servers
            )

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # final flush so short runs still report once
            self._enqueue_export(
                "metrics", self.sample(), self.config.metrics_servers
            )
            self._thread.join(timeout=5)
            self._thread = None
        self._drain_queue()


def maybe_run_telemetry_thread(
    config: TelemetryConfig,
    stats_supplier: Callable[[], Any] | None = None,
    *,
    interval_s: float = PERIODIC_READER_INTERVAL_S,
) -> Telemetry | None:
    """Start the telemetry loop when enabled (telemetry.rs glue)."""
    if not config.telemetry_enabled:
        return None
    return Telemetry(config, stats_supplier, interval_s=interval_s).start()
