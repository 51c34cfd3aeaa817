"""Monitoring HTTP server: ``/status`` (JSON) and ``/metrics`` (OpenMetrics).

The port's copy of ``pathway_tpu/engine/http_server.py`` (parity target
``src/engine/http_server.rs:21-215``): a per-process
endpoint on ``127.0.0.1:(20000 + process_id)`` (override with
``PATHWAY_MONITORING_HTTP_PORT``), serving the latest ``ProberStats``
snapshot in Prometheus text format.  The reference shares the snapshot via
``ArcSwapOption``; here a lock-free attribute swap on the server object
plays that role (the GIL makes the single reference assignment atomic).

Runs in a daemon thread off the worker hot loop, exactly like the
reference keeps hyper off the timely worker threads.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pathway_tpu_torch.engine import metrics as _metrics
from pathway_tpu_torch.engine.probes import ProberStats

DEFAULT_FIRST_PORT = 20000  # http_server.rs:83


def monitoring_port(process_id: int = 0, override: int | None = None) -> int:
    return override if override is not None else DEFAULT_FIRST_PORT + process_id


# one escaping rule for the whole /metrics body: the ProberStats section
# here and the registry section it appends must never diverge
_esc = _metrics.escape_label


def render_prometheus(
    stats: ProberStats,
    run_id: str | None = None,
    registry: "_metrics.MetricsRegistry | None" = None,
) -> str:
    """OpenMetrics text, gauge names matching the reference's exposition.

    HELP/TYPE headers are emitted once per metric name (strict parsers
    reject duplicates), followed by that metric's samples.  With a
    ``registry`` (the unified metrics registry, ``engine/metrics.py``) its
    exposition — comm/persistence/supervisor counters, epoch histograms —
    is appended before the terminator, so one scrape covers the whole
    worker.
    """
    run_label = f'run_id="{_esc(run_id)}"' if run_id else ""

    def labels(*pairs: str) -> str:
        parts = [p for p in (*pairs, run_label) if p]
        return "{" + ",".join(parts) + "}" if parts else ""

    # metric -> (help text, [(label string, value), ...])
    metrics: dict[str, tuple[str, list[tuple[str, object]]]] = {}

    def gauge(name: str, value, help_: str, label_str: str | None = None) -> None:
        if value is None:
            return
        metrics.setdefault(name, (help_, []))[1].append(
            (labels() if label_str is None else label_str, value)
        )

    gauge("input_latency_ms", stats.input_stats.lag_ms, "input processing lag")
    gauge("output_latency_ms", stats.output_stats.lag_ms, "output processing lag")
    gauge("input_time", stats.input_stats.time, "latest committed input epoch")
    gauge("output_time", stats.output_stats.time, "latest produced output epoch")
    gauge("epochs_total", stats.epochs, "consistent epochs processed")
    gauge(
        "input_rows_total", stats.input_stats.rows_out, "rows ingested across sources"
    )
    gauge(
        "output_rows_total", stats.output_stats.rows_in, "rows delivered across sinks"
    )
    for op_id, op in stats.operator_stats.items():
        op_labels = labels(f'operator="{_esc(op.name)}"', f'id="{op_id}"')
        gauge("operator_rows_in_total", op.rows_in, "rows consumed", op_labels)
        gauge("operator_rows_out_total", op.rows_out, "rows produced", op_labels)
    for op_id, n in stats.row_counts.items():
        gauge(
            "operator_state_rows", n, "rows of maintained state", labels(f'id="{op_id}"')
        )

    lines: list[str] = []
    for name, (help_, samples) in metrics.items():
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} gauge")
        for label_str, value in samples:
            lines.append(f"{name}{label_str} {value}")
    if registry is not None:
        registry_text = registry.render_prometheus(
            extra_labels={"run_id": run_id} if run_id else None
        )
        if registry_text:
            lines.append(registry_text.rstrip("\n"))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def render_status(
    stats: ProberStats,
    run_id: str | None = None,
    registry: "_metrics.MetricsRegistry | None" = None,
) -> str:
    """The ``GET /status`` JSON body: dataflow progress plus — with a
    registry — the data-plane view ``pathway_tpu_torch top`` renders: per-output
    freshness (staleness + e2e latency quantiles), the ``backlog.*``
    backpressure ranking, and epoch-duration quantiles.  Keys are only
    ever added here; existing consumers keep parsing."""

    def op(s):
        return {
            "name": s.name,
            "time": s.time,
            "lag_ms": s.lag_ms,
            "rows_in": s.rows_in,
            "rows_out": s.rows_out,
            "step_ms": s.step_ms,
            "done": s.done,
        }

    payload = {
        "run_id": run_id,
        "epochs": stats.epochs,
        "input": op(stats.input_stats),
        "output": op(stats.output_stats),
        "operators": {str(k): op(v) for k, v in stats.operator_stats.items()},
        "connectors": [
            {"name": c.name, "rows": c.rows, "finished": c.finished}
            for c in stats.connector_stats
        ],
    }
    if registry is not None:
        from pathway_tpu_torch.engine.telemetry import DEVICE_SECTION_PREFIX

        scalars = registry.scalar_metrics()
        payload["freshness"] = {
            k: v
            for k, v in scalars.items()
            if k.startswith(("freshness.", "output.staleness"))
        }
        payload["backlog"] = {
            k: v for k, v in scalars.items() if k.startswith("backlog.")
        }
        payload["epoch"] = {
            k: v
            for k, v in scalars.items()
            if k.startswith("epoch.duration.ms.")
        }
        # the device panel of `pathway_tpu_torch top`: cost/utilization/padding/
        # HBM gauges, dispatch counters and their quantile estimates, and
        # the kernel-build and transfer counters (device.kernel.*,
        # device.transfer.*) where the JAX package shows its jit accounting
        payload["device"] = {
            k: v for k, v in scalars.items() if k.startswith(DEVICE_SECTION_PREFIX)
        }
        # columnar execution health: bail counters by op/reason — a
        # pipeline silently running row-wise shows up here and in the
        # `pathway_tpu_torch top` columnar line
        payload["columnar"] = {
            k: v for k, v in scalars.items() if k.startswith("columnar.")
        }
        # the autoscaler panel: target topology, budget, cooldown and
        # handoff phase (gauges derived from lease/autoscaler.json by the
        # collector each supervised worker registers; absent = autoscaling
        # off or solo run)
        payload["autoscaler"] = {
            k: v for k, v in scalars.items() if k.startswith("autoscaler.")
        }
        # the warm-standby panel: pool size, per-standby apply lag, and
        # promotion history (gauges derived from lease/standby.<sid>
        # beacons + lease/promotions.json by the collector each
        # supervised worker registers; absent = no standby pool)
        payload["standby"] = {
            k: v
            for k, v in scalars.items()
            if k.startswith(("standby.", "supervisor.promotions"))
        }
        # the serving panel: admission occupancy, latency quantiles, shed/
        # deadline counters and degraded/draining flags (absent = no REST
        # ingress in this pipeline)
        payload["serving"] = {
            k: v for k, v in scalars.items() if k.startswith("serve.")
        }
        # the generation panel: continuous-batching slot/queue occupancy,
        # page-pool utilization, TTFT and throughput (absent = no
        # decoder generation ran in this process)
        payload["generation"] = {
            k: v for k, v in scalars.items() if k.startswith("generate.")
        }
        # the requests panel (`pathway_tpu_torch requests`): trace.* scalars,
        # the slowest finished traces WITH span trees (waterfall source),
        # and the per-bucket histogram exemplars linking a slow bucket to
        # a real trace id
        from pathway_tpu_torch.engine import tracing as _tracing

        payload["requests"] = {
            "scalars": {
                k: v for k, v in scalars.items() if k.startswith("trace.")
            },
            "slowest": _tracing.slowest_requests(10),
            "recent": _tracing.recent_requests(10),
            "exemplars": registry.exemplar_points(),
        }
        # the SLO panel: declared objectives with burn rates + budgets
        # (the `slo.*` scalars ride the collector; the structured view
        # feeds `pathway_tpu_torch top` and flight-recorder dumps)
        from pathway_tpu_torch.engine import slo as _slo

        payload["slo"] = _slo.get_evaluator().snapshot()
    # default=repr: a span attribute carrying a non-JSON value (a numpy
    # scalar from the device path) must degrade to its repr, never take
    # the whole status endpoint down with a TypeError
    return json.dumps(payload, default=repr)


def _handle_trace(path: str) -> tuple[str, int]:
    """``GET /trace?seconds=N`` → ``(JSON body, HTTP status)``.

    200 with ``{"trace_dir": ..., "seconds": ...}`` on success; 400 on a
    malformed duration; 409 while another capture runs; 503 when capture
    is unavailable here (no ``PATHWAY_DEVICE_TRACE_DIR``); 500 with the
    reason on any other failure of ``torch.profiler``.  Errors carry ``{"error": message}`` so the
    ``pathway_tpu_torch trace`` CLI can relay the reason verbatim."""
    from urllib.parse import parse_qs, urlparse

    from pathway_tpu_torch.device import telemetry as _device_telemetry

    query = parse_qs(urlparse(path).query)
    raw = (query.get("seconds") or ["1.0"])[0]
    try:
        seconds = float(raw)
    except ValueError:
        return json.dumps({"error": f"bad seconds value {raw!r}"}), 400
    try:
        trace_dir = _device_telemetry.capture_trace(seconds)
    except _device_telemetry.TraceBusy as exc:
        return json.dumps({"error": str(exc)}), 409
    except _device_telemetry.TraceUnavailable as exc:
        return json.dumps({"error": str(exc)}), 503
    except Exception as exc:  # noqa: BLE001 - the JSON error contract
        # holds for EVERY failure (unwritable trace dir, a profiler
        # session started outside our lock, ...): the CLI must relay the
        # real reason, never a dead-connection guess
        return json.dumps({"error": repr(exc)}), 500
    return json.dumps({"trace_dir": trace_dir, "seconds": seconds}), 200


class MonitoringServer:
    """Daemon-thread HTTP server exposing the latest stats snapshot."""

    def __init__(
        self,
        *,
        process_id: int = 0,
        port: int | None = None,
        run_id: str | None = None,
        host: str = "127.0.0.1",
        registry: "_metrics.MetricsRegistry | None" = None,
    ):
        self.run_id = run_id
        self._stats = ProberStats()  # swapped whole, never mutated in place
        # the unified registry rides every /metrics scrape by default;
        # pass registry explicitly to serve an isolated one (tests)
        self.registry = registry if registry is not None else _metrics.get_registry()
        self.port = monitoring_port(process_id, port)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.startswith("/metrics"):
                    body = render_prometheus(
                        server._stats, server.run_id, registry=server.registry
                    )
                    ctype = "text/plain; version=0.0.4"
                elif self.path.startswith("/status"):
                    body = render_status(
                        server._stats, server.run_id, registry=server.registry
                    )
                    ctype = "application/json"
                elif self.path.startswith("/trace"):
                    # on-demand torch.profiler capture IN THIS PROCESS (the
                    # live worker owns the device), blocking this handler
                    # thread for the requested duration — the threading
                    # server keeps /status and /metrics responsive
                    body, status = _handle_trace(self.path)
                    ctype = "application/json"
                    self._reply(status, ctype, body)
                    return
                else:
                    self.send_error(404)
                    return
                self._reply(200, ctype, body)

            def _reply(self, status: int, ctype: str, body: str) -> None:
                data = body.encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):  # silence request logging
                pass

        self._httpd = ThreadingHTTPServer((host, self.port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pathway:http", daemon=True
        )

    def start(self) -> "MonitoringServer":
        self._thread.start()
        return self

    def update(self, stats: ProberStats) -> None:
        self._stats = stats

    def close(self) -> None:
        from pathway_tpu_torch.device import telemetry as _device_telemetry

        # a /trace capture ends with the run: its handler thread must not
        # hold a profiler session open while the process exits
        _device_telemetry.stop_trace()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
