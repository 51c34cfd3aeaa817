"""``pathway_tpu_torch top`` — a live data-plane view over ``GET /status``.

The htop of a running pipeline: polls the monitoring HTTP server
(``engine/http_server.py``, enabled with ``pw.run(with_http_server=True)``
or ``PATHWAY_MONITORING_HTTP_PORT``) and renders, per refresh:

* header — run id, epochs processed, **epoch rate** (derived from the
  delta between polls), epoch-duration p50/p95/p99;
* freshness — per-output staleness and end-to-end ingest→delivery
  latency quantiles (``engine/freshness.py``);
* backlog — every ``backlog.*`` wait point, ranked worst-first, so the
  bottleneck stage reads off the top line;
* device — the DeviceExecutor panel (``pathway_tpu_torch/device/``): dispatch
  rate, queue depth/age, compile-cache cold/warm discipline, padding
  waste, roofline utilization and HBM use, plus the fault-tolerance
  state (tripped circuit breakers, OOM bucket caps, host-fallback /
  quarantine / dispatch-restart counts);
* serving — the REST admission panel (``engine/serving.py``): in-flight
  occupancy, queue depth, per-code request counts, latency quantiles,
  shed/deadline counters, and the degraded/draining flags;
* requests — request-trace volume and ring extremes
  (``engine/tracing.py``; full waterfalls via ``pathway_tpu_torch requests``);
* slo — every declared objective (``engine/slo.py``) with its remaining
  error budget and multi-window burn rates;
* operators — the per-operator progress table of the ``/status`` body.

Pure functions (`render_top`) are separated from I/O (`fetch_status`) so
tests pin the render without a server and the CLI stays a thin loop.
"""

from __future__ import annotations

import json
from typing import Any

from pathway_tpu_torch.engine.metrics import split_labeled_name


class StatusUnavailable(RuntimeError):
    """The monitoring endpoint could not be reached or parsed — rendered
    by the CLI as a clear non-zero exit, never a traceback."""


def fetch_status(url: str, timeout: float = 2.0) -> dict[str, Any]:
    """One ``GET /status`` poll; raises :class:`StatusUnavailable` with an
    actionable message on any failure (server down, wrong port, bad
    body)."""
    import http.client
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            body = r.read().decode()
    except (
        urllib.error.URLError,
        # a non-HTTP listener on the polled port (the comm mesh port is
        # an easy mix-up) raises BadStatusLine — an HTTPException, not a
        # URLError — and must get the same clean exit
        http.client.HTTPException,
        OSError,
        TimeoutError,
    ) as exc:
        raise StatusUnavailable(
            f"cannot reach {url} ({exc}) — is the pipeline running with "
            "with_http_server=True (or PATHWAY_MONITORING_HTTP_PORT set)?"
        ) from exc
    try:
        payload = json.loads(body)
    except ValueError as exc:
        raise StatusUnavailable(
            f"{url} returned a non-JSON body ({exc}) — not a pathway_tpu_torch "
            "monitoring endpoint?"
        ) from exc
    if not isinstance(payload, dict):
        raise StatusUnavailable(f"{url} returned non-object JSON")
    return payload


def _labeled(section: dict[str, float], base: str) -> dict[str, float]:
    """``{label-value: value}`` for every ``base{...}`` key of a scalar
    section, keyed by the first label's value (output=, source=, peer=)."""
    out: dict[str, float] = {}
    for key, value in (section or {}).items():
        name, labels = split_labeled_name(key)
        if name != base:
            continue
        label = next(iter(labels.values()), "") if labels else ""
        out[label] = value
    return out


def render_waterfall(trace: dict[str, Any], width: int = 32) -> str:
    """One finished request trace as a span waterfall: each span's
    offset/duration plus a proportional bar against the request's whole
    duration — a slow request decomposes visually into queue wait vs
    coalesce vs device dispatch vs generation ticks."""
    trace_id = trace.get("trace_id") or "?"
    duration_s = trace.get("duration_s") or 0.0
    status = trace.get("status")
    header = (
        f"trace {trace_id} [{trace.get('route') or '-'}]"
        f"{'' if status is None else f' {status}'}"
        f" · {duration_s * 1000:.1f} ms · {len(trace.get('spans') or [])} "
        "span(s)"
    )
    dropped = trace.get("spans_dropped") or 0
    if dropped:
        header += f" (+{dropped} dropped)"
    lines = [header]
    start0 = trace.get("start") or 0.0
    total = max(duration_s, 1e-9)
    spans = sorted(
        trace.get("spans") or [], key=lambda s: (s.get("start") or 0.0)
    )
    for span in spans:
        offset = max(0.0, (span.get("start") or 0.0) - start0)
        dur = span.get("duration_s") or 0.0
        pre = min(width - 1, int(offset / total * width))
        bar_len = max(1, min(width - pre, int(round(dur / total * width))))
        bar = "·" * pre + "█" * bar_len
        attrs = span.get("attributes") or {}
        attr_str = " ".join(f"{k}={v}" for k, v in attrs.items())
        lines.append(
            f"  {span.get('name', '?'):<24} {offset * 1000:>8.1f}ms "
            f"+{dur * 1000:>8.1f}ms  |{bar:<{width}}|"
            + (f"  {attr_str}" if attr_str else "")
        )
    return "\n".join(lines)


def render_requests(
    traces: list[dict[str, Any]], limit: int = 10, width: int = 32
) -> str:
    """The ``pathway_tpu_torch requests`` body: up to ``limit`` waterfalls."""
    if not traces:
        return (
            "no finished request traces buffered — is the serving path "
            "live (and PATHWAY_TRACE_REQUESTS not 0)?"
        )
    return "\n\n".join(
        render_waterfall(t, width=width) for t in traces[:limit]
    )


def render_top(
    status: dict[str, Any],
    prev: dict[str, Any] | None = None,
    interval_s: float | None = None,
) -> str:
    """One frame of the live view from a ``/status`` payload (tolerates
    partial payloads from older servers — sections simply drop out)."""
    lines: list[str] = []
    epochs = status.get("epochs") or 0
    header = f"pathway_tpu_torch top · run {status.get('run_id') or '-'} · epochs {epochs}"
    if prev is not None and interval_s:
        rate = max(0, epochs - (prev.get("epochs") or 0)) / interval_s
        header += f" · {rate:.1f} epochs/s"
    epoch_q = status.get("epoch") or {}
    quantiles = [
        f"{suffix[-3:]} {epoch_q[key]:.2f} ms"
        for suffix in ("p50", "p95", "p99")
        for key in (f"epoch.duration.ms.{suffix}",)
        if key in epoch_q
    ]
    if quantiles:
        header += " · epoch " + " / ".join(quantiles)
    lines.append(header)

    freshness = status.get("freshness") or {}
    staleness = _labeled(freshness, "output.staleness.s")
    if staleness:
        lines.append("")
        lines.append("freshness (per output)")
        e2e = {
            q: _labeled(freshness, f"freshness.e2e.ms.{q}")
            for q in ("p50", "p95", "p99")
        }
        for label in sorted(staleness, key=lambda k: -staleness[k]):
            row = f"  {label:<24} staleness {staleness[label]:>8.2f} s"
            qs = [
                f"{q} {e2e[q][label]:.1f} ms"
                for q in ("p50", "p95", "p99")
                if label in e2e[q]
            ]
            if qs:
                row += "   e2e " + " / ".join(qs)
            lines.append(row)
        mesh = freshness.get("freshness.mesh.staleness.s")
        if mesh is not None:
            lines.append(f"  mesh worst staleness: {mesh:.2f} s")

    backlog = status.get("backlog") or {}
    ranked = sorted(backlog.items(), key=lambda kv: -kv[1])
    nonzero = [(k, v) for k, v in ranked if v]
    if backlog:
        lines.append("")
        lines.append("backlog (worst first)")
        if not nonzero:
            lines.append("  (all queues empty)")
        for key, value in nonzero:
            base, labels = split_labeled_name(key)
            label_str = (
                " [" + ",".join(f"{k}={v}" for k, v in labels.items()) + "]"
                if labels
                else ""
            )
            lines.append(f"  {base + label_str:<44} {value:>12g}")

    device = status.get("device") or {}
    if device:
        lines.append("")
        lines.append("device")
        batches = device.get("device.dispatch.batches") or 0.0
        row = f"  dispatch {int(batches)} batch(es)"
        if prev is not None and interval_s:
            prev_batches = (prev.get("device") or {}).get(
                "device.dispatch.batches"
            ) or 0.0
            row += f" ({max(0.0, batches - prev_batches) / interval_s:.1f}/s)"
        rows = device.get("device.dispatch.rows")
        if rows is not None:
            row += f" · {int(rows)} row(s)"
        p95 = device.get("device.dispatch.ms.p95")
        if p95 is not None:
            row += f" · dispatch p95 {p95:.2f} ms"
        lines.append(row)
        backlog_all = status.get("backlog") or {}
        queue = backlog_all.get("backlog.device.queue")
        if queue is not None:
            lines.append(
                f"  queue {int(queue)} job(s) · "
                f"{backlog_all.get('backlog.device.bytes', 0.0):.0f} B in "
                "flight · oldest "
                f"{backlog_all.get('backlog.device.age.s', 0.0):.2f} s"
            )
        cold = device.get("device.cache.cold")
        warmed = device.get("device.warmup.compiles")
        if cold is not None or warmed is not None:
            # after a full warmup, nonzero cold is a discipline bug — the
            # panel puts it next to the kernel-build accounting
            cache = f"  cache: cold {int(cold or 0)} / warmed {int(warmed or 0)}"
            lines.append(cache)
        builds = device.get("device.kernel.builds")
        loads = device.get("device.kernel.loads")
        if builds is not None or loads is not None:
            # the port's compile events: nvcc builds of the hand-written
            # kernels (ops/_build.py), their seconds, and library loads
            lines.append(
                f"  kernels: {int(builds or 0)} build(s) in "
                f"{device.get('device.kernel.build.seconds') or 0.0:.2f} s · "
                f"{int(loads or 0)} load(s)"
            )
        waste = device.get("device.padding.waste.fraction")
        if waste is not None:
            lines.append(
                f"  padding waste {waste:.1%} "
                f"({int(device.get('device.padding.waste.rows') or 0)} pad "
                "row(s)) — replay with `pathway_tpu_torch buckets`"
            )
        util = device.get("device.utilization")
        if util is not None:
            from pathway_tpu_torch.device.telemetry import format_utilization

            lines.append(
                f"  utilization {format_utilization(util)} of "
                f"{device.get('device.peak.flops_per_s') or 0.0:.3g} FLOP/s "
                f"peak · achieved "
                f"{device.get('device.achieved.flops_per_s') or 0.0:.3g} "
                "FLOP/s"
            )
        hbm = device.get("device.hbm.bytes_in_use")
        if hbm is not None:
            lines.append(
                f"  hbm {hbm / (1 << 20):.1f} MiB in use · peak "
                f"{(device.get('device.hbm.peak') or 0.0) / (1 << 20):.1f} MiB"
            )
        # fault-tolerance panel (device/resilience.py): per-callable
        # breaker state plus the degraded-mode counters — a tripped
        # breaker or a quarantined batch must be visible at a glance
        breakers = _labeled(device, "device.breaker.state")
        tripped = {
            name: value for name, value in breakers.items() if value
        }
        if tripped:
            states = ", ".join(
                f"{name} {'OPEN' if value >= 1.0 else 'half-open'}"
                for name, value in sorted(tripped.items())
            )
            lines.append(f"  breaker: {states}")
        caps = _labeled(device, "device.bucket.cap")
        if caps:
            lines.append(
                "  oom ratchet: "
                + ", ".join(
                    f"{name} capped at bucket {int(cap)}"
                    for name, cap in sorted(caps.items())
                )
                + f" ({int(device.get('device.oom.splits') or 0)} split(s))"
            )
        fallback = device.get("device.fallback.batches")
        quarantined = device.get("device.quarantine.batches")
        restarts = device.get("device.dispatch.restarts")
        if fallback or quarantined or restarts:
            lines.append(
                f"  degraded: {int(fallback or 0)} host-fallback batch(es) "
                f"· {int(quarantined or 0)} quarantined "
                f"· {int(restarts or 0)} dispatch restart(s)"
            )

    columnar = status.get("columnar") or {}
    bail_total = sum(
        v for k, v in columnar.items() if k.startswith("columnar.bail.count")
    )
    if bail_total:
        # silent columnar→row fall-backs: the pipeline is paying row-wise
        # cost on operators its benchmarks ran columnar (docs/columnar.md)
        top_bails = sorted(
            (
                (k, v)
                for k, v in columnar.items()
                if k.startswith("columnar.bail.count") and v
            ),
            key=lambda kv: -kv[1],
        )[:3]
        detail = ", ".join(
            "{}={:g}".format(
                ",".join(
                    f"{lk}:{lv}"
                    for lk, lv in split_labeled_name(k)[1].items()
                )
                or "total",
                v,
            )
            for k, v in top_bails
        )
        lines.append("")
        lines.append(f"columnar: {int(bail_total)} bail(s) — {detail}")

    autoscaler = status.get("autoscaler") or {}
    if autoscaler.get("autoscaler.target.workers"):
        # the supervisor's scale-controller panel (lease/autoscaler.json
        # via the worker's registry collector): target topology, budget,
        # cooldown, and whether a live handoff is in flight right now
        phase = {
            0.0: "steady",
            1.0: "hot (dwell running)",
            2.0: "cooling down",
            3.0: "HANDOFF IN FLIGHT",
        }.get(autoscaler.get("autoscaler.phase") or 0.0, "steady")
        lines.append("")
        lines.append(
            f"autoscaler: target {int(autoscaler['autoscaler.target.workers'])} "
            f"worker(s) · {phase} · budget left "
            f"{int(autoscaler.get('autoscaler.budget.left') or 0)}"
        )
        cooldown = autoscaler.get("autoscaler.cooldown.remaining.s") or 0.0
        decisions = autoscaler.get("autoscaler.decisions.logged") or 0.0
        detail = f"  {int(decisions)} decision(s) logged"
        last = _labeled(autoscaler, "autoscaler.last.decision")
        for action, target in sorted(last.items()):
            detail += f" · last: {action} → {int(target)}"
        if cooldown > 0:
            detail += f" · cooldown {cooldown:.1f} s remaining"
        lines.append(detail)

    standby = status.get("standby") or {}
    if standby.get("standby.pool") or standby.get("supervisor.promotions"):
        # the warm-standby panel (engine/standby.py collector): pool
        # size, per-standby apply lag, and how many worker deaths were
        # absorbed by promotion instead of a group restart
        lines.append("")
        promotions = standby.get("supervisor.promotions") or 0.0
        row = (
            f"standby: pool {int(standby.get('standby.pool') or 0)} · "
            f"{int(promotions)} promotion(s)"
        )
        last_worker = standby.get("supervisor.promotions.last.worker")
        if promotions and last_worker is not None:
            row += f" (last adopted worker {int(last_worker)})"
        lines.append(row)
        lags = _labeled(standby, "standby.lag.s")
        chunks = _labeled(standby, "standby.verified.chunks")
        for sid in sorted(lags):
            detail = f"  standby {sid}: apply lag {lags[sid]:.2f} s"
            if sid in chunks:
                detail += f" · {int(chunks[sid])} chunk(s) verified"
            lines.append(detail)

    serving = status.get("serving") or {}
    if serving:
        # the admission-controller panel (engine/serving.py): occupancy
        # and the shed story — a 429 storm or an engaged shedder must be
        # visible at a glance, next to the pressure that caused it
        lines.append("")
        inflight = serving.get("serve.inflight") or 0.0
        inflight_b = serving.get("serve.inflight.bytes") or 0.0
        depth = serving.get("serve.queue.depth") or 0.0
        row = (
            f"serving: {int(inflight)} in flight "
            f"({inflight_b / (1 << 20):.2f} MiB) · queue {int(depth)}"
        )
        if serving.get("serve.draining"):
            row += " · DRAINING"
        elif serving.get("serve.degraded"):
            row += " · DEGRADED (shedding)"
        lines.append(row)
        by_code: dict[str, float] = {}
        sheds: dict[str, float] = {}
        lapsed: dict[str, float] = {}
        lats: dict[str, dict[str, float]] = {}
        for key, value in serving.items():
            name, labels = split_labeled_name(key)
            if name == "serve.requests":
                code = labels.get("code", "?")
                by_code[code] = by_code.get(code, 0.0) + value
            elif name == "serve.shed" and value:
                sheds[labels.get("reason", "?")] = value
            elif name == "serve.deadline.exceeded" and value:
                lapsed[labels.get("where", "?")] = value
            else:
                for q in ("p50", "p95", "p99"):
                    if name == f"serve.latency.ms.{q}":
                        route = labels.get("route", "")
                        lats.setdefault(route, {})[q] = value
        if by_code:
            lines.append(
                "  requests: "
                + " · ".join(
                    f"{code}×{int(v)}" for code, v in sorted(by_code.items())
                )
            )
        for route in sorted(lats):
            qs = " / ".join(
                f"{q} {lats[route][q]:.1f} ms"
                for q in ("p50", "p95", "p99")
                if q in lats[route]
            )
            lines.append(f"  latency [{route or '-'}]: {qs}")
        quarantined = serving.get("serve.quarantined")
        if sheds or lapsed or quarantined:
            parts = []
            if sheds:
                parts.append(
                    "shed "
                    + ", ".join(
                        f"{r}×{int(v)}" for r, v in sorted(sheds.items())
                    )
                )
            if lapsed:
                parts.append(
                    "deadline "
                    + ", ".join(
                        f"{w}×{int(v)}" for w, v in sorted(lapsed.items())
                    )
                )
            if quarantined:
                parts.append(f"quarantined {int(quarantined)}")
            lines.append("  " + " · ".join(parts))

    generation = status.get("generation") or {}
    if generation.get("generate.slots.total"):
        # the continuous-batching panel (serving/generation.py): slot and
        # page-pool occupancy tell at a glance whether the generation
        # loop is compute-bound (slots full, pages free) or memory-bound
        # (pages full, queue growing)
        lines.append("")
        active = generation.get("generate.slots.active") or 0.0
        total = generation.get("generate.slots.total") or 0.0
        depth = generation.get("generate.queue.depth") or 0.0
        pages_used = generation.get("generate.pages.used") or 0.0
        pages_total = generation.get("generate.pages.total") or 0.0
        rate = generation.get("generate.tokens_per_s") or 0.0
        lines.append(
            f"generation: {int(active)}/{int(total)} slot(s) · queue "
            f"{int(depth)} · pages {int(pages_used)}/{int(pages_total)} "
            f"· {rate:.1f} tok/s"
        )
        live = generation.get("generate.kv.bytes.live") or 0.0
        peak = generation.get("generate.kv.bytes.peak") or 0.0
        dense = generation.get("generate.kv.bytes.dense") or 0.0
        if dense:
            lines.append(
                f"  kv: {live / (1 << 20):.2f} MiB live · peak "
                f"{peak / (1 << 20):.2f} MiB · dense layout would hold "
                f"{dense / (1 << 20):.2f} MiB"
            )
        ttft: dict[str, float] = {}
        for key, value in generation.items():
            name, _labels = split_labeled_name(key)
            for q in ("p50", "p95", "p99"):
                if name == f"generate.ttft.ms.{q}":
                    ttft[q] = value
        if ttft:
            qs = " / ".join(
                f"{q} {ttft[q]:.1f} ms"
                for q in ("p50", "p95", "p99")
                if q in ttft
            )
            lines.append(f"  ttft: {qs}")
        churn = generation.get("generate.churn.synthetic")
        if churn:
            lines.append(f"  churn: {int(churn)} synthetic burst request(s)")

    requests = status.get("requests") or {}
    req_scalars = requests.get("scalars") or {}
    if req_scalars.get("trace.requests"):
        # the request-tracing line (engine/tracing.py): trace volume plus
        # the buffered ring's extremes — `pathway_tpu_torch requests` renders
        # the full waterfalls
        lines.append("")
        row = (
            f"requests: {int(req_scalars['trace.requests'])} traced · "
            f"{int(req_scalars.get('trace.spans') or 0)} span(s) · "
            f"{int(req_scalars.get('trace.requests.buffered') or 0)} buffered"
        )
        slowest = req_scalars.get("trace.requests.slowest.ms")
        if slowest is not None:
            row += f" · slowest {slowest:.1f} ms"
        lines.append(row)

    slo = status.get("slo") or {}
    slos = slo.get("slos") or []
    if slos:
        # the SLO panel (engine/slo.py): every declared objective with
        # its budget + burn — a violating SLO must read off one line
        lines.append("")
        lines.append("slo (budget remaining · burn by window)")
        for entry in slos:
            burns = entry.get("burn") or {}
            burn_str = " / ".join(
                f"{window} ×{burns[window]:.2f}" for window in sorted(burns)
            )
            row = (
                f"  {entry.get('name', '?'):<16} "
                f"[{entry.get('objective', '')}]  budget "
                f"{entry.get('budget_remaining', 1.0):>6.1%}"
            )
            if burn_str:
                row += f" · burn {burn_str}"
            if entry.get("violating"):
                row += " · VIOLATING"
            lines.append(row)

    operators = status.get("operators") or {}
    if operators:
        lines.append("")
        lines.append(
            f"  {'operator':<20} {'rows in':>10} {'rows out':>10} "
            f"{'step ms':>9} {'lag ms':>8}"
        )
        rows = sorted(
            operators.items(),
            key=lambda kv: -(kv[1].get("step_ms") or 0.0),
        )
        for op_id, op in rows:
            name = f"{op.get('name', 'op')}#{op_id}"
            lag = op.get("lag_ms")
            lines.append(
                f"  {name:<20} {op.get('rows_in', 0):>10} "
                f"{op.get('rows_out', 0):>10} "
                f"{op.get('step_ms') or 0.0:>9.1f} "
                f"{'-' if lag is None else format(lag, '.0f'):>8}"
                + ("  [done]" if op.get("done") else "")
            )
    return "\n".join(lines)
