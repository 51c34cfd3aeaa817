"""Data-plane observability: freshness tracking and backpressure attribution.

The complement of the performance profiler (``engine/profiler.py``): the
profiler says where CPU burns, this module says **where records wait and
how stale each output is right now** — the question a *live* data
framework exists to answer.

Two surfaces, one tracker:

* **Ingest-time low-watermark propagation** (:class:`FreshnessTracker`).
  Connectors already stamp every staged batch with its ingest wall-clock
  (``InputNode._staged_wallclock``); ``emit_time`` exposes the epoch's
  earliest stamp per input as ``epoch_ingest_wallclock``.  After every
  processed epoch the tracker makes one topologically-ordered pass over
  the node arena and propagates the **min-ingest-time frontier**: each
  operator's watermark is the minimum over its inputs' watermarks, so an
  output's watermark is the ingest time of the *oldest* row contributing
  to the update it just delivered (a low watermark, in the classic
  streaming sense — but over ingest wall-clock, not event time; the
  event-time ``_watermark`` fields of the temporal nodes in
  ``engine/dataflow.py`` are a different, per-operator axis).  From the
  frontier fall out:

  - ``freshness.e2e.ms{output=...}`` — ingest→delivery latency histogram
    per output connector (p50/p95/p99 from the histogram quantiles),
  - ``output.staleness.s{output=...}`` — seconds since the ingest stamp
    of the newest data each output reflects, computed at *read* time so
    a stalled pipeline shows growing staleness even while the epoch loop
    idles.  Staleness rising while ``epoch.duration.ms`` stays flat is
    the signature of a starved/stalled *source*; both rising together is
    a slow *pipeline* — the distinction ``docs/observability.md``
    documents.

* **Backpressure attribution** (``backlog.*``).  Queue depth and age at
  every boundary where records wait, under one namespace so one view can
  rank the bottleneck stage: connector reader queues
  (``backlog.connector.queue``), rows staged at inputs awaiting an epoch
  (``backlog.ingest.rows`` / ``backlog.ingest.age.s``), distinct pending
  epoch timestamps (``backlog.epochs.pending``), comm per-peer inboxes
  (``backlog.comm.inbox``, emitted by ``engine/comm.py``), and
  async-commit in-flight state (``backlog.checkpoint.bytes`` / ``.jobs``,
  emitted by ``engine/persistence.py:CommitMetrics``).

Everything exports through the unified registry (``engine/metrics.py``)
— one collector, registered by the runner — so it rides ``/metrics``
scrapes, OTLP export, the ``GET /status`` JSON endpoint
(``engine/http_server.py``), the ``pathway_tpu_torch top`` live view
(``internals/top.py``), the console dashboard footer, and flight-recorder
dumps (final watermark/backlog snapshot, so post-mortems say what was
*stuck*, not just where time went).

Cost: one attribute pass over the node arena per epoch (no locks beyond
the histogram observe, no allocation per node); ``chip_smoke.py``'s
``[observability]`` reports the instrumented runs' overhead on the card.
``PATHWAY_FRESHNESS=0`` removes even that pass.
"""

from __future__ import annotations

import re
from time import monotonic as _monotonic
from typing import Any

from pathway_tpu_torch.engine import metrics as _metrics

__all__ = ["FreshnessTracker", "render_freshness", "safe_label"]


_LABEL_UNSAFE = re.compile(r"[{}=,\n]")


def safe_label(value: Any) -> str:
    """User-supplied names (sink/source registration names from the io
    API) become metric label VALUES in the ``name{k=v,...}`` collector
    key format — strip the characters that would corrupt its parsing.
    The runner dedups sink labels on THIS sanitized form, so distinct
    raw names can never collapse into one metric label silently."""
    return _LABEL_UNSAFE.sub("_", str(value))


class FreshnessTracker:
    """Per-run freshness/backlog tracker (the runner keeps it on
    ``RunResult.freshness``; the registry collector holds it weakly, so
    it dies with the result, exactly like the prober and profiler)."""

    def __init__(self, *, enabled: bool | None = None):
        from pathway_tpu_torch.internals.config import env_bool

        self.enabled = (
            env_bool("PATHWAY_FRESHNESS") if enabled is None else bool(enabled)
        )
        self._pollers: list[Any] = []
        # walk plan, precomputed once per graph shape: (node, kind,
        # input-id tuple) per node in topo order, kind 0=input 1=interior
        # 2=output — the per-epoch pass then does zero isinstance checks
        self._plan: list[tuple[Any, int, tuple[int, ...]]] | None = None
        # node id -> ingest low-watermark of the data that flowed through
        # it in the last processed epoch (monotonic wall-clock seconds);
        # flat list indexed by node id (ids are arena indexes)
        self._frontier: list[float | None] = []
        # output label -> (watermark of the newest delivered update,
        # wall-clock at delivery, output node); staleness derives from it
        # at read time
        self._delivered: dict[str, tuple[float, float, Any]] = {}
        # node id -> the InputNodes upstream of it (plan-build time): an
        # output whose every source has FINISHED is complete, not stale —
        # its gauge must stop aging, or a static side table's export
        # would dominate worst-staleness forever
        self._upstream: list[tuple[Any, ...]] = []
        # output label -> e2e histogram child (resolved once)
        self._e2e: dict[str, Any] = {}
        # mesh worst-staleness gauge child, resolved once: the publisher
        # sits on worker 0's epoch-negotiation path, which must not take
        # the registry family lock every round
        self._mesh_gauge: Any = None
        self.epochs_tracked = 0

    # -- wiring --------------------------------------------------------------
    def attach(self, scope: Any, pollers: list[Any]) -> None:
        """Bind the run's connector pollers (called by the runner after
        lowering, before the event loop).  The scope itself is not
        stored; ``after_epoch`` receives it per call and builds the walk
        plan lazily from it."""
        del scope  # accepted for call-site symmetry with the prober
        # per-poller backlog label, deduped on the sanitized form here
        # (same hazard the runner guards for sink labels): two unnamed
        # sources of one reader class must not overwrite each other's
        # queue/idle gauges — the later one would mask the stalled one
        self._pollers = []
        used: set[str] = set()
        for i, poller in enumerate(pollers or []):
            label = safe_label(getattr(poller, "name", "source"))
            if label in used:
                label = f"{label}#{i}"
            used.add(label)
            self._pollers.append((label, poller))

    def _output_label(self, node: Any) -> str:
        name = getattr(node, "sink_name", None)
        return safe_label(name) if name else f"output#{node.id}"

    def _build_plan(self, scope: Any) -> list[tuple[Any, int, tuple[int, ...]]]:
        """Type checks and input-id resolution paid once per graph shape;
        the per-epoch pass is then pure list indexing."""
        from pathway_tpu_torch.engine.dataflow import InputNode, OutputNode

        plan: list[tuple[Any, int, Any]] = []
        upstream: list[tuple[Any, ...]] = []
        for node in scope.nodes:
            if isinstance(node, InputNode):
                kind = 0
            elif isinstance(node, OutputNode):
                kind = 2
            else:
                kind = 1
            ids = tuple(inp.id for inp in node.inputs)
            # single-input nodes (the vast majority of a lowered graph)
            # store the bare id: the per-epoch pass then does one list
            # index instead of an inner loop
            src: Any = ids[0] if len(ids) == 1 else ids
            plan.append((node, kind, src))
            if kind == 0:
                ups: tuple[Any, ...] = (node,)
            else:
                seen: list[Any] = []
                for i in ids:
                    for inp in upstream[i]:
                        if inp not in seen:
                            seen.append(inp)
                ups = tuple(seen)
            upstream.append(ups)
        self._plan = plan
        self._upstream = upstream
        self._frontier = [None] * len(plan)
        return plan

    # -- epoch hook ----------------------------------------------------------
    def after_epoch(self, scope: Any, now: float | None = None) -> None:
        """One topo pass after a processed epoch: propagate the ingest
        low-watermark and record delivery latency at outputs.  Reads plain
        attributes only — safe on the epoch thread (never a lock beyond
        the histogram observe, never I/O)."""
        if not self.enabled:
            return
        plan = self._plan
        if plan is None or len(plan) != len(scope.nodes):
            plan = self._build_plan(scope)
        if now is None:
            now = _monotonic()
        frontier = self._frontier
        for node, kind, src in plan:
            if kind == 0:
                w = node.epoch_ingest_wallclock
            elif type(src) is int:
                w = frontier[src]
            else:
                w = None
                for i in src:
                    iw = frontier[i]
                    if iw is not None and (w is None or iw < w):
                        w = iw
            frontier[node.id] = w
            if kind == 2 and w is not None and node._saw_data_this_epoch:
                label = self._output_label(node)
                hist = self._e2e.get(label)
                if hist is None:
                    hist = _metrics.get_registry().histogram(
                        "freshness.e2e.ms",
                        "ingest-to-delivery latency of output updates (ms)",
                        buckets=_metrics.MS_BUCKETS,
                        output=label,
                    )
                    self._e2e[label] = hist
                hist.observe(max(0.0, (now - w) * 1000.0))
                self._delivered[label] = (w, now, node)
        self.epochs_tracked += 1

    # -- read-time derivations ----------------------------------------------
    def staleness(self, now: float | None = None) -> dict[str, float]:
        """``{output label: seconds}`` — age of the newest ingest stamp
        each output reflects, measured *now* (so a stalled stream keeps
        aging between epochs).  Outputs whose every upstream source has
        FINISHED are complete, not stale — they drop out rather than age
        forever (a *stalled* source is not finished, so it keeps aging)."""
        if now is None:
            now = _monotonic()
        upstream = self._upstream
        out: dict[str, float] = {}
        # list() snapshot: the engine thread inserts a new label when an
        # output delivers its first epoch, and this runs on scrape/export
        # threads — an unguarded .items() iteration could die mid-resize
        # and silently drop the whole collector output for that scrape
        for label, (watermark, _at, node) in list(self._delivered.items()):
            sources = upstream[node.id] if node.id < len(upstream) else ()
            if sources and all(s.finished for s in sources):
                continue
            out[label] = max(0.0, now - watermark)
        return out

    def worst_staleness(self, now: float | None = None) -> float | None:
        stale = self.staleness(now)
        return max(stale.values()) if stale else None

    def record_mesh_staleness(self, values: list[float | None]) -> None:
        """Worker 0 only: publish the mesh-wide worst output staleness
        gathered from every worker's epoch-negotiation payload (the
        cross-worker aggregation riding the mesh's epoch gather)."""
        present = [v for v in values if v is not None]
        if not present and self._mesh_gauge is None:
            # never published anything: don't mint a zero gauge
            return
        gauge = self._mesh_gauge
        if gauge is None:
            gauge = self._mesh_gauge = _metrics.get_registry().gauge(
                "freshness.mesh.staleness.s",
                "worst output staleness across the worker mesh",
            )
        # all workers report None (every source finished): clear to zero
        # rather than freezing at the last stall — the per-output gauges
        # drop out at that point, and this one must not keep alerting
        gauge.set(max(present) if present else 0.0)

    def _backlog(self, now: float) -> dict[str, float]:
        """``backlog.*`` gauges for every boundary this tracker can see.
        Runs at scrape/export cadence on a non-engine thread; every read
        is a plain attribute/dict access guarded against concurrent
        mutation by the engine thread (telemetry is best-effort)."""
        out: dict[str, float] = {}
        pending_times: set[int] = set()
        for name, poller in self._pollers:
            q = getattr(poller, "q", None)
            if q is not None:
                try:
                    out[f"backlog.connector.queue{{source={name}}}"] = float(
                        q.qsize()
                    )
                except Exception:  # noqa: BLE001 - best-effort telemetry
                    pass
            node = getattr(poller, "input_node", None)
            if node is None:
                continue
            try:
                staged = sum(len(d) for d in list(node._staged.values()))
                walls = list(node._staged_wallclock.values())
                pending_times.update(node._staged.keys())
            except RuntimeError:  # resized mid-iteration by the engine
                continue
            out[f"backlog.ingest.rows{{source={name}}}"] = float(staged)
            if walls:
                out[f"backlog.ingest.age.s{{source={name}}}"] = max(
                    0.0, now - min(walls)
                )
            # how long this source has been quiet: the one-branch-stall
            # signal.  The low-watermark deliberately excludes idle
            # inputs (Flink's idle-source rule — holding the last stamp
            # would alarm on every legitimately bursty source), so a
            # stalled branch of a multi-source join shows up HERE, not
            # in output.staleness.s while its siblings keep delivering.
            last_row = getattr(poller, "last_row_mono", None)
            if last_row is not None and not getattr(
                poller, "finished", False
            ):
                out[f"backlog.connector.idle.s{{source={name}}}"] = max(
                    0.0, now - last_row
                )
        out["backlog.epochs.pending"] = float(len(pending_times))
        return out

    # -- exports -------------------------------------------------------------
    def metrics_snapshot(self) -> dict[str, float]:
        """Registry collector: staleness + backlog gauges, evaluated at
        pull time (``engine/metrics.py`` holds this weakly)."""
        now = _monotonic()
        out: dict[str, float] = {}
        for label, seconds in self.staleness(now).items():
            out[f"output.staleness.s{{output={label}}}"] = seconds
        out.update(self._backlog(now))
        return out

    def snapshot(self) -> dict[str, Any]:
        """Dump-friendly snapshot for flight-recorder post-mortems: the
        final per-output watermarks/staleness and the backlog ranking —
        what was *stuck* when the worker died."""
        now = _monotonic()
        outputs = {
            label: {
                "staleness_s": round(seconds, 6),
                "delivered_ago_s": round(
                    max(0.0, now - self._delivered[label][1]), 6
                ),
            }
            for label, seconds in self.staleness(now).items()
        }
        for label, (_w, at, node) in list(self._delivered.items()):
            if label not in outputs:
                # completed output (every source finished): still part of
                # the post-mortem story, just not aging
                outputs[label] = {
                    "complete": True,
                    "delivered_ago_s": round(max(0.0, now - at), 6),
                }
        return {
            "epochs_tracked": self.epochs_tracked,
            "outputs": outputs,
            "backlog": {k: v for k, v in self._backlog(now).items() if v},
        }

    def crash_snapshot(self) -> dict[str, Any] | None:
        """Never-raising snapshot for the flight recorder (forensics)."""
        try:
            return self.snapshot()
        except Exception:  # noqa: BLE001 - a dying process must still dump
            return None


def render_freshness(snapshot: dict[str, Any]) -> str:
    """Human-readable render of a :meth:`FreshnessTracker.snapshot` (used
    by ``pathway_tpu_torch blackbox`` on dump payloads; tolerates partial or
    hand-edited artifacts, never raises)."""
    lines = [
        f"freshness: {snapshot.get('epochs_tracked', '?')} epochs tracked"
    ]
    outputs = snapshot.get("outputs") or {}
    for label in sorted(outputs):
        info = outputs[label] or {}
        if info.get("complete"):
            lines.append(
                f"  output {label}: complete (last delivery "
                f"{info.get('delivered_ago_s', '?')} s ago)"
            )
            continue
        lines.append(
            f"  output {label}: staleness "
            f"{info.get('staleness_s', '?')} s (last delivery "
            f"{info.get('delivered_ago_s', '?')} s ago)"
        )
    backlog = snapshot.get("backlog") or {}
    # non-numeric values (hand-edited / damaged-but-parseable artifacts)
    # render verbatim and sort last — this renderer must never raise
    _NUMERIC = object()
    entries = []
    for key, value in backlog.items():
        try:
            entries.append((key, float(value), _NUMERIC))
        except (TypeError, ValueError):
            entries.append((key, float("-inf"), value))
    entries.sort(key=lambda e: -e[1])
    for key, num, raw in entries:
        lines.append(
            f"  {key} = {num:g}" if raw is _NUMERIC else f"  {key} = {raw!r}"
        )
    if not outputs and not backlog:
        lines.append("  (no outputs delivered, no backlog)")
    return "\n".join(lines)
