"""Dataflow probes: per-operator progress/throughput statistics.

Parity target: the reference's prober layer —
``src/engine/graph.rs:512`` (``ProberStats``/``OperatorStats``),
``src/engine/progress_reporter.rs`` (console stats loop) and the
``attach_prober``/``probe_table`` Graph methods (``graph.rs:969-976``).

TPU-first shape: the engine here is an epoch-stepped host runtime (device
compute happens inside jitted ops), so a probe is a cheap post-epoch scan
over the node arena rather than a timely probe handle.  Each ``Node``
already counts rows in/out; the :class:`Prober` turns those counters into
an immutable :class:`ProberStats` snapshot consumed by the console
dashboard (``internals/monitoring.py``) and the HTTP metrics server
(``engine/http_server.py``) — mirroring how the reference shares stats via
``ArcSwapOption<ProberStats>`` (``src/engine/http_server.rs:21``).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:  # pragma: no cover
    from pathway_tpu_torch.engine.dataflow import Node, Scope


@dataclass
class OperatorStats:
    """Progress of one operator (graph.rs ``OperatorStats``)."""

    name: str = "node"
    time: int | None = None  # latest epoch this operator processed
    lag_ms: float | None = None  # now - wallclock of that epoch, if known
    rows_in: int = 0
    rows_out: int = 0
    step_ms: float = 0.0  # cumulative time spent in step()
    errors: int = 0  # rows this operator poisoned/logged (error-log count)
    done: bool = False

    def merge(self, other: "OperatorStats") -> "OperatorStats":
        return OperatorStats(
            name=self.name,
            time=max_opt(self.time, other.time),
            lag_ms=max_opt(self.lag_ms, other.lag_ms),
            rows_in=self.rows_in + other.rows_in,
            rows_out=self.rows_out + other.rows_out,
            step_ms=self.step_ms + other.step_ms,
            errors=self.errors + other.errors,
            done=self.done and other.done,
        )


def max_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


@dataclass
class ConnectorStats:
    """Per-source ingestion stats (connectors/monitoring.rs analog)."""

    name: str = "source"
    rows: int = 0
    finished: bool = False


@dataclass
class ProberStats:
    """One consistent snapshot of the whole dataflow (graph.rs:512)."""

    input_stats: OperatorStats = field(default_factory=OperatorStats)
    output_stats: OperatorStats = field(default_factory=OperatorStats)
    operator_stats: dict[int, OperatorStats] = field(default_factory=dict)
    connector_stats: list[ConnectorStats] = field(default_factory=list)
    epochs: int = 0
    row_counts: dict[int, int] = field(default_factory=dict)


class Prober:
    """Collects :class:`ProberStats` from a :class:`Scope` after each epoch.

    ``callbacks`` mirrors ``attach_prober(callback, ...)`` — every update
    delivers the fresh snapshot; the dashboard and the HTTP server both
    register one.
    """

    def __init__(
        self,
        scope: "Scope",
        callbacks: list[Callable[[ProberStats], None]] | None = None,
        pollers: list | None = None,
    ):
        self.scope = scope
        self.pollers = list(pollers or [])
        self.callbacks: list[Callable[[ProberStats], None]] = list(callbacks or [])
        self.stats = ProberStats()
        # incremental error attribution: only entries appended since the
        # last update are scanned (the log is unbounded on long
        # terminate_on_error=False streams)
        self._err_counts: dict[int, int] = {}
        self._err_scan_pos = 0

    def update(self, *, done: bool = False, epochs: int | None = None) -> ProberStats:
        from pathway_tpu_torch.engine.dataflow import InputNode, OutputNode

        if self.scope is None:  # final snapshot already taken
            return self.stats
        now = _time.monotonic()
        t = self.scope.current_time
        # wallclock of the epoch's earliest staged row, recorded by
        # InputNode.emit_time — lag is real ingest→processed delay
        seen = self.scope.epoch_wallclock.get(t)

        ops: dict[int, OperatorStats] = {}
        inputs = OperatorStats(name="input", done=done)
        outputs = OperatorStats(name="output", done=done)
        row_counts: dict[int, int] = {}
        err_counts = self._err_counts
        log = self.scope.error_log
        for err_node, _key, _msg in log[self._err_scan_pos :]:
            nid = getattr(err_node, "id", None)
            if nid is not None:
                err_counts[nid] = err_counts.get(nid, 0) + 1
        self._err_scan_pos = len(log)
        for node in self.scope.nodes:
            st = OperatorStats(
                name=getattr(node, "name", None) or "node",
                time=t,
                rows_in=node.rows_in,
                rows_out=node.rows_out,
                step_ms=node.step_seconds * 1000.0,
                errors=err_counts.get(node.id, 0),
                done=done or (isinstance(node, InputNode) and node.finished),
            )
            if seen is not None:
                st.lag_ms = (now - seen) * 1000.0
            ops[node.id] = st
            if node.keep_state:
                row_counts[node.id] = len(node.state)
            if isinstance(node, InputNode):
                inputs = inputs.merge(st)
                inputs.done = done or all(
                    n.finished for n in self.scope.nodes if isinstance(n, InputNode)
                )
            if isinstance(node, OutputNode):
                outputs = outputs.merge(st)
                outputs.done = done
        connectors = [
            ConnectorStats(
                name=getattr(p, "name", "source"),
                rows=getattr(getattr(p, "input_node", None), "rows_in", 0),
                finished=bool(getattr(p, "finished", False)),
            )
            for p in self.pollers
        ]
        self.stats = ProberStats(
            input_stats=inputs,
            output_stats=outputs,
            operator_stats=ops,
            connector_stats=connectors,
            # epoch count is owned by the runner's loop when provided; the
            # final done-snapshot re-reads counters, it is not a new epoch
            epochs=(
                epochs
                if epochs is not None
                else self.stats.epochs + (0 if done else 1)
            ),
            row_counts=row_counts,
        )
        for cb in self.callbacks:
            cb(self.stats)
        if done:
            # drop the graph so a retained RunResult.prober doesn't keep
            # every node's state arena alive
            self.scope = None
        return self.stats

    def metrics_snapshot(self) -> dict[str, float]:
        """Flat gauge dict of the latest snapshot for the unified metrics
        registry (``engine/metrics.py``): dataflow progress totals that
        ride the same /metrics scrape and OTLP export as comm/persistence
        health.  (Per-operator rows stay in the richer ProberStats render
        of ``engine/http_server.py``.)"""
        s = self.stats
        out = {
            "dataflow.epochs": float(s.epochs),
            "dataflow.input.rows": float(s.input_stats.rows_out),
            "dataflow.output.rows": float(s.output_stats.rows_in),
            "dataflow.operators": float(len(s.operator_stats)),
            "dataflow.errors": float(
                sum(op.errors for op in s.operator_stats.values())
            ),
        }
        if s.input_stats.lag_ms is not None:
            out["dataflow.input.lag.ms"] = s.input_stats.lag_ms
        if s.output_stats.lag_ms is not None:
            out["dataflow.output.lag.ms"] = s.output_stats.lag_ms
        return out
