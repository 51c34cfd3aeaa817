"""Live console monitoring dashboard.

Parity target: ``python/pathway/internals/monitoring.py:165-273`` —
``MonitoringLevel``, ``StatsMonitor`` and ``monitor_stats``: a
rich-powered live view with connector/operator rows (latency, row
counts) plus a tail of recent log lines, refreshed from each
``ProberStats`` snapshot the engine prober publishes.

The port's copy of ``pathway_tpu/internals/monitoring.py``; its footer
shows the kernel-build counters where the JAX package shows jit compiles.
"""

from __future__ import annotations

import enum
import logging
import sys
from contextlib import contextmanager
from typing import Any

from pathway_tpu_torch.engine.probes import OperatorStats, ProberStats


class MonitoringLevel(enum.Enum):
    """What the console dashboard shows (reference ``monitoring.py:228``)."""

    AUTO = 0  # IN_OUT when stderr is a tty, NONE otherwise
    AUTO_ALL = 1  # ALL when stderr is a tty, NONE otherwise
    NONE = 2
    IN_OUT = 3  # inputs + outputs only
    ALL = 4  # every operator

    def resolve(self, interactive: bool | None = None) -> "MonitoringLevel":
        if interactive is None:
            interactive = sys.stderr.isatty()
        if self == MonitoringLevel.AUTO:
            return MonitoringLevel.IN_OUT if interactive else MonitoringLevel.NONE
        if self == MonitoringLevel.AUTO_ALL:
            return MonitoringLevel.ALL if interactive else MonitoringLevel.NONE
        return self


class _LogBuffer(logging.Handler):
    """Keeps the last N log lines for the dashboard footer."""

    def __init__(self, limit: int = 10):
        super().__init__()
        self.limit = limit
        self.lines: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.lines.append(self.format(record))
        except Exception:  # pragma: no cover - formatting failure
            return
        del self.lines[: -self.limit]


class StatsMonitor:
    """Renders ProberStats snapshots as a live table (reference ``StatsMonitor``)."""

    def __init__(
        self,
        level: MonitoringLevel = MonitoringLevel.IN_OUT,
        *,
        console: Any = None,
        refresh_per_second: int = 4,
    ):
        from rich.console import Console

        self.level = level
        self.console = console or Console(file=sys.stderr)
        self.refresh_per_second = refresh_per_second
        self.stats: ProberStats = ProberStats()
        self.log_buffer = _LogBuffer()
        self.log_buffer.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
        self._live = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StatsMonitor":
        from rich.live import Live

        logging.getLogger("pathway_tpu_torch").addHandler(self.log_buffer)
        self._live = Live(
            self._render(),
            console=self.console,
            refresh_per_second=self.refresh_per_second,
            transient=False,
        )
        self._live.start()
        return self

    def update(self, stats: ProberStats) -> None:
        self.stats = stats
        if self._live is not None:
            self._live.update(self._render())

    def close(self) -> None:
        if self._live is not None:
            self._live.update(self._render(final=True))
            self._live.stop()
            self._live = None
        logging.getLogger("pathway_tpu_torch").removeHandler(self.log_buffer)

    # -- rendering ---------------------------------------------------------
    def _rows(self) -> list[tuple[str, OperatorStats]]:
        s = self.stats
        rows: list[tuple[str, OperatorStats]] = [
            ("input", s.input_stats),
            ("output", s.output_stats),
        ]
        # per-connector ingestion rows (connectors/monitoring.rs analog)
        for c in s.connector_stats:
            rows.append(
                (
                    f"src:{c.name}",
                    OperatorStats(name=c.name, rows_in=c.rows, rows_out=c.rows, done=c.finished),
                )
            )
        if self.level == MonitoringLevel.ALL:
            rows += [(f"{op.name}#{oid}", op) for oid, op in s.operator_stats.items()]
        return rows

    def _runtime_summary(self) -> str | None:
        """One-line comm/persistence health from the unified metrics
        registry (``engine/metrics.py``) — the dashboard's view of the
        same numbers ``/metrics`` and the OTLP exporter serve."""
        from pathway_tpu_torch.engine import metrics as _metrics

        scalars = _metrics.get_registry().scalar_metrics()

        def total(prefix: str) -> float:
            return sum(
                v for k, v in scalars.items()
                if k == prefix or k.startswith(prefix + "{")
            )

        def peak(prefix: str) -> float | None:
            # quantile gauges must not SUM across label children (a p95 is
            # not additive) — report the worst child instead
            vals = [
                v for k, v in scalars.items()
                if k == prefix or k.startswith(prefix + "{")
            ]
            return max(vals) if vals else None

        parts: list[str] = []
        stale = peak("output.staleness.s")
        if stale is not None:
            # worst-output freshness: how old is the newest data any
            # output reflects right now (engine/freshness.py) — rising
            # here with a flat epoch p95 means a starved source, not a
            # slow pipeline
            parts.append(f"staleness: {stale:.2f} s (worst output)")
        epoch_p95 = peak("epoch.duration.ms.p95")
        if epoch_p95 is not None:
            parts.append(f"epoch p95: {epoch_p95:.1f} ms")
        builds = total("device.kernel.builds")
        loads = total("device.kernel.loads")
        if builds or loads:
            # the port's compile events: nvcc builds of the hand-written
            # kernels (ops/_build.py) and their library loads
            parts.append(
                f"kernels: {int(builds)} build(s) / {int(loads)} load(s)"
            )
        from pathway_tpu_torch.engine.telemetry import (
            DEVICE_PADDING_WASTE_FRACTION,
            DEVICE_UTILIZATION,
        )

        batches = total("device.dispatch.batches")
        if batches:
            # the device story in one clause: how busy, how wasteful —
            # the full panel lives in `pathway_tpu_torch top`
            device = f"device: {int(batches)} batch(es)"
            util = peak(DEVICE_UTILIZATION)
            if util:
                from pathway_tpu_torch.device.telemetry import format_utilization

                device += f", {format_utilization(util)} of peak"
            waste = peak(DEVICE_PADDING_WASTE_FRACTION)
            if waste:
                device += f", {waste:.1%} padding"
            parts.append(device)
        frames = total("comm.frames.sent")
        if frames:
            mb = total("comm.bytes.sent") / (1 << 20)
            comm = f"comm: {int(frames)} frames / {mb:.1f} MiB sent"
            reconnects = total("comm.reconnects")
            if reconnects:
                comm += f", {int(reconnects)} reconnect(s)"
            parts.append(comm)
        commits = total("checkpoint.commits")
        if commits:
            ckpt = (
                f"checkpoint: {int(commits)} commit(s) / "
                f"{total('checkpoint.bytes') / (1 << 20):.1f} MiB"
            )
            inflight = total("checkpoint.inflight.bytes")
            if inflight:
                ckpt += f", {inflight / (1 << 20):.1f} MiB in flight"
            parts.append(ckpt)
        dropped = total("telemetry.export.dropped")
        if dropped:
            parts.append(f"telemetry: {int(dropped)} export(s) dropped")
        return " · ".join(parts) if parts else None

    def _render(self, final: bool = False):
        from rich.console import Group
        from rich.table import Table as RichTable
        from rich.text import Text

        table = RichTable(title=None, expand=False)
        table.add_column("operator")
        table.add_column("epoch", justify="right")
        table.add_column("lag (ms)", justify="right")
        table.add_column("rows in", justify="right")
        table.add_column("rows out", justify="right")
        table.add_column("step (ms)", justify="right")
        table.add_column("errors", justify="right")
        for name, op in self._rows():
            table.add_row(
                name + (" [done]" if op.done else ""),
                "-" if op.time is None else str(op.time),
                "-" if op.lag_ms is None else f"{op.lag_ms:.0f}",
                str(op.rows_in),
                str(op.rows_out),
                f"{op.step_ms:.1f}",
                str(op.errors) if op.errors else "-",
            )
        header = Text(
            f"epochs: {self.stats.epochs}"
            + ("  (finished)" if final else "")
        )
        parts: list[Any] = [header, table]
        summary = self._runtime_summary()
        if summary:
            parts.append(Text(summary))
        if self.log_buffer.lines:
            parts.append(Text("\n".join(self.log_buffer.lines[-5:])))
        return Group(*parts)


@contextmanager
def monitor_stats(
    level: MonitoringLevel,
    *,
    console: Any = None,
    interactive: bool | None = None,
):
    """Context manager yielding a stats callback (or None if monitoring is off).

    Mirrors ``monitor_stats`` (reference ``monitoring.py:226``): resolves
    AUTO levels against tty-ness, runs the live dashboard for the duration.
    """
    resolved = level.resolve(interactive)
    if resolved == MonitoringLevel.NONE:
        yield None
        return
    monitor = StatsMonitor(resolved, console=console).start()
    try:
        yield monitor
    finally:
        monitor.close()
