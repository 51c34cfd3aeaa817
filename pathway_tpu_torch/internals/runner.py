"""Graph runner: lowers registered sinks and drives the engine event loop.

Parity target: ``python/pathway/internals/graph_runner/__init__.py``
(the tree-shake → lower → ``run_with_new_graph`` path, §3.1 of SURVEY.md) and
the worker event loop of ``src/engine/dataflow.rs:6051-6104`` (probers →
flushers → pollers → step).  Single-process form: the epoch loop polls
connector queues, picks the next commit timestamp across all input sessions,
and runs one consolidated pass of the operator DAG per epoch.

The single-worker part of ``pathway_tpu/internals/runner.py``: ``run``,
``run_all``, the solo ``_event_loop`` and ``run_pipeline_to_completion``,
with the same epoch choice and the same finish.  What the port takes in
later slices raises ``NotImplementedError`` naming that slice instead of
being ignored: persistence, several processes and warm standbys (H4), and
the monitoring HTTP server and console dashboard (H5).  Telemetry, the
prober, the license check and the flight recorder's dump suppliers arrive
with H5 as well; the epoch histogram and the flight-recorder ring are the
port's own (``engine/metrics.py``, ``engine/flight_recorder.py``).
"""

from __future__ import annotations

import os
import time as _time
from typing import Any, Callable

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.internals.monitoring import MonitoringLevel
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Lowerer, Table


def add_debug_sink(name: str, table: Table) -> None:
    def on_data(key, row, time, diff):
        sign = "+" if diff > 0 else "-"
        print(f"[{name}] {sign} key={key & 0xFFFFFFFF:x} time={time} row={row}")

    table._subscribe_raw(on_data, name=f"debug:{name}")


class RunResult:
    def __init__(self):
        self.epochs = 0
        self.last_time: int | None = None  # last processed epoch
        self.clean_finish = False


def _refuse_later_slices(
    *, persistence_config: Any, with_http_server: bool, monitoring_level: Any
) -> None:
    """Raise for every ``pw.run`` feature whose slice the port lacks."""
    from pathway_tpu_torch.internals.config import worker_topology

    if persistence_config is not None:
        raise NotImplementedError(
            "persistence_config needs engine/persistence.py, which the port "
            "brings in slice H4"
        )
    if worker_topology().processes > 1:
        raise NotImplementedError(
            "more than one process (PATHWAY_PROCESSES > 1) needs the TCP mesh "
            "of engine/comm.py, which the port brings in slice H4"
        )
    if os.environ.get("PATHWAY_STANDBY_ID") is not None:
        raise NotImplementedError(
            "standby mode and promotion (PATHWAY_STANDBY_ID) need "
            "engine/standby.py, which the port brings in slice H4"
        )
    if with_http_server:
        raise NotImplementedError(
            "with_http_server=True needs engine/http_server.py, which the "
            "port brings in slice H5"
        )
    if monitoring_level not in (None, MonitoringLevel.NONE, MonitoringLevel.AUTO):
        raise NotImplementedError(
            f"monitoring_level={monitoring_level!r} needs the console "
            "dashboard, which the port brings in slice H5; pass NONE or AUTO"
        )


def run(
    *,
    debug: bool = False,
    monitoring_level: Any = None,
    with_http_server: bool = False,
    default_logging: bool = True,
    persistence_config: Any = None,
    runtime_typechecking: bool | None = None,
    terminate_on_error: bool = True,
    max_epochs: int | None = None,
    _sinks: list | None = None,
    **kwargs: Any,
) -> RunResult:
    """``pw.run`` — execute every registered sink to completion.

    ``_sinks`` (internal) runs an explicit sink list instead of the
    graph's registry."""
    _refuse_later_slices(
        persistence_config=persistence_config,
        with_http_server=with_http_server,
        monitoring_level=monitoring_level,
    )
    from pathway_tpu_torch.engine import flight_recorder as _blackbox

    scope = df.Scope()
    scope.terminate_on_error = terminate_on_error
    lowerer = Lowerer(scope)
    # pw.run(debug=True): connectors with debug_data= lower to static
    # tables of that data (reference operator_handler.py:110)
    lowerer.debug_mode = debug

    # lower all sinks (tree-shaking is implicit: only sink cones are built)
    for _name, table, attach in (list(G.sinks) if _sinks is None else _sinks):
        node = lowerer.node(table)
        attach(lowerer, node)

    # append-only analysis must run before any state is stepped:
    # GroupByNode picks its accumulator variant off the inferred flags
    df.infer_append_only(scope)

    result = RunResult()
    _blackbox.record("run.start", worker=0, workers=1)
    try:
        _event_loop(scope, lowerer, result, max_epochs=max_epochs)
    except BaseException as exc:
        _blackbox.record("run.failed", worker=0, error=repr(exc))
        # failure hooks: exported tables must flip to failed so
        # concurrent importers raise instead of waiting forever
        # (the scopeguard of dataflow/export.rs:143-146)
        for node in scope.nodes:
            abort = getattr(node, "on_abort", None)
            if abort is not None:
                abort()
        raise
    finally:
        for cleanup in lowerer.cleanups:
            try:
                cleanup()
            except Exception:
                pass
    return result


def run_all(**kwargs: Any) -> RunResult:
    return run(**kwargs)


def _input_nodes(scope: df.Scope) -> list[df.InputNode]:
    return [n for n in scope.nodes if isinstance(n, df.InputNode)]


def _attach_wake(pollers) -> "Any":
    """Per-run wake signal: reader threads set it on enqueue so the idle
    park ends immediately (per-run, NOT process-wide — a shared event
    would busy-spin one run's loop while another run streams)."""
    import threading as _threading

    wake = _threading.Event()
    for p in pollers:
        q = getattr(p, "q", None)
        if q is not None and hasattr(q, "wake"):
            q.wake = wake
    return wake


def _epoch_instruments():
    """(histogram, recorder) pair the epoch loop stamps each epoch with:
    a registry histogram of epoch wall time and the flight-recorder ring
    (both bounded-cost; see engine/metrics.py, engine/flight_recorder.py)."""
    from pathway_tpu_torch.engine import flight_recorder as _blackbox
    from pathway_tpu_torch.engine import metrics as _registry

    hist = _registry.get_registry().histogram(
        "epoch.duration.ms", "wall time of one processed epoch (ms)",
        buckets=_registry.MS_BUCKETS,
    )
    return hist, _blackbox


# pathway-lint: context=epoch
def _event_loop(
    scope: df.Scope,
    lowerer: Lowerer,
    result: RunResult,
    max_epochs: int | None = None,
) -> None:
    epoch_hist, blackbox = _epoch_instruments()
    inputs = _input_nodes(scope)
    pollers = lowerer.pollers
    wake = _attach_wake(pollers)
    last_time = -1
    drain_spins = 0  # consecutive idle drain epochs (quiesce guard)
    while True:
        exhausted = True
        for poller in pollers:
            if not poller.poll():
                exhausted = False
        # choose the next epoch: smallest staged time across inputs
        times: set[int] = set()
        for inp in inputs:
            times.update(inp.pending_times())
        if times:
            t = min(times)
            if t <= last_time:
                t = last_time + 2  # keep times strictly increasing & even
            for inp in inputs:
                # merge any earlier-stamped staged rows into this epoch
                inp.merge_staged_through(t)
                inp.emit_time(t)
            t0 = _time.perf_counter()
            scope.run_epoch(t)
            epoch_hist.observe((_time.perf_counter() - t0) * 1000.0)
            blackbox.record("epoch", time=t, index=result.epochs)
            drain_spins = 0
            last_time = t
            result.last_time = t
            result.epochs += 1
            if max_epochs is not None and result.epochs >= max_epochs:
                break
            continue
        all_finished = exhausted and all(inp.finished for inp in inputs)
        if all_finished:
            break
        # epoch-boundary hooks (error-log drains, buffer releases) may have
        # parked deltas in node pending queues; an idle stream must still
        # deliver them to subscribers rather than wait for the next input
        if any(n.has_pending() for n in scope.nodes):
            drain_spins += 1
            if drain_spins > 1000:
                raise df.EngineError(
                    "idle drain did not quiesce: a node re-parks deltas "
                    "every epoch (same condition finish() guards against)"
                )
            last_time += 2
            scope.run_epoch(last_time)
            result.last_time = last_time
            continue
        # park until a reader signals new data (or the 1 ms cap)
        wake.wait(0.001)
        wake.clear()
    scope.current_time = max(scope.current_time, last_time)
    scope.finish()
    result.clean_finish = True


def run_pipeline_to_completion(sink_tables: list[tuple[Table, Callable]], **kwargs) -> RunResult:
    """Internal: run only the given (table, attach) sinks, not the global G."""
    scope = df.Scope()
    scope.terminate_on_error = kwargs.get("terminate_on_error", True)
    lowerer = Lowerer(scope)
    for table, attach in sink_tables:
        node = lowerer.node(table)
        attach(lowerer, node)
    df.infer_append_only(scope)
    result = RunResult()
    try:
        _event_loop(scope, lowerer, result)
    finally:
        for cleanup in lowerer.cleanups:
            try:
                cleanup()
            except Exception:
                pass
    return result
