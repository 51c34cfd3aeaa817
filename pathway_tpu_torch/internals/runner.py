"""Graph runner: lowers registered sinks and drives the engine event loop.

Parity target: ``python/pathway/internals/graph_runner/__init__.py``
(the tree-shake → lower → ``run_with_new_graph`` path, §3.1 of SURVEY.md) and
the worker event loop of ``src/engine/dataflow.rs:6051-6104`` (probers →
flushers → pollers → step).  The epoch loop polls connector queues, picks
the next commit timestamp across all input sessions, and runs one
consolidated pass of the operator DAG per epoch.

A copy of ``pathway_tpu/internals/runner.py``: ``run`` with the
warm-standby branch and the promotion rejoin, ``_run_once`` with the TCP
mesh of several processes (``PATHWAY_PROCESSES`` > 1), the run's
traceparent broadcast over it and, under ``PATHWAY_TORCH_DISTRIBUTED``,
one ``torch.distributed`` world of the workers (the counterpart of
``PATHWAY_JAX_DISTRIBUTED``); the topology handshake against the lease,
the progress and load beacons, the live-handoff sentinel, the promote
watcher, the flight recorder's dump context and SIGUSR1 dump, the solo and
the coordinated (BSP) epoch loops, and the storage path with its async
commit and acks.  Its observability half: the license check, telemetry
(run and epoch spans, the OTLP exporter), the prober behind the console
dashboard and the monitoring HTTP server, the epoch profiler, the
freshness tracker (which feeds the load beacon and the coordinated loop's
mesh-wide staleness), SLOs, and the flight recorder's profiler,
freshness, device, request and SLO sections.
"""

from __future__ import annotations

import os
import time as _time
from collections import deque
from contextlib import nullcontext as _nullcontext
from typing import Any, Callable

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Lowerer, Table


class Poller:
    """A connector pump: moves rows from reader threads into InputNodes.

    Mirrors the poller closure pattern (connectors/mod.rs:292; dataflow.rs:6084).
    """

    def poll(self) -> bool:
        """Advance; return True when the source is exhausted."""
        return True


def add_debug_sink(name: str, table: Table) -> None:
    def on_data(key, row, time, diff):
        sign = "+" if diff > 0 else "-"
        print(f"[{name}] {sign} key={key & 0xFFFFFFFF:x} time={time} row={row}")

    table._subscribe_raw(on_data, name=f"debug:{name}")


class RunResult:
    def __init__(self):
        self.epochs = 0
        self.prober = None  # engine.probes.Prober when monitoring ran
        self.telemetry = None  # engine.telemetry.Telemetry for this run
        self.profiler = None  # engine.profiler.EpochProfiler for this run
        self.freshness = None  # engine.freshness.FreshnessTracker for this run
        self.last_time: int | None = None  # last processed epoch
        self.clean_finish = False
        # set when the run exited through a LIVE HANDOFF: the worker
        # drained + fenced its frontier for a planned rescale to this
        # worker count and exited 0 WITHOUT finishing the scope — neither
        # a clean finish nor a failure (the supervisor relaunches at the
        # new topology and the run continues there)
        self.handoff_to: int | None = None
        # an exception escaped mid-run_epoch: node states are inconsistent
        # (some nodes stepped the failing epoch, some did not)
        self.epoch_failed = False


def _graph_digest(scope: df.Scope) -> str:
    """Structural fingerprint for operator-snapshot compatibility.

    Covers node kinds, wiring (input ids/ports), and iterate subscopes.
    Best-effort: changes inside Python callables (UDF bodies, filter
    predicates) are invisible to it — the same limitation the reference has
    with its positionally-matched operator snapshots."""
    import hashlib as _hashlib

    def scope_sig(s: df.Scope) -> str:
        parts = []
        for n in s.nodes:
            wires = ",".join(str(i.id) for i in n.inputs)
            part = f"{n.name}({wires})"
            sub = getattr(n, "subscope", None)
            if sub is not None:
                part += "{" + scope_sig(sub) + "}"
            parts.append(part)
        return ";".join(parts)

    sig = scope_sig(scope)
    return f"{len(scope.nodes)}:{_hashlib.md5(sig.encode()).hexdigest()}"


def _wire_operator_persistence(scope: df.Scope, storage: Any) -> None:
    """Operator-snapshot mode: restore node arrangements from the last
    committed generation, and hand the storage a collector that dumps dirty
    nodes at each commit (persistence/operator_snapshot.rs analog)."""
    import pickle as _pickle

    digest = _graph_digest(scope)
    for node_id, blob in storage.load_operator_states(digest).items():
        scope.nodes[node_id].persist_load(_pickle.loads(blob))
    last_rows_in: dict[int, int] = {n.id: n.rows_in for n in scope.nodes}
    staged_marks: dict[int, int] = {}

    def collect(full: bool):
        # full=True (clean finish): dump everything — on_finish hooks
        # mutate state (buffer drains) without touching rows_in
        dirty: dict[int, bytes] = {}
        staged_marks.clear()
        for node in scope.nodes:
            if not full and node.rows_in == last_rows_in.get(node.id, -1):
                continue
            data = node.persist_dump()
            staged_marks[node.id] = node.rows_in
            if data is not None:
                dirty[node.id] = _pickle.dumps(data)
        return dirty, digest

    def confirm():
        # nodes count as clean only once the metadata referencing their
        # dumps is durably committed — a failed commit must re-dump them
        last_rows_in.update(staged_marks)
        staged_marks.clear()

    storage.collect_operator_states = collect
    storage.confirm_operator_commit = confirm


def run(**kwargs: Any) -> RunResult:
    """``pw.run`` — execute every registered sink to completion.

    ``_sinks`` (internal) runs an explicit sink list instead of the
    graph's registry — ``Table.live()`` uses it to run one export sink's
    cone on a background thread while the interactive graph stays open
    (the reference's ``runner.run_nodes([operator])``).

    Two supervised-run detours wrap the single execution
    (:func:`_run_once`); both are inert for ordinary runs:

    * **standby mode** (``PATHWAY_STANDBY_ID`` exported by the
      supervisor): instead of joining the mesh, the process tails the
      persistence root (``engine/standby.py``) until the supervisor
      either stops it or PROMOTES it into a dead worker's id — at which
      point it falls through into the normal worker path below, already
      wearing the dead worker's identity.
    * **promotion rejoin**: when a PEER dies and a standby is being
      promoted, this worker's mesh is poisoned
      (:class:`~pathway_tpu_torch.engine.comm.MeshPoisoned`) so the run
      unwinds through its normal consistent drain-commit — and then,
      instead of exiting for a whole-group restart, the loop here acks
      the promotion and re-enters ``_run_once`` in-process: fresh mesh,
      fresh graph, zero process-spawn cost, surviving workers never
      restart.
    """
    from pathway_tpu_torch.engine import standby as _standby

    sid = _standby.standby_id()
    if sid is not None:
        root = _persistence_root(kwargs.get("persistence_config"))
        if root is None:
            raise RuntimeError(
                "standby mode (PATHWAY_STANDBY_ID) requires a filesystem "
                "persistence root to tail — spawn with --checkpoints"
            )
        if _standby.standby_main(root, sid) is None:
            return RunResult()  # supervisor shutdown before any promotion
        # promoted: this process adopted the dead worker's identity; fall
        # through into the normal worker path
    while True:
        try:
            return _run_once(**kwargs)
        except BaseException as exc:
            from pathway_tpu_torch.engine.comm import CommError, MeshPoisoned

            # a CommError on a dead peer counts as the poison signal when
            # a promotion naming this incarnation is pending: the link
            # heartbeat and the supervisor race to notice the death, and
            # losing that race must not demote a promotion to a restart
            if not isinstance(exc, MeshPoisoned) and not (
                isinstance(exc, CommError)
                and _pending_promotion(kwargs.get("persistence_config"))
                is not None
            ):
                raise
            _promotion_rejoin(kwargs.get("persistence_config"))


def _run_once(
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
    """One mesh lifetime of ``pw.run`` — see :func:`run` for the
    standby/promotion wrapper that may call this more than once."""
    scope = df.Scope()
    scope.terminate_on_error = terminate_on_error

    # multi-process SPMD: every process runs this same script and builds the
    # identical graph; a TCP mesh exchanges rows by key shard
    # (engine/comm.py; the reference's timely Cluster config analog).
    from pathway_tpu_torch.internals.config import env_bool as _env_bool
    from pathway_tpu_torch.internals.config import get_config as _get_config

    _cfg = _get_config()
    # topology handshake: a supervised worker's mesh size must be the
    # lease-recorded topology, not whatever argv happened to say — an
    # operator relaunching with a stale -n (or a k8s replica count scaled
    # behind the supervisor's back) must fail loudly BEFORE the mesh
    # forms, not resume with a silently mis-sharded cluster
    _topology_handshake(persistence_config, _cfg)
    if _cfg.processes > 1 and _env_bool("PATHWAY_TORCH_DISTRIBUTED"):
        # `spawn --torch-distributed`: the host workers double as the ranks
        # of one torch.distributed world (NCCL between cards, gloo on the
        # CPU), the counterpart of the JAX package's global device mesh
        from pathway_tpu_torch.parallel.mesh import initialize_distributed

        initialize_distributed()
    worker_ctx = None
    trace_parent = os.environ.get("TRACEPARENT")
    if _cfg.processes > 1:
        from pathway_tpu_torch.engine.comm import TcpMesh, WorkerContext

        mesh = TcpMesh(
            _cfg.process_id,
            _cfg.processes,
            _cfg.first_port,
            peer_hosts=_cfg.peer_hosts,
        ).start()
        worker_ctx = WorkerContext(mesh)
        scope.worker = worker_ctx
        # cross-worker trace correlation: worker 0 mints the run's
        # traceparent (unless the deployment already exported one — `spawn`
        # does) and broadcasts it over the fresh mesh, so epoch/commit/
        # recovery spans from EVERY worker land in one trace
        from pathway_tpu_torch.engine.telemetry import mint_traceparent

        if _cfg.process_id == 0 and not trace_parent:
            trace_parent = mint_traceparent()
        trace_parent = mesh.bcast(("traceparent",), trace_parent)

    lowerer = Lowerer(scope)
    # pw.run(debug=True): connectors with debug_data= lower to static
    # tables of that data (reference operator_handler.py:110)
    lowerer.debug_mode = debug

    storage = _make_storage(persistence_config)
    if storage is not None:
        lowerer.persistence_storage = storage

    # lower all sinks (tree-shaking is implicit: only sink cones are built)
    sink_labels: set[str] = set()
    for name, table, attach in (list(G.sinks) if _sinks is None else _sinks):
        node = lowerer.node(table)
        sink_node = attach(lowerer, node)
        # per-output identity for the freshness/staleness metrics: the
        # registration name is the label operators and dashboards rank
        # by.  Colliding names (two default-named subscribes, or distinct
        # raw names that sanitize to the same label value) get a node id
        # suffix — sharing one label would let a stalled output hide
        # behind a healthy one refreshing the same staleness gauge.
        if isinstance(sink_node, df.OutputNode) and sink_node.sink_name is None:
            from pathway_tpu_torch.engine.freshness import safe_label

            label = safe_label(name)
            if label in sink_labels:
                label = f"{label}#{sink_node.id}"
            sink_node.sink_name = label
            sink_labels.add(label)

    # append-only analysis must run before any state is restored or stepped:
    # GroupByNode picks its accumulator variant off the inferred flags
    df.infer_append_only(scope)

    result = RunResult()
    if storage is not None and storage.operator_persistence:
        _wire_operator_persistence(scope, storage)
    root_token = None
    http_server = None
    persist_root = None  # filesystem persistence root, when there is one
    prev_usr1 = None
    usr1_installed = False
    promote_watcher = None
    try:
        if storage is not None:
            from pathway_tpu_torch.engine import faults as _faults
            from pathway_tpu_torch.engine import persistence as pz

            base_backend = storage.backend
            if isinstance(base_backend, _faults.FlakyBackend):
                base_backend = base_backend.inner  # fault wrapper is I/O-only
            if isinstance(base_backend, pz.FileBackend):
                persist_root = base_backend.root
                # UDF DiskCache shares the persistence root for this run
                # only; acquired inside the try so any failure below still
                # releases it in the finally
                root_token = pz.acquire_active_root(persist_root)

        from pathway_tpu_torch.engine.probes import Prober
        from pathway_tpu_torch.internals.config import get_config
        from pathway_tpu_torch.internals.monitoring import MonitoringLevel, monitor_stats

        config = get_config()
        if monitoring_level is None:
            monitoring_level = MonitoringLevel.AUTO

        from pathway_tpu_torch.engine.telemetry import Telemetry, TelemetryConfig
        from pathway_tpu_torch.internals.license import License

        from pathway_tpu_torch.engine import flight_recorder as _blackbox
        from pathway_tpu_torch.engine import metrics as _registry

        license = License.new(config.license_key)
        registry = _registry.get_registry()
        telemetry = Telemetry(
            TelemetryConfig.create(
                license=license,
                run_id=config.run_id,
                monitoring_server=config.monitoring_server,
                trace_parent=trace_parent,
            ),
            lambda: result.prober.stats if result.prober is not None else None,
            # the unified registry (comm/persistence/supervisor/runner
            # instrumentation): scalars merge into every sample, histograms
            # export as OTLP histogram datapoints.  The commit-pipeline
            # gauges ride it too, through the collector PersistentStorage
            # registers — no extra_metrics wiring needed
            registry=registry,
        ).start()
        result.telemetry = telemetry

        # crash flight recorder: dump context for this worker — the ring
        # lands under <root>/blackbox/ on crash/fault, where the supervisor
        # gathers it into SupervisorResult.post_mortem
        from pathway_tpu_torch.engine.faults import restart_attempt as _attempt
        from pathway_tpu_torch.engine.persistence import writer_incarnation

        _blackbox.configure(
            worker=config.process_id,
            run_id=telemetry.config.run_id,
            trace_parent=trace_parent,
            attempt=_attempt(),
            # the dump path is fenced like every persistence-root write:
            # a zombie from a superseded incarnation must not drop its
            # stale ring into the live cluster's blackbox/
            incarnation=writer_incarnation(),
        )
        # hung-worker protocol, worker side: SIGUSR1 from the supervisor's
        # progress watchdog pulls the flight recorder out of a wedged
        # process BEFORE the SIGTERM/SIGKILL escalation destroys it.  The
        # distinct dump suffix keeps the hang story from clobbering (or
        # being clobbered by) this attempt's crash dump.  Main thread only
        # (signal.signal refuses elsewhere — e.g. Table.live() runs);
        # restored in the finally so embedding processes keep their own
        # handler after the run.
        import signal as _signal
        import threading as _threading

        if _threading.current_thread() is _threading.main_thread():
            # pathway-lint: context=signal
            def _usr1_dump(signum, frame):
                _blackbox.record(
                    "watchdog.sigusr1", worker=config.process_id,
                )
                _blackbox.get_recorder().dump(
                    "watchdog: epoch-progress deadline exceeded (SIGUSR1)",
                    suffix="watchdog",
                )

            try:
                prev_usr1 = _signal.signal(_signal.SIGUSR1, _usr1_dump)
                usr1_installed = True
            except (ValueError, OSError, AttributeError):
                prev_usr1 = None
        # the watchdog's on-disk liveness signal; a no-op without a
        # filesystem persistence root
        beacon = _ProgressBeacon(persist_root, config.process_id)
        # live-handoff participation (engine/autoscaler.py): worker 0
        # watches for the supervisor's handoff request at epoch
        # boundaries; every worker acks its fenced frontier through the
        # same sentinel.  Inert outside supervised runs (incarnation 0).
        handoff_sentinel = _HandoffSentinel(
            persist_root, config.process_id, config.processes
        )
        if handoff_sentinel.root is not None:
            # the autoscaler panel rides this worker's observability
            # surfaces: the supervisor maintains lease/autoscaler.json,
            # the worker re-exports it as autoscaler.* gauges (for
            # /status, /metrics, `pathway_tpu_torch top`) and as the
            # flight-recorder dump's `autoscaler` payload section
            from pathway_tpu_torch.engine import autoscaler as _autoscaler

            _as_root = handoff_sentinel.root
            registry.register_collector(
                "autoscaler.state",
                lambda: _autoscaler.state_metrics(_as_root),
            )
            _blackbox.get_recorder().set_autoscaler_supplier(
                lambda: _autoscaler.read_state_file(_as_root)
            )
            # warm-standby panel: apply-cursor beacons + promotion
            # history re-exported as standby.* / supervisor.promotions
            # gauges (the supervisor's own registry serves no /metrics)
            from pathway_tpu_torch.engine import standby as _standby_mod

            registry.register_collector(
                "standby.state",
                lambda: _standby_mod.state_metrics(_as_root),
            )
            if worker_ctx is not None:
                # promotion sentinel: a PROMOTE request on the root means
                # a peer died and a standby is adopting its id — poison
                # the mesh so this worker unwinds through its drain-commit
                # and rejoins in-process (see run()), instead of waiting
                # out heartbeats on a peer that returns as a new process
                promote_watcher = _PromoteWatcher(
                    _as_root, config.process_id, worker_ctx.mesh
                ).start()
        # restart provenance, mesh-visible: the supervisor increments its
        # own supervisor.restarts counter, but that registry lives in the
        # spawn process, which serves no /metrics — each worker knows the
        # attempt that launched it, so the count is scrapeable here
        registry.gauge(
            "worker.restart.attempt",
            "supervisor restarts performed before this worker launch",
            worker=config.process_id,
        ).set(_attempt())
        # set (or clear) the dump root for THIS run: a run without a
        # filesystem persistence root must not dump into a previous run's
        _blackbox.get_recorder().root = persist_root
        _blackbox.record(
            "run.start", worker=config.process_id, attempt=_attempt(),
            workers=config.processes,
        )

        # performance observability (engine/profiler.py): per-operator
        # attribution sampled off the always-on step timers, the opt-in
        # transfer accounting, and a final profiler snapshot riding every
        # flight-recorder dump so post-mortems say where the time went (the
        # kernel-build counters, device.kernel.*, are always on)
        from pathway_tpu_torch.engine import profiler as _profiler

        profiler = _profiler.EpochProfiler()
        result.profiler = profiler
        if profiler.enabled:
            registry.register_collector(
                "profiler.operators", profiler.metrics_snapshot
            )
        _profiler.install_transfer_accounting()
        _blackbox.get_recorder().set_profile_supplier(
            lambda: profiler.crash_snapshot(scope)
        )

        # device observability (device/telemetry.py): every
        # flight-recorder dump carries the final DeviceExecutor snapshot
        # (cost/utilization/padding/HBM/queue) — post-mortems say what
        # the device was doing.  The supplier never instantiates an
        # executor: a run that never touched the device path dumps no
        # device section
        from pathway_tpu_torch.device import default_executor_snapshot

        _blackbox.get_recorder().set_device_supplier(
            default_executor_snapshot
        )

        # data-plane observability (engine/freshness.py): ingest-time
        # low-watermark propagation (per-output e2e latency + staleness)
        # and backlog.* backpressure attribution — the "where records
        # wait" complement of the profiler's "where CPU burns"
        from pathway_tpu_torch.engine import freshness as _freshness

        freshness = _freshness.FreshnessTracker()
        result.freshness = freshness
        if freshness.enabled:
            freshness.attach(scope, lowerer.pollers)
            registry.register_collector(
                "freshness.tracker", freshness.metrics_snapshot
            )
            # post-mortems say what was STUCK, not just where time went:
            # every flight-recorder dump carries the final watermark/
            # backlog snapshot next to the profiler's attribution
            _blackbox.get_recorder().set_freshness_supplier(
                freshness.crash_snapshot
            )

        # serving observability (engine/serving.py): every flight-recorder
        # dump carries the admission controller's final snapshot (in-flight/
        # queue occupancy, degraded/draining, quarantine tail), and the
        # load shedder sees sustained *pipeline* pressure through the
        # freshness sensor — both inert when no REST route ever admits
        from pathway_tpu_torch.engine import serving as _serving

        _blackbox.get_recorder().set_serving_supplier(
            _serving.snapshot_or_none
        )
        if freshness.enabled:
            _serving.set_pressure_supplier(freshness.worst_staleness)

        # request tracing + SLOs (engine/tracing.py, engine/slo.py):
        # request spans ride this run's bounded telemetry export queue,
        # the declared-SLO evaluator joins the scrape path, and every
        # flight-recorder dump carries the finished-request ring
        # (waterfalls) and the SLO burn/budget snapshot
        from pathway_tpu_torch.engine import slo as _slo
        from pathway_tpu_torch.engine import tracing as _tracing

        _tracing.set_exporter(telemetry)
        _slo.install(registry)
        _blackbox.get_recorder().set_tracing_supplier(_tracing.snapshot)
        _blackbox.get_recorder().set_slo_supplier(
            lambda: _slo.get_evaluator().snapshot()
        )

        if with_http_server:
            from pathway_tpu_torch.engine.http_server import MonitoringServer

            http_server = MonitoringServer(
                process_id=config.process_id,
                port=config.monitoring_http_port,
                run_id=config.run_id,
            ).start()
        with monitor_stats(monitoring_level) as monitor:
            prober = Prober(scope, pollers=lowerer.pollers)
            if monitor is not None:
                prober.callbacks.append(monitor.update)
            if http_server is not None:
                prober.callbacks.append(http_server.update)
            result.prober = prober
            # dataflow progress totals join the unified registry (the
            # WeakMethod registration dies with the prober; each run
            # replaces the previous run's collector under this name)
            registry.register_collector(
                "dataflow.prober", prober.metrics_snapshot
            )
            with telemetry.span("pathway.run", workers=config.threads):
                try:
                    _event_loop(
                        scope, lowerer, result, max_epochs=max_epochs,
                        storage=storage, prober=prober, telemetry=telemetry,
                        beacon=beacon,
                        # None when disabled, so the default configuration
                        # pays zero per-epoch cost (not even the call)
                        profiler=profiler if profiler.enabled else None,
                        freshness=freshness if freshness.enabled else None,
                        handoff=handoff_sentinel,
                    )
                except BaseException as exc:
                    from pathway_tpu_torch.engine.comm import MeshPoisoned

                    if isinstance(exc, MeshPoisoned):
                        # promotion rejoin, not a failure: run() acks and
                        # re-enters after the finally's drain-commit.  No
                        # crash dump — the blackbox ring stays for real
                        # failures.  In-flight serving requests wait on
                        # epochs this mesh will never run: answer them
                        # with the typed retry signal now instead of
                        # letting them time out across the rejoin.
                        _blackbox.record(
                            "promotion.rejoin", worker=config.process_id,
                            reason=str(exc),
                        )
                        _serving.fail_inflight_for_promotion()
                    else:
                        # black-box the failure BEFORE unwinding: the
                        # ring's last events are the crash story the
                        # supervisor (or `pathway_tpu_torch blackbox`) reads
                        # back post-mortem
                        _blackbox.record(
                            "run.failed", worker=config.process_id,
                            error=repr(exc),
                        )
                        _blackbox.dump(f"run failed: {exc!r}")
                    # failure hooks: exported tables must flip to failed so
                    # concurrent importers raise instead of waiting forever
                    # (the scopeguard of dataflow/export.rs:143-146)
                    for node in scope.nodes:
                        abort = getattr(node, "on_abort", None)
                        if abort is not None:
                            abort()
                    raise
    finally:
        if usr1_installed:
            import signal as _signal

            try:
                _signal.signal(
                    _signal.SIGUSR1,
                    prev_usr1 if prev_usr1 is not None else _signal.SIG_DFL,
                )
            except (ValueError, OSError):
                pass
        if result.profiler is not None:
            # the run's profile outlives the run: final snapshot to the
            # PATHWAY_PROFILE_OUTPUT path (best-effort), and the crash
            # supplier cleared so the recorder stops referencing this
            # run's node arena
            from pathway_tpu_torch.engine import flight_recorder as _blackbox

            if result.profiler.enabled:
                result.profiler.sample(scope, result.epochs)
                result.profiler.write_output()
            _blackbox.get_recorder().set_profile_supplier(None)
        if result.freshness is not None:
            # same lifetime rule for the freshness supplier: the recorder
            # must not outlive this run's pollers and node arena
            from pathway_tpu_torch.engine import flight_recorder as _blackbox

            _blackbox.get_recorder().set_freshness_supplier(None)
        # the device supplier references only the process-global executor
        # (no run state), but clearing it keeps the recorder's lifetime
        # contract uniform across all three suppliers
        from pathway_tpu_torch.engine import flight_recorder as _blackbox_dev

        _blackbox_dev.get_recorder().set_device_supplier(None)
        _blackbox_dev.get_recorder().set_autoscaler_supplier(None)
        _blackbox_dev.get_recorder().set_serving_supplier(None)
        _blackbox_dev.get_recorder().set_tracing_supplier(None)
        _blackbox_dev.get_recorder().set_slo_supplier(None)
        # ...and the serving shedder must stop referencing this run's
        # freshness tracker (same lifetime rule as the suppliers above)
        from pathway_tpu_torch.engine import serving as _serving_cleanup

        _serving_cleanup.set_pressure_supplier(None)
        # the trace exporter holds this run's Telemetry: clear it before
        # telemetry.close() so no late span enqueues into a closed queue
        from pathway_tpu_torch.engine import tracing as _tracing_cleanup

        _tracing_cleanup.set_exporter(None)
        if promote_watcher is not None:
            promote_watcher.stop()
        if worker_ctx is not None:
            worker_ctx.close()
        if result.telemetry is not None:
            result.telemetry.close()
        if http_server is not None:
            http_server.close()
        try:
            if storage is not None:
                # also on interrupt/error: commit whatever frontier is
                # consistent.  Offsets never advance past the last PROCESSED
                # epoch (rows staged for later epochs are not yet in any
                # snapshot), and a failure mid-epoch must not dump
                # half-stepped operator state — the previous consistent
                # generation stays committed instead.  This final commit()
                # is the shutdown DRAIN of the async pipeline: it publishes
                # every staged generation in order, barriers on in-flight
                # chunk writes, and only then commits the final frontier —
                # so a clean finish commits exactly the flushed frontier.
                frontier = (
                    result.last_time if result.last_time is not None else -1
                )
                if result.epoch_failed and storage.operator_persistence:
                    import logging

                    logging.getLogger("pathway_tpu_torch").warning(
                        "run failed mid-epoch; keeping the previous "
                        "consistent operator snapshot generation"
                    )
                else:
                    # the shutdown drain-commit gets its own span so the
                    # run's trace shows where final durability time went
                    commit_span = (
                        result.telemetry.span("pathway.commit", final=True)
                        if result.telemetry is not None
                        else _nullcontext()
                    )
                    with commit_span:
                        storage.commit(
                            processed_up_to=frontier,
                            full_operator_dump=result.clean_finish,
                        )
                    # this drain-commit durably covers every drained commit
                    # marker (their chunks were flushed at drain), so
                    # release the tail acks the in-loop published_seq
                    # gating may still be holding — snapshots staged but
                    # not yet published when the loop exited
                    _ack_sources(lowerer.pollers, persisted=True)
        finally:
            # the final commit may raise (failing store): the process-global
            # UDF-cache root and the connector cleanups must be released
            # regardless, or the leaked root poisons every later run in this
            # process (e.g. persistence-derived sink key salts)
            if storage is not None:
                from pathway_tpu_torch.engine import persistence as pz

                pz.release_active_root(root_token)
            for cleanup in lowerer.cleanups:
                try:
                    cleanup()
                except Exception:
                    pass
    return result


def _topology_handshake(persistence_config: Any, cfg: Any) -> None:
    """Verify this worker's launch topology against the lease on its
    persistence root (supervised runs only — the supervisor records the
    target worker count in the incarnation lease before every launch).

    The mesh is sized from ``PATHWAY_PROCESSES``; this check makes the
    LEASE the authority: a mismatch means the supervisor and the worker
    disagree about the cluster shape, and resuming would mis-shard every
    exchanged row.  Read-only — a missing root, missing lease, or a lease
    without a recorded topology (pre-rescale roots) passes silently.
    """
    from pathway_tpu_torch.engine.persistence import (
        read_lease_file,
        writer_incarnation,
    )

    if writer_incarnation() <= 0:
        return  # unsupervised: no lease authority to handshake with
    root = None
    backend_cfg = getattr(persistence_config, "backend", None)
    if backend_cfg is not None:
        if getattr(backend_cfg, "kind", None) == "filesystem":
            root = getattr(backend_cfg, "path", None)
    elif persistence_config is None and cfg.replay_storage:
        root = cfg.replay_storage
    if not root or not os.path.isdir(root):
        return
    lease = read_lease_file(root)
    if lease is None:
        return
    workers = lease.get("workers")
    if not isinstance(workers, int):
        return
    if workers != cfg.processes:
        raise RuntimeError(
            f"topology handshake failed: the lease on {root} records a "
            f"cluster of {workers} worker(s) (incarnation "
            f"{lease['incarnation']}), but this worker was launched with "
            f"PATHWAY_PROCESSES={cfg.processes} — the supervisor and the "
            "worker disagree about the mesh size. Relaunch through "
            f"`python -m pathway_tpu_torch spawn --supervise -n {workers}`, or rescale "
            "deliberately by re-running the supervisor at the new count."
        )
    if cfg.process_id >= workers:
        raise RuntimeError(
            f"topology handshake failed: worker id {cfg.process_id} is "
            f"outside the leased topology of {workers} worker(s) on {root}"
        )


def _persistence_root(persistence_config: Any) -> str | None:
    """This run's filesystem persistence root, or None — the same backend
    unwrap ``_topology_handshake`` performs, shared by the standby branch
    and the promotion-rejoin loop of :func:`run`."""
    from pathway_tpu_torch.internals.config import get_config

    backend_cfg = getattr(persistence_config, "backend", None)
    if backend_cfg is not None:
        if getattr(backend_cfg, "kind", None) == "filesystem":
            return getattr(backend_cfg, "path", None) or None
        return None
    if persistence_config is None:
        return get_config().replay_storage or None
    return None


# promotion seqs this process already acked: the promote sentinel of the
# NEXT mesh (post-rejoin) must not re-poison on the still-present PROMOTE
# file while the supervisor collects the remaining acks
_ACKED_PROMOTE_SEQS: set[int] = set()


def _pending_promotion(persistence_config: Any) -> dict | None:
    """The PROMOTE request this worker still owes a rejoin, or None."""
    from pathway_tpu_torch.engine import persistence as pz
    from pathway_tpu_torch.internals.config import get_config

    root = _persistence_root(persistence_config)
    if root is None or pz.writer_incarnation() <= 0:
        return None
    req = pz.read_promote_request(root)
    if (
        req is None
        or req["incarnation"] != pz.writer_incarnation()
        or req["worker"] == get_config().process_id
        or req["seq"] in _ACKED_PROMOTE_SEQS
    ):
        return None
    return req


def _promotion_rejoin(persistence_config: Any) -> None:
    """Between a poisoned ``_run_once`` and its re-entry: ack the PROMOTE
    request (the drain-commit already ran in ``_run_once``'s finally, so
    the ack certifies this worker's frontier is durable and its old mesh
    is gone) and re-open the admission controller the unwind drained."""
    from pathway_tpu_torch.engine import persistence as pz
    from pathway_tpu_torch.engine import serving as _serving
    from pathway_tpu_torch.internals.config import get_config

    req = _pending_promotion(persistence_config)
    if req is not None:
        root = _persistence_root(persistence_config)
        pz.write_promote_ack(
            root,
            get_config().process_id,
            seq=req["seq"],
            worker=req["worker"],
            incarnation=req["incarnation"],
        )
        _ACKED_PROMOTE_SEQS.add(req["seq"])
    _serving.resume_after_promotion()


def _make_storage(persistence_config: Any):
    """Build engine PersistentStorage from a ``pw.persistence.Config``, or
    from the record/replay env config (``PATHWAY_REPLAY_STORAGE`` +
    ``PATHWAY_SNAPSHOT_ACCESS``, reference ``internals/config.py:35-54``)
    when no explicit config is given."""
    from pathway_tpu_torch.internals.config import get_config

    if persistence_config is None:
        cfg = get_config()
        if not cfg.replay_storage:
            return None
        from pathway_tpu_torch.engine import persistence as pz

        storage = pz.PersistentStorage(
            _flaky_wrap(pz.FileBackend(cfg.replay_storage)),
            snapshot_interval_ms=0,
            worker=cfg.process_id,
        )
        storage.snapshot_access = _normalize_access(cfg.snapshot_access)
        storage.continue_after_replay = cfg.continue_after_replay
        return storage
    backend_cfg = getattr(persistence_config, "backend", None)
    if backend_cfg is None:
        return None
    from pathway_tpu_torch.engine import persistence as pz

    backend = _flaky_wrap(pz.backend_from_config(backend_cfg))
    storage = pz.PersistentStorage(
        backend,
        snapshot_interval_ms=getattr(persistence_config, "snapshot_interval_ms", 0),
        mode=getattr(persistence_config, "persistence_mode", None),
        # worker-sharded snapshots: each process owns metadata.json.<id> and
        # snapshots/<id>/... — without this, multi-process runs clobber one
        # another's state (the reference shards snapshot files per worker)
        worker=get_config().process_id,
    )
    storage.snapshot_access = _normalize_access(
        getattr(persistence_config, "snapshot_access", None)
    )
    storage.continue_after_replay = getattr(
        persistence_config, "continue_after_replay", True
    )
    return storage


def _flaky_wrap(backend: Any) -> Any:
    """Blob-level fault injection (PATHWAY_FAULT_PLAN blob_* specs):
    chaos/soak runs exercise checkpoint commit failure paths with no code
    change — a no-op wrapper selection when no plan is active."""
    from pathway_tpu_torch.engine import faults as _faults

    return _faults.wrap_backend(backend)


def _normalize_access(access: Any) -> str | None:
    """"record"/"replay" as lowercase strings, whether given as str or enum."""
    if access is None or isinstance(access, str):
        return access.lower() if isinstance(access, str) else None
    return str(getattr(access, "name", access)).lower()


def run_all(**kwargs: Any) -> RunResult:
    return run(**kwargs)


def _input_nodes(scope: df.Scope) -> list[df.InputNode]:
    return [n for n in scope.nodes if isinstance(n, df.InputNode)]


def _ack_sources(
    pollers,
    *,
    persisted: bool,
    up_to_time: int | None = None,
    marker_frontiers: dict | None = None,
) -> None:
    """Tell external-offset sources (Kafka groups) a durability point passed.

    ``persisted=True``: called when ``storage.published_seq`` advances —
    a staged snapshot became durable (its generation manifest published,
    or a confirmed no-op) — and acks pollers whose rows land in input
    snapshots (replay covers them), gated on ``marker_frontiers`` (the
    per-poller drained-marker frontier captured when that snapshot was
    STAGED): markers drained while the publish was in flight belong to a
    later snapshot and must not be acked by this one.
    ``persisted=False``: called after an epoch ran — acks pollers with no
    snapshot state, gated on the epoch time.
    """
    for poller in pollers:
        ack = getattr(poller, "ack_processed", None)
        if ack is None:
            continue
        has_snapshots = getattr(poller, "persist_state", None) is not None
        if has_snapshots != persisted:
            continue
        if persisted and marker_frontiers is not None:
            ack(up_to_marker=marker_frontiers.get(id(poller)))
        else:
            ack(up_to_time)


def _marker_frontiers(pollers) -> dict:
    """{id(poller): drained-marker frontier} for persisted pollers, taken
    at snapshot-STAGING time — what the staged snapshot actually covers."""
    out: dict = {}
    for poller in pollers:
        frontier = getattr(poller, "marker_frontier", None)
        if frontier is not None and getattr(poller, "persist_state", None) is not None:
            out[id(poller)] = frontier()
    return out


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


class _ProgressBeacon:
    """Epoch-loop liveness beacon for the supervisor's hung-worker watchdog.

    The epoch loop touches ``<root>/lease/progress.<worker>`` — on every
    processed epoch AND on idle iterations — so the beacon's mtime means
    "the event loop is alive and scheduling", not "input is flowing": an
    idle-but-healthy stream keeps touching, a deadlocked epoch loop or a
    wedged commit drain stops.  Rate-limited to one write per 0.25 s; the
    write is a tiny pid overwrite, so the steady-state cost is four small
    writes per second.  A run without a filesystem persistence root has no
    beacon (and the supervisor has no watchdog for it), and so does an
    UNSUPERVISED run — nothing would ever read the beacon, and a solo
    run's root should not grow a ``lease/`` directory no lease owns.
    """

    _MIN_INTERVAL_S = 0.25

    def __init__(self, root: str | None, worker: int):
        # supervised is recognizable from the worker side: the supervisor
        # exports PATHWAY_INCARNATION with the lease, and an env-configured
        # watchdog leaves PATHWAY_EPOCH_DEADLINE_S visible here too
        if root is not None:
            from pathway_tpu_torch.engine.persistence import writer_incarnation
            from pathway_tpu_torch.engine.supervisor import ENV_EPOCH_DEADLINE
            from pathway_tpu_torch.internals.config import env_raw

            if writer_incarnation() <= 0 and not env_raw(ENV_EPOCH_DEADLINE):
                root = None
        self.path = (
            os.path.join(root, "lease", f"progress.{worker}")
            if root
            else None
        )
        self._last = 0.0
        if self.path is not None:
            try:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
            except OSError:
                self.path = None
        # load beacon (engine/autoscaler.py): beside liveness, a
        # supervised worker reports its load reading (worst output
        # staleness + backlog) at the same rate-limited cadence — the
        # sensor feed of the supervisor's scale controller.  Solo and
        # autoscaling-off runs pay nothing, not even the supplier call.
        self.root = root if self.path is not None else None
        self.worker = worker
        self._last_load = 0.0
        if self.root is not None:
            from pathway_tpu_torch.engine.autoscaler import autoscale_enabled

            self._load_enabled = autoscale_enabled()
        else:
            self._load_enabled = False
        self.touch(force=True)

    def touch(self, force: bool = False) -> None:
        if self.path is None:
            return
        now = _time.monotonic()
        if not force and now - self._last < self._MIN_INTERVAL_S:
            return
        self._last = now
        try:
            with open(self.path, "w") as f:
                f.write(str(os.getpid()))
        except OSError:
            pass  # liveness reporting must never take the worker down

    _LOAD_INTERVAL_S = 0.5

    def report_load(self, supplier) -> None:
        """Rate-limited load beacon write; ``supplier`` returns
        ``(worst_staleness_s, backlog, epochs)`` and is only invoked when
        a write is actually due (so the snapshot cost is paid at beacon
        cadence, not per loop iteration)."""
        if not self._load_enabled:
            return
        now = _time.monotonic()
        if now - self._last_load < self._LOAD_INTERVAL_S:
            return
        self._last_load = now
        from pathway_tpu_torch.engine.autoscaler import write_load_beacon

        try:
            staleness_s, backlog, epochs = supplier()
            write_load_beacon(
                self.root, self.worker,
                staleness_s=staleness_s, backlog=backlog, epochs=epochs,
            )
        except Exception:  # noqa: BLE001 - load reporting must never
            pass  # take the worker down (same rule as touch())


def _load_reading(freshness, result) -> tuple[float, float, int]:
    """One (worst staleness, backlog, epochs) sensor reading for the load
    beacon.  Backlog sums the row/queue-count families of the freshness
    tracker's backlog attribution (ages excluded — mixing seconds into a
    count would double-weight a stall the staleness number already
    carries).  No tracker → (0, 0): an instrumentation gap reads as calm,
    never as load."""
    staleness = 0.0
    backlog = 0.0
    if freshness is not None:
        staleness = freshness.worst_staleness() or 0.0
        for key, value in freshness.metrics_snapshot().items():
            if key.startswith(
                (
                    "backlog.ingest.rows",
                    "backlog.connector.queue",
                    "backlog.epochs.pending",
                )
            ):
                backlog += value
    return staleness, backlog, result.epochs


class _HandoffSentinel:
    """Worker-side watch for the supervisor's live-handoff request.

    Worker 0 polls ``lease/HANDOFF`` (rate-limited file read) at epoch
    boundaries and, on a valid request for THIS incarnation and a
    DIFFERENT worker count, returns the target so the epoch loop can
    broadcast the handoff decision.  Requests from other incarnations
    (zombie roots, stale files a crashed supervisor left behind) are
    ignored — the supervisor clears the files either way."""

    _MIN_INTERVAL_S = 0.2

    def __init__(self, root: str | None, worker: int, workers: int):
        from pathway_tpu_torch.engine.persistence import writer_incarnation

        self.incarnation = writer_incarnation()
        self.root = root if self.incarnation > 0 else None
        self.worker = worker
        self.workers = workers
        self._last = 0.0

    def poll(self) -> int | None:
        """The pending handoff target (worker count), or None."""
        if self.root is None:
            return None
        now = _time.monotonic()
        if now - self._last < self._MIN_INTERVAL_S:
            return None
        self._last = now
        from pathway_tpu_torch.engine.persistence import read_handoff_request

        req = read_handoff_request(self.root)
        if (
            req is None
            or req["incarnation"] != self.incarnation
            or req["to_workers"] == self.workers
        ):
            return None
        return req["to_workers"]

    def ack(self, to_workers: int, frontier: int) -> None:
        if self.root is None:
            return
        from pathway_tpu_torch.engine.persistence import write_handoff_ack

        write_handoff_ack(
            self.root, self.worker,
            incarnation=self.incarnation, to_workers=to_workers,
            frontier=frontier,
        )


class _PromoteWatcher:
    """Background watch for the supervisor's PROMOTE request.

    A promotion must interrupt survivors that are BLOCKED inside mesh
    collectives (worker 0 gathering from the dead peer, everyone else
    waiting on the epoch-go broadcast) — the epoch-boundary polling the
    handoff sentinel uses can never fire there.  So this tiny daemon
    thread polls ``lease/PROMOTE`` and, on a valid request for another
    worker of THIS incarnation that this process has not already acked,
    poisons the mesh: every blocked collective raises
    :class:`~pathway_tpu_torch.engine.comm.MeshPoisoned`, the run unwinds
    through its consistent drain-commit, and ``run()`` rejoins
    in-process.  One-shot per mesh lifetime."""

    _POLL_S = 0.05

    def __init__(self, root: str, worker: int, mesh: Any):
        self.root = root
        self.worker = worker
        self.mesh = mesh
        import threading as _threading

        self._stop = _threading.Event()
        self._thread = _threading.Thread(
            target=self._watch, name=f"promote-watch-{worker}", daemon=True
        )

    def start(self) -> "_PromoteWatcher":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    # pathway-lint: context=promote-watch
    def _watch(self) -> None:
        from pathway_tpu_torch.engine import persistence as pz

        incarnation = pz.writer_incarnation()
        while not self._stop.wait(self._POLL_S):
            try:
                req = pz.read_promote_request(self.root)
            except OSError:
                continue
            if (
                req is None
                or req["incarnation"] != incarnation
                or req["worker"] == self.worker
                or req["seq"] in _ACKED_PROMOTE_SEQS
            ):
                continue
            self.mesh.poison(
                f"promotion {req['seq']}: standby {req['standby']} is "
                f"adopting worker {req['worker']}"
            )
            return


def _handoff_exit(
    result,
    storage,
    sentinel,
    to_n: int,
    frontier: int,
    mesh=None,
) -> None:
    """The worker's half of a live handoff: drain-commit the EXACT
    current frontier (stamped ``handoff_to``), fence the storage so
    nothing later can move it, barrier with every peer (all-or-nothing —
    one dead peer fails the collective and the supervisor falls back),
    then ack and let the epoch loop break WITHOUT finishing the scope.

    The injected ``handoff_crash`` fault (SIGKILL after the fence commit,
    before the ack) lands between the commit and the barrier: exactly the
    window where a real mid-handoff death leaves a fenced-but-unacked
    root the restart fallback must absorb."""
    from pathway_tpu_torch.engine import faults as _faults
    from pathway_tpu_torch.engine import flight_recorder as _blackbox

    _blackbox.record(
        "handoff.begin", worker=sentinel.worker, to_workers=to_n,
        frontier=frontier,
    )
    if storage is not None:
        storage.fence_for_handoff(to_n)
        # synchronous drain: publishes every staged async generation in
        # order, then the handoff generation itself — the manifest the
        # successor topology's repartition replay reads
        storage.commit(processed_up_to=frontier)
    _faults.maybe_crash_handoff(worker=sentinel.worker, to_workers=to_n)
    if mesh is not None:
        # retire FIRST: peer departures during the barrier (and after it,
        # as everyone tears down) are the expected sound of a coordinated
        # exit, not a partition — but a peer that DIED mid-handoff still
        # fails the barrier with CommError, which is the point: the
        # handoff is all-or-nothing and the supervisor falls back
        mesh.retire()
        mesh.barrier(("handoff", to_n))
    sentinel.ack(to_n, frontier)
    result.handoff_to = to_n
    _blackbox.record(
        "handoff.acked", worker=sentinel.worker, to_workers=to_n,
    )


def _epoch_instruments():
    """(histogram, recorder) pair the epoch loops stamp each epoch with:
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
    storage: Any = None,
    prober: Any = None,
    telemetry: Any = None,
    beacon: Any = None,
    profiler: Any = None,
    freshness: Any = None,
    handoff: Any = None,
) -> None:
    if scope.worker is not None:
        return _event_loop_coordinated(
            scope, lowerer, result, max_epochs=max_epochs, storage=storage,
            prober=prober, telemetry=telemetry, beacon=beacon,
            profiler=profiler, freshness=freshness, handoff=handoff,
        )
    if beacon is None:
        beacon = _ProgressBeacon(None, 0)
    epoch_hist, blackbox = _epoch_instruments()
    inputs = _input_nodes(scope)
    pollers = lowerer.pollers
    wake = _attach_wake(pollers)
    last_time = -1
    drain_spins = 0  # consecutive idle drain epochs (quiesce guard)
    # snapshot_interval_ms=0 means "as often as possible" (reference
    # persistence/__init__.py:95-101); commit() no-ops when nothing advanced
    snapshot_interval = (
        (storage.snapshot_interval_ms / 1000.0) if storage is not None else None
    )
    last_snapshot = _time.monotonic()
    # (staged durability seq, marker frontiers at staging) awaiting publish
    pending_acks: deque = deque()
    while True:
        # liveness beacon: touched on EVERY loop iteration (idle included),
        # so its mtime proves the event loop schedules — a wedged epoch or
        # a deadlock stops it and the supervisor's watchdog takes over
        beacon.touch()
        beacon.report_load(lambda: _load_reading(freshness, result))
        if handoff is not None:
            to_n = handoff.poll()
            if to_n is not None:
                from pathway_tpu_torch.engine import serving as _serving

                # serving drain gates the rescale: the first sighting of
                # the handoff request stop-accepts (new requests get 503)
                # and the epoch loop KEEPS running so in-flight requests
                # complete — the sentinel re-returns to_n every poll, so
                # the fence fires on the first boundary where every
                # admitted request is answered (or the drain budget
                # lapses).  Zero in-flight HTTP requests are dropped.
                if _serving.ready_for_handoff():
                    # planned rescale (single supervised worker: the grow
                    # from 1 starts here too): drain, fence, ack, exit 0
                    _handoff_exit(result, storage, handoff, to_n, last_time)
                    break
        if (
            storage is not None
            and (_time.monotonic() - last_snapshot) >= snapshot_interval
        ):
            # non-blocking commit: chunk framing/hash/upload and the
            # manifest barrier run on the persistence writer pool while
            # this loop keeps computing epochs (engine/persistence.py);
            # the run's final commit (run()'s finally) drains the pipeline
            staged = storage.commit_async(processed_up_to=last_time)
            pending_acks.append((staged, _marker_frontiers(pollers)))
            last_snapshot = _time.monotonic()
        while (
            storage is not None
            and pending_acks
            and storage.published_seq >= pending_acks[0][0]
        ):
            # a staged snapshot became DURABLE (its generation manifest
            # published, or a confirmed no-op): sources whose rows are in
            # it may now commit their broker offsets — only up to the
            # marker frontier captured when it was staged, and never on
            # commit_async returning, which precedes durability
            _seq, frontiers = pending_acks.popleft()
            _ack_sources(pollers, persisted=True, marker_frontiers=frontiers)
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
            result.epoch_failed = True
            t0 = _time.perf_counter()
            span = (
                telemetry.epoch_span(t, result.epochs)
                if telemetry is not None
                else _nullcontext()
            )
            with span:
                scope.run_epoch(t)
            epoch_hist.observe((_time.perf_counter() - t0) * 1000.0)
            blackbox.record("epoch", time=t, index=result.epochs)
            result.epoch_failed = False
            drain_spins = 0
            last_time = t
            result.last_time = t
            result.epochs += 1
            if profiler is not None:
                # cadence-gated top-N attribution off the per-node step
                # timers run_epoch already maintains (engine/profiler.py)
                profiler.on_epoch(scope, result.epochs)
            if freshness is not None:
                # propagate the ingest low-watermark frontier and record
                # per-output delivery latency (engine/freshness.py)
                freshness.after_epoch(scope)
            # sources without input snapshots (no persistence, or UDF-cache-
            # only mode): the processed epoch is their durability boundary —
            # broker offsets may cover rows up to it, and no further
            _ack_sources(pollers, persisted=False, up_to_time=t)
            if prober is not None and prober.callbacks:
                prober.update(epochs=result.epochs)
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
            result.epoch_failed = True
            scope.run_epoch(last_time)
            result.epoch_failed = False
            result.last_time = last_time
            continue
        # idle streams still drain commit markers: a Kafka source's
        # timer-driven COMMITs keep arriving with no new epochs, and the
        # offsets for the last processed epoch must still reach the broker
        _ack_sources(pollers, persisted=False, up_to_time=last_time)
        # park until a reader signals new data (or the 1 ms cap): serving
        # queries wake the loop immediately instead of riding out the park
        wake.wait(0.001)
        wake.clear()
    scope.current_time = max(scope.current_time, last_time)
    if result.handoff_to is not None:
        # live handoff: the scope is NOT finished — no on_finish hooks, no
        # final flush; the run continues at the new topology from the
        # fenced frontier, and finishing here would emit end-of-stream
        # effects the successor would then replay on top of
        return
    scope.finish()
    result.clean_finish = True
    if prober is not None:
        prober.update(done=True, epochs=result.epochs)


# pathway-lint: context=epoch
def _event_loop_coordinated(
    scope: df.Scope,
    lowerer: Lowerer,
    result: RunResult,
    max_epochs: int | None = None,
    storage: Any = None,
    prober: Any = None,
    telemetry: Any = None,
    beacon: Any = None,
    profiler: Any = None,
    freshness: Any = None,
    handoff: Any = None,
) -> None:
    """Multi-worker BSP loop: worker 0 sequences epochs, every worker runs
    them in lockstep, exchanging rows at the declared exchange points.

    Mirrors the single-process loop; the extra steps are (a) epoch
    negotiation (the progress-gossip analog of timely frontiers over the
    cluster, SURVEY.md §2b) and (b) the post-ingest exchange that routes
    each staged row to the worker owning its key shard (dataflow.rs:1414).
    """
    ctx = scope.worker
    mesh = ctx.mesh
    if beacon is None:
        beacon = _ProgressBeacon(None, 0)
    epoch_hist, blackbox = _epoch_instruments()
    inputs = _input_nodes(scope)
    pollers = lowerer.pollers
    wake = _attach_wake(pollers)
    last_time = -1
    drain_spins = 0
    round_ = 0
    snapshot_interval = (
        (storage.snapshot_interval_ms / 1000.0) if storage is not None else None
    )
    last_snapshot = _time.monotonic()
    pending_acks: deque = deque()  # (staged seq, marker frontiers)
    while True:
        # event-loop liveness for the supervisor's watchdog (idle included)
        beacon.touch()
        beacon.report_load(lambda: _load_reading(freshness, result))
        if (
            storage is not None
            and (_time.monotonic() - last_snapshot) >= snapshot_interval
        ):
            # non-blocking: durability I/O overlaps the BSP epoch rounds
            staged = storage.commit_async(processed_up_to=last_time)
            pending_acks.append((staged, _marker_frontiers(pollers)))
            last_snapshot = _time.monotonic()
        while (
            storage is not None
            and pending_acks
            and storage.published_seq >= pending_acks[0][0]
        ):
            # broker offsets ack only once the staged snapshot is durable,
            # and only up to the marker frontier captured at staging
            _seq, frontiers = pending_acks.popleft()
            _ack_sources(pollers, persisted=True, marker_frontiers=frontiers)
        exhausted = True
        for poller in pollers:
            if not poller.poll():
                exhausted = False
        times: set[int] = set()
        for inp in inputs:
            times.update(inp.pending_times())
        local_min = min(times) if times else None
        all_finished = exhausted and all(inp.finished for inp in inputs)

        local_pending = any(n.has_pending() for n in scope.nodes)
        round_ += 1
        # the epoch-negotiation gather doubles as the mesh-wide freshness
        # aggregation path: each worker ships its worst output staleness,
        # worker 0 publishes the cluster maximum (one gauge, zero extra
        # collectives, as the traceparent broadcast)
        local_stale = (
            freshness.worst_staleness() if freshness is not None else None
        )
        gathered = mesh.gather(
            ("epoch", round_),
            (local_min, all_finished, local_pending, local_stale),
        )
        if mesh.worker_id == 0:
            if freshness is not None:
                freshness.record_mesh_staleness(
                    [s for _m, _f, _p, s in gathered]
                )
            mins = [m for m, _f, _p, _s in gathered if m is not None]
            handoff_to = handoff.poll() if handoff is not None else None
            if handoff_to is not None:
                from pathway_tpu_torch.engine import serving as _serving

                if not _serving.ready_for_handoff():
                    # serving drain in progress (worker 0 owns the REST
                    # ingress): stop-accept has begun, but in-flight
                    # requests still need epochs — defer the rescale
                    # decision; the sentinel re-returns to_n next round
                    handoff_to = None
            if handoff_to is not None:
                # planned rescale outranks everything: the fenced
                # frontier must be THIS epoch boundary, before any more
                # input folds in
                decision = ("handoff", handoff_to)
            elif mins:
                t = min(mins)
                if t <= last_time:
                    t = last_time + 2  # strictly increasing, even
                decision = ("epoch", t)
            elif any(p for _m, _f, p, _s in gathered):
                # boundary-produced deltas (error logs, buffer releases)
                # drain in lockstep on every worker
                drain_spins += 1
                if drain_spins > 1000:
                    decision = ("stop", None)  # non-quiescing node; bail
                else:
                    decision = ("drain", last_time + 2)
            elif all(fin for _m, fin, _p, _s in gathered):
                decision = ("stop", None)
            else:
                decision = ("idle", None)
        else:
            decision = None
        kind, t = mesh.bcast(("epoch-go", round_), decision)

        if kind == "handoff":
            # every worker exits through the coordinated drain: commit
            # the exact frontier (stamped handoff_to), fence, barrier
            # (all-or-nothing), ack, and leave the loop WITHOUT finishing
            # the scope — the supervisor relaunches at the new topology
            _handoff_exit(
                result, storage, handoff, t, last_time, mesh=mesh
            )
            break
        if kind == "stop":
            break
        if kind == "drain":
            # boundary-delta drain: run the epoch but do NOT reset the
            # quiesce counter (only real input epochs prove progress)
            result.epoch_failed = True
            scope.run_epoch(t)
            result.epoch_failed = False
            last_time = t
            result.last_time = t
            continue
        if kind == "idle":
            _ack_sources(pollers, persisted=False, up_to_time=last_time)
            wake.wait(0.001)
            wake.clear()
            continue
        for inp in inputs:
            inp.merge_staged_through(t)
        # route each staged row to the worker owning its key shard; a
        # non-partitioned source read on worker 0 scatters here
        for inp in inputs:
            staged = inp.take_staged(t, [])
            merged = ctx.exchange_deltas(("in", inp.id, t), staged, None)
            if merged:
                inp.put_staged(t, merged)
            inp.emit_time(t)
        result.epoch_failed = True
        t0 = _time.perf_counter()
        span = (
            telemetry.epoch_span(t, result.epochs)
            if telemetry is not None
            else _nullcontext()
        )
        with span:
            scope.run_epoch(t)
        epoch_hist.observe((_time.perf_counter() - t0) * 1000.0)
        blackbox.record(
            "epoch", time=t, index=result.epochs, worker=mesh.worker_id
        )
        result.epoch_failed = False
        drain_spins = 0  # an input-driven epoch proves progress
        last_time = t
        result.last_time = t
        result.epochs += 1
        if profiler is not None:
            profiler.on_epoch(scope, result.epochs)
        if freshness is not None:
            freshness.after_epoch(scope)
        _ack_sources(pollers, persisted=False, up_to_time=t)
        if prober is not None and prober.callbacks:
            prober.update(epochs=result.epochs)
        if max_epochs is not None and result.epochs >= max_epochs:
            break
    scope.current_time = max(scope.current_time, last_time)
    if result.handoff_to is not None:
        return  # live handoff: see the solo loop's exit note
    scope.finish()
    result.clean_finish = True
    if prober is not None:
        prober.update(done=True, epochs=result.epochs)


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
