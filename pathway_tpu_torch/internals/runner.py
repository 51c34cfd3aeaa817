"""Graph runner: lowers registered sinks and drives the engine event loop.

Parity target: ``python/pathway/internals/graph_runner/__init__.py``
(the tree-shake → lower → ``run_with_new_graph`` path, §3.1 of SURVEY.md) and
the worker event loop of ``src/engine/dataflow.rs:6051-6104`` (probers →
flushers → pollers → step).  Single-process form: the epoch loop polls
connector queues, picks the next commit timestamp across all input sessions,
and runs one consolidated pass of the operator DAG per epoch.

The single-worker part of ``pathway_tpu/internals/runner.py``: ``run``,
``run_all``, the solo ``_event_loop`` and ``run_pipeline_to_completion``,
with the same epoch choice and the same finish, and the storage path of
one worker: ``persistence_config`` (or ``PATHWAY_REPLAY_STORAGE``) builds
a ``PersistentStorage``, the epoch loop commits it asynchronously and
acks sources as generations publish, and the run's end drains and
commits it.  What the port takes in later slices raises
``NotImplementedError`` naming that slice instead of being ignored:
several processes and warm standbys (H4b), and the monitoring HTTP server
and console dashboard (H5).  Telemetry, the prober, the license check and
the flight recorder's dump suppliers arrive with H5 as well; the epoch
histogram and the flight-recorder ring are the port's own
(``engine/metrics.py``, ``engine/flight_recorder.py``).
"""

from __future__ import annotations

import os
import time as _time
from collections import deque
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


def _refuse_later_slices(*, with_http_server: bool, monitoring_level: Any) -> None:
    """Raise for every ``pw.run`` feature whose slice the port lacks."""
    from pathway_tpu_torch.internals.config import worker_topology

    if worker_topology().processes > 1:
        raise NotImplementedError(
            "more than one process (PATHWAY_PROCESSES > 1) needs the TCP mesh "
            "of engine/comm.py, which the port brings in slice H4b"
        )
    if os.environ.get("PATHWAY_STANDBY_ID") is not None:
        raise NotImplementedError(
            "standby mode and promotion (PATHWAY_STANDBY_ID) need "
            "engine/standby.py, which the port brings in slice H4b"
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
    _refuse_later_slices(with_http_server=with_http_server, monitoring_level=monitoring_level)
    from pathway_tpu_torch.engine import flight_recorder as _blackbox

    scope = df.Scope()
    scope.terminate_on_error = terminate_on_error
    lowerer = Lowerer(scope)
    # pw.run(debug=True): connectors with debug_data= lower to static
    # tables of that data (reference operator_handler.py:110)
    lowerer.debug_mode = debug
    storage = _make_storage(persistence_config)
    if storage is not None:
        lowerer.persistence_storage = storage

    # lower all sinks (tree-shaking is implicit: only sink cones are built)
    for _name, table, attach in (list(G.sinks) if _sinks is None else _sinks):
        node = lowerer.node(table)
        attach(lowerer, node)

    # append-only analysis must run before any state is restored or stepped:
    # GroupByNode picks its accumulator variant off the inferred flags
    df.infer_append_only(scope)

    result = RunResult()
    if storage is not None and storage.operator_persistence:
        _wire_operator_persistence(scope, storage)
    root_token = None
    _blackbox.record("run.start", worker=0, workers=1)
    try:
        if storage is not None:
            from pathway_tpu_torch.engine import faults as _faults
            from pathway_tpu_torch.engine import persistence as pz

            base_backend = storage.backend
            if isinstance(base_backend, _faults.FlakyBackend):
                base_backend = base_backend.inner  # fault wrapper is I/O-only
            if isinstance(base_backend, pz.FileBackend):
                # UDF DiskCache shares the persistence root for this run
                # only; acquired inside the try so any failure below still
                # releases it in the finally
                root_token = pz.acquire_active_root(base_backend.root)
        try:
            _event_loop(scope, lowerer, result, max_epochs=max_epochs, storage=storage)
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
    storage: Any = None,
) -> None:
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
            scope.run_epoch(t)
            epoch_hist.observe((_time.perf_counter() - t0) * 1000.0)
            blackbox.record("epoch", time=t, index=result.epochs)
            result.epoch_failed = False
            drain_spins = 0
            last_time = t
            result.last_time = t
            result.epochs += 1
            # sources without input snapshots (no persistence, or UDF-cache-
            # only mode): the processed epoch is their durability boundary —
            # broker offsets may cover rows up to it, and no further
            _ack_sources(pollers, persisted=False, up_to_time=t)
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
        # idle streams still drain commit markers: a source's timer-driven
        # COMMITs keep arriving with no new epochs, and the offsets for the
        # last processed epoch must still reach the broker
        _ack_sources(pollers, persisted=False, up_to_time=last_time)
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
