"""Connector plumbing shared by io modules.

A copy of ``pathway_tpu/io/_utils.py`` (parity target: the reader-thread
→ mpsc → poller pattern of ``src/connectors/mod.rs:91-332`` and the parser
layer of ``src/connectors/data_format.rs``).  A source module provides a
``Reader`` (iterator of parsed row dicts run on a thread); rows flow
through a thread-safe queue into an engine ``InputNode``; the runner's
event loop calls ``poll`` each iteration and commits an epoch per
``autocommit_duration_ms``.

The persistence hooks are the JAX package's: a source under a persistence
config registers with the run's storage, replays its committed snapshot,
seeks its reader past the committed offset and logs what it stages
(input snapshots), or closes epochs only at its offset markers (operator
snapshots).  REST rows carry ``DEADLINE_TS``/``TRACE_STAMP``: a row whose
deadline lapsed in the queue is never staged (``serving.shed_staged``
answers its client 504), and a staged one records a ``serve.stage`` span
on its request's trace.  Under several workers a source
is split by ``Reader.partition``: file scanners stride the sorted file
list, and other sources are read on worker 0 and scattered by the
exchange; auto-generated keys are salted by worker, and snapshot ids carry
``-w{id}``.  The connector fault kinds (``connector_read``,
``connector_stall``, ``load_spike``) fire in the reader's supervision loop.

One addition to the JAX package: a row that carries ``FILE_ROW`` (a file
reader's ``(path, index)``) can later be retracted by a ``DELETE`` row
with the same tag, so a deleted or rewritten file takes its old rows
back (see ``_file_readers.FileReader``).  Under input snapshots the
retraction is logged like any row.
"""

from __future__ import annotations

import queue
import threading
import time as _time
from collections import deque
from typing import Any, Callable, Iterable, Mapping

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.engine.types import (
    KEY_MASK,
    Json,
    hash_values,
    sequential_key,
    sequential_keys,
)
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Lowerer, Table, Universe

COMMIT = object()  # sentinel: force an epoch boundary
FINISH = object()  # sentinel: source exhausted
DELETE = "_pw_delete"  # row dict flag for deletions / upserts
# row dict field: monotonic deadline stamp (engine/serving.py) — a row
# whose deadline lapsed while queued is DROPPED at staging (its waiting
# client is answered 504 immediately) instead of burning an epoch
DEADLINE_TS = "_pw_deadline_ts"
# row dict field: W3C traceparent of the request that emitted this row
# (engine/tracing.py) — staging records a child span on the request's
# trace so connector queue time is attributable per request
TRACE_STAMP = "_pw_trace"
# row dict field: a file reader's (path, index) of the row; a DELETE row
# with the same tag retracts the row staged under it (the port's own)
FILE_ROW = "_pw_file_row"


class RawRows:
    """Bulk-ingest batch: value tuples already coerced to the source schema
    (in schema order).  Readers emit one of these instead of per-row dicts
    when they can vector-parse a whole file (e.g. the pandas CSV path).
    ``tags``, one ``FILE_ROW`` tag per row, lets a later retraction take
    the rows back."""

    __slots__ = ("rows", "tags")

    def __init__(self, rows: list, tags: list | None = None):
        self.rows = rows
        self.tags = tags


class Offset:
    """Reader frontier marker: everything emitted before this message is
    covered by ``value`` (the offset-antichain analog, persistence/frontier.rs).
    Must be JSON-able or picklable."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value


class Reader:
    """Runs on its own thread; yields row dicts / COMMIT / FINISH / Offset.

    Readers that manage their own offset frontier (e.g. file scanners) set
    ``supports_offsets = True``, emit ``Offset`` markers, and implement
    ``seek``.  Readers whose *external system* resumes past consumed data on
    its own (Kafka consumer groups) set ``external_resume = True`` — they get
    neither snapshot-replay skipping nor row counting.  Others get a generic
    emitted-row-count frontier (the PythonReader strategy, data_storage.rs:806).

    ``max_allowed_consecutive_errors`` is the transient-failure budget
    (parity: ``Reader::max_allowed_consecutive_errors``
    data_storage.rs:481, enforced by the read loop mod.rs:294-332): a
    failed ``run`` is restarted with backoff while the consecutive-failure
    count stays within the budget; any successfully emitted item resets
    the count.  Past the budget the pipeline fails cleanly (the poller
    re-raises on the engine thread).  The default 0 means the first error
    is fatal, as in the reference; brokered sources (Kafka/NATS) override.
    """

    supports_offsets = False
    external_resume = False
    max_allowed_consecutive_errors = 0

    def run(self, emit: Callable[[Any], None]) -> None:
        raise NotImplementedError

    def seek(self, offset: Any) -> None:  # persistence hook
        pass

    def partition(self, worker_id: int, worker_count: int) -> "Reader | None":
        """Multi-worker split of this source.  Partitionable readers (file
        scanners stride the sorted file list, Kafka takes partitions by
        ``partition % worker_count``) override this; the default is the
        reference's rule for non-partitioned sources — read everything on
        one worker, the post-ingest exchange scatters the rows
        (docs/.../10.worker-architecture.md:40-42, dataflow.rs:1414-1437).
        Returning ``None`` means this worker reads nothing.

        Contract (pinned by ``tests/test_rescale_repartition.py``): the
        call must be IDEMPOTENT under re-partitioning — calling it again
        with a different ``(worker_id, worker_count)`` (an elastic rescale
        re-striping the source) must leave exactly the new stripe active,
        never a union or intersection with the old one, so rescaled
        readers neither drop nor double-read paths/partitions.  Progress
        state (``seek`` frontiers) must be stripe-independent: a rescaled
        reader may be seeked to a frontier MERGED from several old
        workers, and must resume each path/partition it now owns from the
        recorded position while simply ignoring entries outside its
        stripe."""
        return self if worker_id == 0 else None


class ReaderFailed:
    """Queue sentinel: the reader exhausted its consecutive-error budget.
    The poller re-raises on the engine thread so ``pw.run`` fails cleanly
    (the ``error_reporter.report(ReaderFailed)`` path of mod.rs:319)."""

    __slots__ = ("exc", "consecutive")

    def __init__(self, exc: BaseException, consecutive: int):
        self.exc = exc
        self.consecutive = consecutive


class _ReadProgress:
    """Emit wrapper for the supervision loop: records that the reader made
    progress since its last failure (any item — the reference resets
    ``consecutive_errors`` on every successful ``read()``) and remembers the
    newest ``Offset`` so a restart of an offset-aware reader can re-``seek``."""

    __slots__ = ("put", "progressed", "last_offset")

    def __init__(self, put: Callable[[Any], None]):
        self.put = put
        self.progressed = False
        self.last_offset: Any = None

    def __call__(self, item: Any) -> None:
        self.progressed = True
        if isinstance(item, Offset):
            self.last_offset = item.value
        self.put(item)


class _RowCountEmit:
    """Wraps the queue put: counts data rows, skips the first ``skip`` after a
    resume, and stamps a row-count Offset at every commit."""

    __slots__ = ("put", "count", "skip")

    def __init__(self, put: Callable[[Any], None], skip: int):
        self.put = put
        self.count = 0
        self.skip = skip

    def __call__(self, item: Any) -> None:
        if item is COMMIT or item is FINISH:
            # never regress below the persisted frontier: a resumed
            # nondeterministic source may emit fewer rows than last run,
            # but the committed chunks already cover `skip` rows
            self.put(Offset({"rows": max(self.count, self.skip)}))
            self.put(item)
            return
        if isinstance(item, Offset):
            self.put(item)
            return
        self.count += 1
        if self.count <= self.skip:
            return
        self.put(item)


def make_payload_formatter(
    names: list[str],
    format: str,
    *,
    delimiter: str = ",",
    value=None,
    sink: str = "write",
):
    """Shared message-framing for broker sinks (kafka/nats write).

    Returns ``payload_of(row, time, diff) -> bytes`` for json/dsv/raw/
    plaintext formats; ``value=`` selects the payload column for the raw
    forms, otherwise a single-column table is required (checked eagerly).
    """
    value_idx = None
    if value is not None:
        vn = getattr(value, "name", value)
        if vn not in names:
            raise ValueError(f"{sink} value= column {vn!r} not in table")
        value_idx = names.index(vn)
    if value_idx is None and format in ("raw", "plaintext") and len(names) != 1:
        raise ValueError(
            f"{sink} format={format!r} needs value= or a single-column table"
        )

    def as_bytes(v) -> bytes:
        if isinstance(v, bytes):
            return v
        return str(plain_value(v)).encode()

    def payload_of(row, time, diff) -> bytes:
        if format in ("raw", "plaintext"):
            return as_bytes(row[value_idx if value_idx is not None else 0])
        if format == "dsv":
            vals = [str(plain_value(v)) for v in row] + [str(time), str(diff)]
            return delimiter.join(vals).encode()
        import json as _json

        obj = {n: plain_value(v) for n, v in zip(names, row)}
        obj["time"], obj["diff"] = time, diff
        return _json.dumps(obj).encode()

    return payload_of


class CommitThrottle:
    """``min_commit_frequency`` gate for lake sinks: at most one commit per
    interval (ms); ``force`` (end of stream) always passes.  None = every
    flush commits."""

    __slots__ = ("interval_ms", "_last")

    def __init__(self, interval_ms: int | None):
        self.interval_ms = interval_ms
        self._last = 0.0

    def ready(self, force: bool = False) -> bool:
        if force or self.interval_ms is None:
            self._last = _time.monotonic()
            return True
        now = _time.monotonic()
        if (now - self._last) * 1000.0 < self.interval_ms:
            return False
        self._last = now
        return True


def with_metadata_schema(schema: type[schema_mod.Schema]) -> type[schema_mod.Schema]:
    """Append the ``_metadata`` Json column (with_metadata=True readers)."""
    cols = dict(schema.__columns__)
    cols["_metadata"] = schema_mod.ColumnSchema(name="_metadata", dtype=dt.JSON)
    return schema_mod.schema_from_columns(cols)


class _WakingQueue(queue.Queue):
    """queue.Queue whose put also signals the owning runner's idle wait.

    ``wake`` is a PER-RUN event the runner attaches before its loop (a
    process-wide signal would turn one run's park into a busy spin while
    another run streams); until attached, puts are plain puts.
    """

    wake: "threading.Event | None" = None

    def put(self, item, block=True, timeout=None):  # noqa: A003
        super().put(item, block, timeout)
        w = self.wake
        if w is not None:
            w.set()


class _QueuePoller:
    """Moves queued rows into the InputNode; stamps commit times.

    One poller per source, mirroring StartedConnectorState (mod.rs:71).
    """

    def __init__(
        self,
        input_node: df.InputNode,
        schema: type[schema_mod.Schema],
        autocommit_duration_ms: int | None,
    ):
        self.q: queue.Queue = _WakingQueue()
        self.input_node = input_node
        self.names = list(schema.__columns__.keys())
        self.dtypes = [schema.__columns__[n].dtype for n in self.names]
        self.pk = schema.primary_key_columns()
        self.autocommit = (autocommit_duration_ms or 1500) / 1000.0
        # auto-key counter: base salts multi-worker streams apart; the
        # running count persists per source so resumed runs continue the
        # sequence (fresh rows must never reuse keys already inside
        # replayed snapshots / restored operator state)
        self._seq_base = 0
        self._auto_seq = 0
        self._time = 2
        self._staged = False
        self._last_commit = _time.monotonic()
        self.finished = False
        self.reader: Reader | None = None
        self.name = "source"  # monitoring label, set by make_input_table
        self.persist_state: Any = None  # engine.persistence.SourceState
        # external-resume sources emit no Offset markers; their chunks flush
        # at commit boundaries instead (offset frontier stays None)
        self.flush_on_commit = False
        self._drained_commits = 0  # COMMIT sentinels this poller has consumed
        # (marker seq, epoch time its rows were stamped with) awaiting the
        # engine's durability point; popped by ack_processed
        self._commit_markers: deque[tuple[int, int]] = deque()
        # FILE_ROW tag -> (key, row) of the rows a later retraction of the
        # same tag takes back
        self._file_rows: dict[Any, tuple[int, tuple]] = {}

    def _bulk_insert(self, rows: list, tags: list | None = None) -> None:
        """Stage a RawRows batch: values are already coerced to the schema
        dtypes and in schema order, so the per-row dict/coerce layers are
        skipped (the bulk-ingest fast path of file sources)."""
        pk_idx = (
            [self.names.index(c) for c in self.pk] if self.pk else None
        )
        ins = self.input_node.insert
        t = self._time
        log = (
            self.persist_state.log
            if self.persist_state is not None
            and not self.persist_state.operator_mode
            else None
        )
        if pk_idx is None:
            n = self._auto_seq
            keys = sequential_keys(self._seq_base + n, len(rows))
            self._auto_seq = n + len(rows)
            if self.persist_state is not None:
                self.persist_state.key_seq = self._auto_seq
        else:
            keys = [hash_values([vrow[i] for i in pk_idx]) for vrow in rows]
        for key, vrow in zip(keys, rows):
            ins(key, vrow, t, 1)
            if log is not None:
                log.record(key, vrow, 1)
        if tags is not None:
            for tag, key, vrow in zip(tags, keys, rows):
                self._file_rows[tag] = (key, vrow)
        if rows:
            self._staged = True

    def _key_of(self, values: list, row: Mapping) -> int:
        if "_pw_key" in row:
            k = row["_pw_key"]
            # normalize into the 128-bit key space (value.rs Key is u128) so
            # live keys and snapshot-replayed keys agree
            return (k & KEY_MASK) if isinstance(k, int) else hash_values([k])
        if self.pk:
            return hash_values([values[self.names.index(c)] for c in self.pk])
        n = self._auto_seq
        self._auto_seq = n + 1
        if self.persist_state is not None:
            self.persist_state.key_seq = self._auto_seq
        return sequential_key(self._seq_base + n)

    def poll(self) -> bool:
        if self.finished:
            return True
        drained = 0
        while drained < 100_000:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                break
            drained += 1
            if isinstance(item, ReaderFailed):
                self.finished = True
                self.input_node.close()
                raise df.EngineError(
                    f"connector reader failed after {item.consecutive} "
                    f"consecutive errors (budget "
                    f"{item.consecutive - 1}): {item.exc!r}"
                ) from item.exc
            if item is FINISH:
                if self._staged:
                    self._time += 2
                self.input_node.close()
                self.finished = True
                return True
            if item is COMMIT:
                self._drained_commits += 1
                # rows covered by this marker were stamped with the epoch
                # being closed (or an already-closed one if nothing staged);
                # the marker may be acked once that epoch is durable.  The
                # snapshot buffer must flush BEFORE the marker exists, even
                # when the autocommit timer already closed the epoch —
                # otherwise a snapshot commit could ack broker offsets for
                # rows still sitting in the unflushed buffer
                if self.flush_on_commit and self.persist_state is not None:
                    self.persist_state.log.flush_chunk()
                marker_time = self._time if self._staged else self._time - 2
                self._commit_markers.append((self._drained_commits, marker_time))
                if self._staged:
                    self._time += 2
                    self._staged = False
                    self._last_commit = _time.monotonic()
                continue
            if isinstance(item, Offset):
                # snapshot chunks flush exactly at offset markers so the
                # committed (chunks, offset) pair always refers to the same
                # row prefix — the consistency rule tracker.rs enforces with
                # its offset antichains
                if self.persist_state is not None:
                    if self.persist_state.operator_mode:
                        # operator snapshots cover processed epochs only:
                        # stamp the offset with the epoch its rows were
                        # staged into so commit() can gate on it
                        marker_time = self._time if self._staged else self._time - 2
                        self.persist_state.pending_offsets.append(
                            (item.value, marker_time)
                        )
                    else:
                        self.persist_state.pending_offset = item.value
                        self.persist_state.log.flush_chunk()
                continue
            if isinstance(item, RawRows):
                self._bulk_insert(item.rows, item.tags)
                continue
            row = item
            diff = -1 if row.get(DELETE) else 1
            ddl = row.get(DEADLINE_TS)
            if ddl is not None and diff > 0 and "_pw_key" in row and _time.monotonic() >= ddl:
                # serving shed-before-work: the request's deadline lapsed
                # while the row sat in the connector queue — never stage
                # it; 504 the waiting client now (engine/serving.py)
                from pathway_tpu_torch.engine import serving as _serving

                k = row["_pw_key"]
                _serving.shed_staged((k & KEY_MASK) if isinstance(k, int) else hash_values([k]))
                continue
            tag = row.get(FILE_ROW)
            if tag is not None and diff < 0:
                held = self._file_rows.pop(tag, None)
                if held is not None:
                    self.input_node.insert(held[0], held[1], self._time, -1)
                    if self.persist_state is not None and not self.persist_state.operator_mode:
                        self.persist_state.log.record(held[0], held[1], -1)
                    self._staged = True
                continue
            values = [
                dt.coerce(row.get(n), d) for n, d in zip(self.names, self.dtypes)
            ]
            key = self._key_of(values, row)
            vrow = tuple(values)
            self.input_node.insert(key, vrow, self._time, diff)
            tp = row.get(TRACE_STAMP)
            if tp is not None:
                from pathway_tpu_torch.engine import tracing as _tracing

                tr = _tracing.active_trace(tp)
                if tr is not None:
                    tr.add_span("serve.stage", _time.time(), 0.0, epoch=self._time)
            if self.persist_state is not None and not self.persist_state.operator_mode:
                self.persist_state.log.record(key, vrow, diff)
            if tag is not None:
                self._file_rows[tag] = (key, vrow)
            self._staged = True
        if self._staged and (_time.monotonic() - self._last_commit) >= self.autocommit:
            # operator-persisting sources close epochs only at COMMIT/Offset
            # markers: a timer-closed epoch could be processed and dumped
            # into an operator snapshot before its offset marker arrives,
            # and the committed offset would lag the snapshot (re-ingestion
            # on resume).  Marker-aligned epochs make snapshot and offset
            # frontiers agree by construction.
            if not (
                self.persist_state is not None and self.persist_state.operator_mode
            ):
                self._time += 2
                self._staged = False
                self._last_commit = _time.monotonic()
                if self.flush_on_commit and self.persist_state is not None:
                    self.persist_state.log.flush_chunk()
        return False

    def marker_frontier(self) -> int:
        """Highest COMMIT-marker sequence drained so far.  The runner
        captures this when it STAGES an async snapshot: only markers below
        the captured frontier are covered by that snapshot, so the ack
        that follows its publication must stop there (markers drained
        while the publish was in flight belong to a later snapshot)."""
        return self._drained_commits

    def ack_processed(
        self,
        up_to_time: int | None = None,
        *,
        up_to_marker: int | None = None,
    ) -> None:
        """Durability point reached: let the reader commit its external
        offsets (on its own thread) for every COMMIT marker whose rows are
        covered.  ``up_to_time`` — the epoch the engine just processed —
        gates markers for non-persisted sources (rows staged for a later
        epoch are still in memory only); ``up_to_marker`` gates on the
        marker frontier a published snapshot actually covers (see
        :meth:`marker_frontier`); ``None`` for both means all drained
        markers are durable.  The reader commits the offsets it captured
        at the marker — never its live position, which may already cover
        unprocessed rows."""
        request = getattr(self.reader, "request_offset_commit", None)
        if request is None or not self._commit_markers:
            return
        seq = None
        while self._commit_markers and (
            (up_to_time is None or self._commit_markers[0][1] <= up_to_time)
            and (
                up_to_marker is None
                or self._commit_markers[0][0] <= up_to_marker
            )
        ):
            seq = self._commit_markers.popleft()[0]
        if seq is not None:
            request(seq)


def debug_rows(debug_data: Any, schema: type[schema_mod.Schema]) -> list[dict]:
    """Normalize ``debug_data`` (pandas DataFrame or iterable of row
    dicts) to row dicts (reference: datasource.debug_datasource + the
    debug branch of operator_handler.py:110 — static data replaces the
    source under ``pw.run(debug=True)``)."""
    if debug_data is None:
        return []
    if hasattr(debug_data, "to_dict"):  # pandas DataFrame
        return list(debug_data.to_dict(orient="records"))
    if isinstance(debug_data, (str, bytes)):
        raise TypeError(
            "debug_data must be a pandas DataFrame or an iterable of row "
            "dicts; for markdown tables use "
            "pw.debug.table_from_markdown(...) and pass its rows"
        )
    return [dict(r) for r in debug_data]


def make_input_table(
    schema: type[schema_mod.Schema],
    reader_factory: Callable[[], Reader],
    *,
    autocommit_duration_ms: int | None = 1500,
    upsert: bool = False,
    name: str | None = None,
    debug_data: Any = None,
) -> Table:
    """Build a Table backed by a threaded reader (one thread per run)."""

    def build(lowerer: Lowerer) -> df.Node:
        if debug_data is not None and getattr(lowerer, "debug_mode", False):
            # pw.run(debug=True): static debug rows replace the live source
            static = make_static_input_table(schema, debug_rows(debug_data, schema))
            return lowerer.node(static)
        node = df.InputNode(lowerer.scope)
        node.upsert = upsert
        if upsert:
            node.require_state()
        # a declared append-only schema turns on the engine's no-retraction
        # operator variants downstream and rejects deletions at the input
        node.declared_append_only = schema_mod.is_append_only(schema)
        poller = _QueuePoller(node, schema, autocommit_duration_ms)
        worker = getattr(lowerer.scope, "worker", None)
        reader = reader_factory()
        # per-connector monitoring identity (connectors/monitoring.rs)
        poller.name = name or type(reader).__name__.lstrip("_")

        # persistence identity FIRST: the source counter advances for
        # every source on every worker — workers whose reader partitions
        # to nothing included — so unnamed sources keep the same base id
        # across workers and across topology rescales (the repartition
        # resume matches old and new logs by this BASE name)
        storage = getattr(lowerer, "persistence_storage", None)
        if storage is not None and not storage.input_snapshots_enabled:
            storage = None  # UDF-caching-only mode: no input snapshots
        sid = None
        base_sid = None
        if storage is not None:
            counter = getattr(lowerer, "_source_counter", 0)
            lowerer._source_counter = counter + 1
            base_sid = sid = name or f"source_{counter}"
            if worker is not None and worker.worker_count > 1:
                # worker-sharded snapshot files (tracker.rs worker sharding)
                sid = f"{sid}-w{worker.worker_id}"
        if worker is not None and worker.worker_count > 1:
            reader = reader.partition(worker.worker_id, worker.worker_count)
            # salt autogenerated row keys by worker so striped partitions
            # never collide in the shared 128-bit key space
            poller._seq_base = worker.worker_id << 64
        if reader is None and (
            sid is None or not storage.has_repartition_state(sid, base_sid)
        ):
            node.close()  # this worker owns no slice of the source
            return node
        poller.reader = reader


        # persistence: replay committed snapshot, seek reader past it
        skip_rows = 0
        if storage is not None:
            state = storage.register_source(
                sid, schema_digest=schema_digest(schema), base=base_sid
            )
            access = getattr(storage, "snapshot_access", None)
            if access != "record":
                storage.replay_into(
                    state, lambda k, r, d: node.insert(k, r, 0, d)
                )
            if reader is None:
                # refs-only worker (elastic rescale): this worker owns no
                # reader slice, but it DOES own a shard of the replayed
                # state — the rows just staged above — and its registration
                # keeps the refs committed in every future manifest.  No
                # reader thread, no poller: the staged epoch drains like a
                # static source's.  The merged offset frontier belongs to
                # whichever worker actually READS the source; committing it
                # here too would hand a later rescale duplicate frontiers
                # for one base source.
                state.offset = None
                state.pending_offset = None
                node.close()
                return node
            if access == "replay" and not getattr(
                storage, "continue_after_replay", True
            ):
                # pure replay: the recording is the whole input — no
                # reader thread, no live data (reference ReplayMode)
                node.close()
                return node
            if reader.external_resume and getattr(
                storage, "rejected_generations", None
            ):
                # broker-side offsets (Kafka consumer groups, ...) were
                # committed for generations that integrity verification
                # just rejected: the broker will never re-deliver the rows
                # between the verified generation and its own offset, so
                # resuming here would silently LOSE them.  Fail loudly.
                from pathway_tpu_torch.engine.persistence import CheckpointError

                raise CheckpointError(
                    f"persistence: source {sid!r} resumes from broker-side "
                    "offsets, but checkpoint recovery fell back past "
                    "damaged generation(s) "
                    f"{[g for g, _ in storage.rejected_generations]} — the "
                    "broker's committed offset may be ahead of the verified "
                    "checkpoint and the gap would be lost. Repair the root "
                    "(see `python -m pathway_tpu_torch.cli scrub`), or rewind "
                    "the consumer group / clear the persistence directory to "
                    "re-ingest."
                )
            poller.persist_state = state
            poller._auto_seq = state.key_seq
            if state.offset is not None:
                if reader.supports_offsets:
                    reader.seek(state.offset)
                elif not reader.external_resume:
                    skip_rows = int(state.offset.get("rows", 0))

        poller.flush_on_commit = reader.external_resume
        if reader.supports_offsets or reader.external_resume:
            emit = poller.q.put
        else:
            emit = _RowCountEmit(poller.q.put, skip_rows)

        def target():
            # supervision with a consecutive-error budget (parity:
            # read_realtime_updates, mod.rs:294-332): a failing reader is
            # restarted with backoff until `max_allowed_consecutive_errors`
            # failures in a row, then the pipeline fails cleanly via the
            # ReaderFailed sentinel.  Every exit path terminates the queue
            # (the old try/finally emit(FINISH) guarantee).
            tracker = _ReadProgress(emit)
            done = False
            try:
                if _supervise(reader, tracker):
                    emit(FINISH)  # via the wrapper: stamps the final offset
                else:
                    poller.q.put(FINISH)  # failure path: no offset stamp
                done = True
            except BaseException as exc:  # SystemExit/KeyboardInterrupt:
                # a non-Exception escape must FAIL the pipeline, not let it
                # complete as if the source drained
                poller.q.put(ReaderFailed(exc, 1))
                raise
            finally:
                if not done:
                    poller.q.put(FINISH)

        def _supervise(reader, tracker) -> bool:
            """True = source drained cleanly; False = budget exhausted
            (ReaderFailed already queued).  Progress (any emitted item)
            resets the count, like the reference's per-read() reset."""
            import logging

            from pathway_tpu_torch.engine import faults as _faults

            log = logging.getLogger("pathway_tpu_torch.io")
            # connector-read fault injection (PATHWAY_FAULT_PLAN): the Nth
            # emitted item raises before enqueue, exercising this very
            # supervision loop's budget + restart/reseek path
            emit_fn = tracker
            # load_spike buffering state: while "until" is set, emitted
            # items accumulate in "buf" and flush as one burst when the
            # window lapses — downstream sees silence, then a wall
            spike_state: dict = {"until": None, "buf": []}

            def _flush_spike(wait: bool = False) -> None:
                until = spike_state["until"]
                if until is None:
                    return
                if wait:
                    # the source drained mid-window: honor the declared
                    # silence before the burst, or the spike would shrink
                    # to however much input happened to remain
                    while _time.monotonic() < until:
                        _time.sleep(0.02)  # interruptible pacing
                spike_state["until"] = None
                buffered, spike_state["buf"] = spike_state["buf"], []
                for held in buffered:
                    tracker(held)

            fault_plan = _faults.active_plan()
            if fault_plan is not None and fault_plan.has(
                "connector_read", "connector_stall", "load_spike"
            ):
                source_name = type(reader).__name__

                def emit_fn(item, _tracker=tracker):
                    if spike_state["until"] is not None:
                        if _time.monotonic() < spike_state["until"]:
                            spike_state["buf"].append(item)
                            return
                        _flush_spike()  # window over: burst, then continue
                    if fault_plan.check("connector_read", source=source_name):
                        raise _faults.InjectedFault(
                            f"injected connector_read failure in {source_name}"
                        )
                    stall = fault_plan.check(
                        "connector_stall", source=source_name
                    )
                    if stall is not None:
                        # a stuck upstream: the item arrives LATE, nothing
                        # errors, no epoch slows — only output.staleness.s
                        # (engine/freshness.py) can see this happen.  The
                        # delay is honored exactly as declared (a spec
                        # without delay_ms stalls 0 ms, i.e. not at all)
                        deadline = _time.monotonic() + stall.delay_ms / 1000.0
                        while _time.monotonic() < deadline:
                            _time.sleep(0.02)  # interruptible pacing
                    spike = fault_plan.check("load_spike", source=source_name)
                    if spike is not None:
                        # deterministic load wave: buffer this and every
                        # following item for delay_ms, then flush them as
                        # one instantaneous burst.  No error, no reorder —
                        # delivered rows stay byte-identical; only
                        # staleness/backlog (and the autoscaler watching
                        # them) can tell it happened
                        spike_state["until"] = (
                            _time.monotonic() + spike.delay_ms / 1000.0
                        )
                        spike_state["buf"].append(item)
                        return
                    _tracker(item)

            consecutive = 0
            while True:
                try:
                    reader.run(emit_fn)
                    _flush_spike(wait=True)  # never swallow a buffered tail
                    return True
                except Exception as exc:
                    if tracker.progressed:
                        consecutive = 0
                        tracker.progressed = False
                    consecutive += 1
                    budget = reader.max_allowed_consecutive_errors
                    if consecutive > budget:
                        log.error(
                            "connector reader failed (%d consecutive errors, "
                            "budget %d): %s",
                            consecutive,
                            budget,
                            exc,
                        )
                        poller.q.put(ReaderFailed(exc, consecutive))
                        return False
                    log.warning(
                        "transient connector reader error (%d/%d), "
                        "restarting: %s",
                        consecutive,
                        budget,
                        exc,
                    )
                    # reposition so the restarted run resumes, not repeats:
                    # offset-aware readers re-seek to the newest emitted
                    # offset; row-count readers fold the rows already seen
                    # into the skip prefix (their run() restarts from the
                    # source beginning); external-resume readers (Kafka)
                    # re-attach at the broker's committed position
                    # (redelivery of uncommitted rows = at-least-once).
                    if reader.supports_offsets and tracker.last_offset is not None:
                        try:
                            reader.seek(tracker.last_offset)
                        except Exception as seek_exc:  # noqa: BLE001
                            log.warning("reader re-seek failed: %s", seek_exc)
                    elif isinstance(emit, _RowCountEmit):
                        emit.skip = max(emit.skip, emit.count)
                        emit.count = 0
                    _time.sleep(min(0.05 * (2 ** (consecutive - 1)), 2.0))

        thread = threading.Thread(target=target, name="pathway:connector", daemon=True)
        thread.start()
        lowerer.pollers.append(poller)
        return node

    return Table(schema, build, universe=Universe())


def schema_digest(schema: type[schema_mod.Schema]) -> str:
    """The persistence compatibility digest: resumed runs refuse a source
    whose digest changed (one definition — the format is a contract)."""
    return "|".join(
        f"{n}:{schema.__columns__[n].dtype}" for n in schema.__columns__
    )


def register_static_persistence(lowerer, node, schema=None) -> None:
    """Operator-persistence bookkeeping for build-time (static) sources.

    Restored operator state already contains the effects of static rows
    from the previous run, so re-emitting them would double-apply state
    (joins against a static side over-count after resume).  The static
    source registers a trivial offset: {"done": true} commits once the
    engine processed the rows' epoch, and a resume that finds it skips
    emission entirely.
    """
    storage = getattr(lowerer, "persistence_storage", None)
    if storage is None or not getattr(storage, "operator_persistence", False):
        return
    counter = getattr(lowerer, "_source_counter", 0)
    lowerer._source_counter = counter + 1
    base_sid = sid = f"static_{counter}"
    worker = getattr(lowerer.scope, "worker", None)
    if worker is not None and worker.worker_count > 1:
        sid = f"{sid}-w{worker.worker_id}"
    state = storage.register_source(
        sid,
        schema_digest=None if schema is None else schema_digest(schema),
        base=base_sid,
    )
    if state.offset is not None:
        node.clear_staged()
        return
    last_t = max(node._staged.keys(), default=0)
    state.pending_offsets.append(({"done": True}, last_t))


def make_static_input_table(
    schema: type[schema_mod.Schema],
    rows: Iterable[Mapping[str, Any]],
) -> Table:
    """Static source: all rows at time 0 (connector static mode)."""
    names = list(schema.__columns__.keys())
    dtypes = [schema.__columns__[n].dtype for n in names]
    pk = schema.primary_key_columns()
    keyed: list = []
    auto_rows: list[int] = []  # positions needing a sequential auto key
    explicit_keys = False
    for row in rows:
        values = [dt.coerce(row.get(n), d) for n, d in zip(names, dtypes)]
        if "_pw_key" in row:
            k = row["_pw_key"]
            key = (k & KEY_MASK) if isinstance(k, int) else hash_values([k])
            explicit_keys = True
        elif pk:
            key = hash_values([values[names.index(c)] for c in pk])
            explicit_keys = True
        else:
            # key filled below: the bulk native derivation is ~10x the
            # per-row call at 1M rows
            auto_rows.append(len(keyed))
            key = None
        keyed.append((key, tuple(values), 1))
    if auto_rows:
        keys = sequential_keys(0, len(auto_rows))
        for pos, key in zip(auto_rows, keys):
            old = keyed[pos]
            keyed[pos] = (key, old[1], old[2])
    # all-auto keys are unique by construction: the whole batch is a
    # provably-clean epoch and the emit path's consolidate scan collapses
    # to a tag check.  pk/_pw_key rows may collide, so they stay unproven.
    if not explicit_keys:
        keyed = df.CleanDeltas(keyed)

    def build(lowerer: Lowerer) -> df.Node:
        deltas_for_worker = keyed
        worker = getattr(lowerer.scope, "worker", None)
        if worker is not None and worker.worker_count > 1:
            # every worker computed identical keys from identical build-time
            # data; each keeps only its own shard (SPMD data ownership) —
            # a key-subset of a clean batch stays clean
            subset = [
                e for e in keyed if worker.owner_of(e[0]) == worker.worker_id
            ]
            deltas_for_worker = (
                df.CleanDeltas(subset)
                if isinstance(keyed, df.CleanDeltas)
                else subset
            )
        node = df.StaticNode(lowerer.scope, prestaged=deltas_for_worker)
        register_static_persistence(lowerer, node, schema=schema)
        return node

    return Table(schema, build, universe=Universe())


def worker_part_path(filename: str) -> str:
    """Per-worker output path: in multi-process runs each worker writes its
    own shard of the output stream, so file sinks get a ``.part-N`` suffix
    for workers > 0 (worker 0 keeps the plain name; single-process is
    unchanged).  The combined output is the union of the part files.

    Worker 0 of a SUPERVISED run additionally sweeps part files OUTSIDE
    the current topology: an elastic shrink (degraded-mode rescale,
    ``docs/fault_tolerance.md``) leaves the dead workers' ``.part-N``
    shards behind, and since the combined output is a union, stale shards
    from a larger topology would double-count rows the rescaled workers
    re-emit.  Gated on the incarnation lease (supervised runs only): an
    unrelated standalone run that happens to target the same filename
    must never destroy another run's output shards."""
    from pathway_tpu_torch.engine.persistence import writer_incarnation
    from pathway_tpu_torch.internals.config import get_config

    cfg = get_config()
    if cfg.process_id == 0 and writer_incarnation() > 0:
        _sweep_stale_parts(filename, cfg.processes)
    if cfg.processes > 1 and cfg.process_id > 0:
        return f"{filename}.part-{cfg.process_id}"
    return filename


class WorkerPartFile:
    """An output file handle bound to THIS WORKER's part shard, resolved
    when the run starts (sink lowering) rather than when the sink is
    registered at graph-build time: each run lifetime re-resolves the part
    path (``worker_part_path``) and reopens it truncated, so a resumed run
    that replays its committed prefix rewrites the file instead of
    appending a duplicate stream, exactly like a whole-group restart."""

    def __init__(self, filename: str, *, newline: str | None = None,
                 on_open: Callable[[Any], None] | None = None):
        self._base = filename
        self._newline = newline
        self._on_open = on_open
        self._f: Any = None

    def reopen(self) -> None:
        """Resolve the part path for the worker id this process holds now
        and (re)open it truncated; called at sink lowering, once per run
        lifetime."""
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
        import os as _os

        path = worker_part_path(self._base)
        dirname = _os.path.dirname(_os.path.abspath(path))
        _os.makedirs(dirname, exist_ok=True)
        self._f = open(path, "w", newline=self._newline)
        if self._on_open is not None:
            self._on_open(self._f)

    def handle(self) -> Any:
        if self._f is None:
            self.reopen()
        return self._f

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


def plain_value(v: Any, *, bytes_as: str = "text") -> Any:
    """Engine value → JSON-able plain value for sink formatters.

    ``bytes_as``: "text" decodes utf-8 (lossy), "base64" encodes.
    """
    import base64

    from pathway_tpu_torch.engine.types import Pointer

    if isinstance(v, Json):
        return v.value
    if isinstance(v, bytes):
        if bytes_as == "base64":
            return base64.b64encode(v).decode()
        return v.decode("utf-8", errors="replace")
    if isinstance(v, Pointer):
        return str(v)
    if isinstance(v, tuple):
        return [plain_value(x, bytes_as=bytes_as) for x in v]
    return v


def register_output(
    table: Table,
    on_data: Callable[[int, tuple, int, int], None],
    *,
    on_time_end: Callable[[int], None] | None = None,
    on_end: Callable[[], None] | None = None,
    on_start: Callable[[], None] | None = None,
    name: str = "output",
) -> None:
    def attach(lowerer: Lowerer, node: df.Node):
        if on_start is not None:
            # run-lifetime hook: fires at sink lowering, so writers bind
            # run-scoped resources (per-worker part files) under the
            # worker identity this process holds NOW — not the one it had
            # at graph build, which differs for promoted standbys, and
            # fires again when a surviving worker rejoins in-process
            # after a promotion (internals/runner.run)
            on_start()
        return df.OutputNode(
            lowerer.scope, node, on_data=on_data, on_time_end=on_time_end, on_end=on_end
        )

    G.add_sink(name, table, attach)


def schema_or_default(
    schema: type[schema_mod.Schema] | None,
    value_columns: list[str] | None = None,
    primary_key: list[str] | None = None,
    default_dtype: dt.DType = dt.ANY,
) -> type[schema_mod.Schema]:
    if schema is not None:
        return schema
    cols = {}
    for c in primary_key or []:
        cols[c] = schema_mod.ColumnSchema(name=c, dtype=default_dtype, primary_key=True)
    for c in value_columns or []:
        cols[c] = schema_mod.ColumnSchema(name=c, dtype=default_dtype)
    if not cols:
        raise ValueError("provide schema= or value_columns=")
    return schema_mod.schema_from_columns(cols)


def _sweep_stale_parts(filename: str, processes: int) -> None:
    """Best-effort unlink of ``<filename>.part-N`` shards with N outside
    the current worker topology (see :func:`worker_part_path`)."""
    import glob as _glob
    import os as _os

    for path in _glob.glob(f"{_glob.escape(filename)}.part-*"):
        tail = path.rsplit("-", 1)[-1]
        if tail.isdigit() and int(tail) >= processes:
            try:
                _os.remove(path)
            except OSError:
                pass
