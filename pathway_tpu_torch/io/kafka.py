"""Kafka connector (parity: python/pathway/io/kafka; KafkaReader
data_storage.rs:663, KafkaWriter :1334).

Uses ``kafka-python`` (or ``confluent_kafka``) when available; partitioned
topics are read per-worker in the reference — single-process builds read all
partitions on one consumer thread.
"""

from __future__ import annotations

import json as _json
import threading as _threading
import time as _time
from typing import Any

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.engine.types import hash_values
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io.jsonlines import _extract_path
from pathway_tpu_torch.io._utils import COMMIT, Reader


def _get_client():
    try:
        import confluent_kafka  # type: ignore

        return ("confluent", confluent_kafka)
    except ImportError:
        pass
    try:
        import kafka  # type: ignore

        return ("kafka-python", kafka)
    except ImportError:
        raise ImportError(
            "pw.io.kafka requires confluent_kafka or kafka-python, neither of "
            "which is installed in this environment"
        )


class _KafkaReader(Reader):
    # the broker tracks the consumer-group offset: on restart the consumer
    # resumes past consumed messages itself, so the generic row-count
    # frontier must NOT additionally skip rows (it would drop fresh data)
    external_resume = True
    # transient broker failures (rebalance, coordinator churn) are ridden
    # out, as in the reference's KafkaReader (data_storage.rs:766)
    max_allowed_consecutive_errors = 32

    def __init__(
        self,
        rdkafka_settings,
        topic,
        format,
        schema,
        commit_interval_s=1.5,
        *,
        json_field_paths=None,
        with_metadata=False,
        autogenerate_key=False,
        start_from_timestamp_ms=None,
    ):
        self.settings = rdkafka_settings
        self.topic = topic
        self.format = format
        self.schema = schema
        self.commit_interval_s = commit_interval_s
        self.json_field_paths = json_field_paths
        self.with_metadata = with_metadata
        # raw format: False keys rows by the Kafka message key (upsert-like
        # identity per key), True autogenerates fresh row keys
        self.autogenerate_key = autogenerate_key
        self.start_from_timestamp_ms = start_from_timestamp_ms
        # multi-worker: (worker_id, worker_count) → manual assignment of
        # partitions with partition % worker_count == worker_id (the
        # reference's partitioned-source rule, worker-architecture.md:40)
        self._stripe: tuple[int, int] | None = None
        self._offset_commit_requested = _threading.Event()
        self._lock = _threading.Lock()
        self._commit_seq = 0  # COMMIT markers emitted so far
        self._ack_up_to = 0  # highest marker the engine has acknowledged
        self._captured: dict[int, Any] = {}  # marker seq -> offsets snapshot

    def partition(self, worker_id: int, worker_count: int) -> "_KafkaReader":
        self._stripe = (worker_id, worker_count)
        return self

    def _my_partitions(self, all_partitions: list[int]) -> list[int]:
        if self._stripe is None:
            return all_partitions
        wid, n = self._stripe
        return [p for p in all_partitions if p % n == wid]

    def request_offset_commit(self, up_to: int | None = None) -> None:
        """Called by the engine at its durability point (epoch processed /
        snapshot committed); ``up_to`` is how many of our COMMIT markers the
        engine has consumed.  The broker commit itself happens on the
        consumer thread — Kafka clients are not thread-safe — and commits
        the offsets captured at that marker, not the live position (which
        may already be past rows the engine never processed)."""
        with self._lock:
            self._ack_up_to = max(
                self._ack_up_to, self._commit_seq if up_to is None else up_to
            )
        self._offset_commit_requested.set()

    def _capture(self, offsets: Any) -> None:
        """Snapshot consumer positions at a just-emitted COMMIT marker."""
        with self._lock:
            self._commit_seq += 1
            if offsets:
                self._captured[self._commit_seq] = offsets

    @staticmethod
    def _try_commit(commit: Any) -> None:
        """Broker offset commits are best-effort: a transient failure
        (rebalance, coordinator loss) must not kill the reader thread —
        uncommitted offsets just mean redelivery, i.e. at-least-once."""
        try:
            commit()
        except Exception as exc:
            import logging

            logging.getLogger("pathway_tpu_torch.io").warning(
                "kafka offset commit failed (will retry at next ack): %s", exc
            )

    def _take_acked(self) -> Any:
        """Offsets snapshot at the newest acknowledged marker, or None."""
        self._offset_commit_requested.clear()
        with self._lock:
            acked = [s for s in self._captured if s <= self._ack_up_to]
            if not acked:
                return None
            offsets = self._captured[max(acked)]
            for s in acked:
                del self._captured[s]
            return offsets

    def _kafka_python_kwargs(self, group_id) -> dict:
        """Map rdkafka-style settings onto kafka-python constructor kwargs —
        the fallback backend must honor offset-reset and SASL credentials,
        not silently drop them (simple_read/read_from_upstash rely on both)."""
        st = self.settings
        kwargs = {
            "bootstrap_servers": st.get("bootstrap.servers"),
            "group_id": group_id,
            "enable_auto_commit": False,
        }
        if "auto.offset.reset" in st:
            kwargs["auto_offset_reset"] = st["auto.offset.reset"]
        proto = st.get("security.protocol")
        if proto:
            kwargs["security_protocol"] = proto.upper()
        if "sasl.mechanism" in st:
            kwargs["sasl_mechanism"] = st["sasl.mechanism"]
        if "sasl.username" in st:
            kwargs["sasl_plain_username"] = st["sasl.username"]
        if "sasl.password" in st:
            kwargs["sasl_plain_password"] = st["sasl.password"]
        return kwargs

    def run(self, emit) -> None:
        kind, client = _get_client()
        names = list(self.schema.__columns__.keys()) if self.schema else ["data"]
        # broker offsets are committed manually, and only after the engine
        # acknowledges the rows (request_offset_commit): client-side
        # auto-commit runs on its own clock and would advance the group
        # offset past rows the engine never saw — row loss on restart.
        # Offsets trail the durability point, so restarts redeliver the
        # tail: at-least-once, matching the reference's guarantee.
        group_id = self.settings.get("group.id")
        if kind == "confluent":
            settings = dict(self.settings)
            settings["enable.auto.commit"] = False
            consumer = client.Consumer(settings)
            if self._stripe is not None:
                meta = consumer.list_topics(self.topic, timeout=10.0)
                parts = sorted(meta.topics[self.topic].partitions.keys())
                if not parts:
                    raise RuntimeError(
                        f"kafka: no partition metadata for topic "
                        f"{self.topic!r}; cannot stripe it across workers"
                    )
                consumer.assign(
                    [
                        client.TopicPartition(self.topic, p)
                        for p in self._my_partitions(parts)
                    ]
                )
            else:
                consumer.subscribe([self.topic])
            if self.start_from_timestamp_ms is not None:
                # pin EVERY partition to the first offset at/after the
                # timestamp: one assign() with the offsets embedded (this
                # replaces any subscription — a timestamp-pinned start is
                # a manual-assignment read).  Partitions with no message
                # at/after the cutoff start at the end (nothing older may
                # be emitted); lookup failures raise rather than silently
                # replaying from auto.offset.reset.
                meta = consumer.list_topics(self.topic, timeout=10.0)
                parts = sorted(meta.topics[self.topic].partitions.keys())
                if self._stripe is not None:
                    parts = self._my_partitions(parts)
                tps = [
                    client.TopicPartition(
                        self.topic, p, self.start_from_timestamp_ms
                    )
                    for p in parts
                ]
                resolved = consumer.offsets_for_times(tps, timeout=10.0)
                seek_tps = []
                for tp in resolved:
                    if tp.error is not None:
                        raise RuntimeError(
                            f"kafka: offsets_for_times failed for partition "
                            f"{tp.partition}: {tp.error}"
                        )
                    offset = tp.offset if tp.offset >= 0 else client.OFFSET_END
                    seek_tps.append(
                        client.TopicPartition(self.topic, tp.partition, offset)
                    )
                consumer.assign(seek_tps)

            def positions():
                try:
                    return [
                        tp
                        for tp in consumer.position(consumer.assignment())
                        if tp.offset >= 0
                    ]
                except Exception:
                    return []

            last_epoch = _time.monotonic()
            while True:
                msg = consumer.poll(0.5)
                if msg is not None and not msg.error():
                    # emit before any COMMIT marker: poll() already advanced
                    # the position past this message, so the marker's
                    # snapshot must only be taken once the row is emitted
                    ts = msg.timestamp()
                    self._emit_payload(
                        msg.value(),
                        names,
                        emit,
                        key=msg.key(),
                        meta=(
                            {
                                "topic": msg.topic(),
                                "partition": msg.partition(),
                                "offset": msg.offset(),
                                "timestamp_millis": ts[1] if ts else None,
                            }
                            if self.with_metadata
                            else None
                        ),
                    )
                now = _time.monotonic()
                if msg is None or (now - last_epoch) >= self.commit_interval_s:
                    # epoch boundary on idle AND on a timer under load —
                    # a busy topic must still reach durability points
                    emit(COMMIT)
                    if group_id:  # group-less consumers never commit
                        self._capture(positions())
                    last_epoch = now
                if group_id and self._offset_commit_requested.is_set():
                    offsets = self._take_acked()
                    if offsets:
                        self._try_commit(
                            lambda: consumer.commit(
                                offsets=offsets, asynchronous=False
                            )
                        )
        else:
            if self._stripe is not None:
                consumer = client.KafkaConsumer(
                    **self._kafka_python_kwargs(group_id)
                )
                # manual assign() never re-fetches metadata, so a missing
                # topic must fail loudly, not pin the cluster to nothing
                parts = None
                for _ in range(20):
                    parts = consumer.partitions_for_topic(self.topic)
                    if parts:
                        break
                    _time.sleep(0.5)
                if not parts:
                    raise RuntimeError(
                        f"kafka: no partition metadata for topic "
                        f"{self.topic!r}; cannot stripe it across workers"
                    )
                tp_cls = client.TopicPartition
                consumer.assign(
                    [
                        tp_cls(self.topic, p)
                        for p in self._my_partitions(sorted(parts))
                    ]
                )
            else:
                consumer = client.KafkaConsumer(
                    self.topic, **self._kafka_python_kwargs(group_id)
                )
            if self.start_from_timestamp_ms is not None:
                # timestamp-pinned start is a manual-assignment read: no
                # group-join race, every partition seeked deterministically
                parts = None
                for _ in range(20):
                    parts = consumer.partitions_for_topic(self.topic)
                    if parts:
                        break
                    _time.sleep(0.5)
                if not parts:
                    raise RuntimeError(
                        f"kafka: no partition metadata for topic "
                        f"{self.topic!r}; cannot seek by timestamp"
                    )
                if self._stripe is not None:
                    parts = self._my_partitions(sorted(parts))
                tp_cls = client.TopicPartition
                tps = [tp_cls(self.topic, p) for p in sorted(parts)]
                consumer.unsubscribe()
                consumer.assign(tps)
                found = consumer.offsets_for_times(
                    {tp: self.start_from_timestamp_ms for tp in tps}
                )
                for tp in tps:
                    ot = (found or {}).get(tp)
                    if ot is not None and ot.offset is not None:
                        consumer.seek(tp, ot.offset)
                    else:
                        consumer.seek_to_end(tp)  # nothing at/after cutoff
            meta_cls = getattr(client, "OffsetAndMetadata", None)

            def positions():
                out = {}
                for tp in consumer.assignment():
                    try:
                        pos = consumer.position(tp)
                    except Exception:
                        continue
                    if pos is None or pos < 0 or meta_cls is None:
                        continue
                    try:
                        out[tp] = meta_cls(pos, "", -1)
                    except TypeError:  # older kafka-python: no leader_epoch
                        out[tp] = meta_cls(pos, "")
                return out

            last_epoch = _time.monotonic()
            while True:
                batches = consumer.poll(timeout_ms=500)
                now = _time.monotonic()
                for records in batches.values():
                    for msg in records:
                        self._emit_payload(
                            msg.value,
                            names,
                            emit,
                            key=msg.key,
                            meta=(
                                {
                                    "topic": msg.topic,
                                    "partition": msg.partition,
                                    "offset": msg.offset,
                                    "timestamp_millis": msg.timestamp,
                                }
                                if self.with_metadata
                                else None
                            ),
                        )
                if not batches or (now - last_epoch) >= self.commit_interval_s:
                    emit(COMMIT)
                    if group_id:  # kafka-python asserts group_id on commit()
                        self._capture(positions())
                    last_epoch = now
                if group_id and self._offset_commit_requested.is_set():
                    offsets = self._take_acked()
                    if offsets:
                        self._try_commit(lambda: consumer.commit(offsets=offsets))

    def _emit_payload(self, payload: bytes, names, emit, *, key=None, meta=None) -> None:
        row = None
        if self.format in ("raw", "plaintext"):
            row = (
                {"data": payload}
                if self.format == "raw"
                else {"data": payload.decode("utf-8", errors="replace")}
            )
            if not self.autogenerate_key and key is not None:
                # message-keyed rows: same Kafka key -> same row identity
                # (reference default for raw/plaintext)
                row["_pw_key"] = hash_values([key])
        elif self.format in ("json", "jsonlines"):
            try:
                obj = _json.loads(payload)
            except _json.JSONDecodeError:
                return
            paths = self.json_field_paths
            row = {}
            for n in names:
                if n == "_metadata":
                    continue
                v = (
                    _extract_path(obj, paths[n])
                    if paths and n in paths
                    else obj.get(n)
                )
                row[n] = Json(v) if isinstance(v, (dict, list)) else v
        if row is None:
            return
        if meta is not None:
            row["_metadata"] = Json(meta)
        emit(row)


def read(
    rdkafka_settings: dict,
    topic: str | None = None,
    *,
    schema: type[schema_mod.Schema] | None = None,
    format: str = "raw",
    json_field_paths: dict | None = None,
    autogenerate_key: bool = False,
    with_metadata: bool = False,
    start_from_timestamp_ms: int | None = None,
    parallel_readers: int | None = None,
    autocommit_duration_ms: int | None = 1500,
    debug_data: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read a Kafka topic (parity: pw.io.kafka.read).

    ``parallel_readers`` is advisory here: partition striping across
    worker processes is this engine's read parallelism (one consumer per
    worker), so the knob is accepted for API parity but does not spawn
    extra threads inside one worker.
    """
    if format == "raw" and schema is None:
        schema = schema_mod.schema_from_types(data=bytes)
    elif format == "plaintext" and schema is None:
        schema = schema_mod.schema_from_types(data=str)
    elif schema is None:
        raise ValueError("kafka.read with json format requires schema=")
    if with_metadata:
        schema = _utils.with_metadata_schema(schema)
    # message-keyed rows (raw/plaintext, autogenerate_key=False) carry the
    # Kafka key as row identity: an upsert session makes a repeated key
    # REPLACE its predecessor (compacted-topic semantics) instead of
    # stacking duplicate rows under one id
    keyed_by_message = not autogenerate_key and format in ("raw", "plaintext")
    return _utils.make_input_table(
        schema,
        lambda: _KafkaReader(
            rdkafka_settings,
            topic,
            format,
            schema,
            commit_interval_s=(autocommit_duration_ms or 1500) / 1000.0,
            json_field_paths=json_field_paths,
            with_metadata=with_metadata,
            autogenerate_key=autogenerate_key,
            start_from_timestamp_ms=start_from_timestamp_ms,
        ),
        autocommit_duration_ms=autocommit_duration_ms,
        upsert=keyed_by_message,
        name=name,
        debug_data=debug_data,
    )


def write(
    table: Table,
    rdkafka_settings: dict,
    topic_name: str | None = None,
    *,
    format: str = "json",
    delimiter: str = ",",
    key: Any = None,
    value: Any = None,
    headers: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> None:
    """Write rows to a Kafka topic (parity: pw.io.kafka.write).

    ``key``/``value``/``headers`` are column references: the message key,
    a single-column payload (raw/plaintext formats), and per-message
    Kafka headers built from the named columns.
    """
    kind, client = _get_client()
    names = table.column_names()
    topic = topic_name or kwargs.get("topic")

    def _col_idx(ref, what):
        n = getattr(ref, "name", ref)
        if n not in names:
            raise ValueError(f"kafka.write {what}= column {n!r} not in table")
        return names.index(n)

    key_idx = _col_idx(key, "key") if key is not None else None
    header_idxs = (
        [(getattr(h, "name", h), _col_idx(h, "headers")) for h in headers]
        if headers
        else None
    )
    payload_of = _utils.make_payload_formatter(
        names, format, delimiter=delimiter, value=value, sink="kafka.write"
    )

    def _as_bytes(v) -> bytes:
        if isinstance(v, bytes):
            return v
        return str(_plain(v)).encode()

    def msg_kwargs(row) -> dict:
        out = {}
        if key_idx is not None:
            out["key"] = _as_bytes(row[key_idx])
        if header_idxs is not None:
            out["headers"] = [
                (hn, _as_bytes(row[i])) for hn, i in header_idxs
            ]
        return out

    if kind == "confluent":
        producer = client.Producer(rdkafka_settings)

        def on_data(key_, row, time, diff):
            producer.produce(
                topic, payload_of(row, time, diff), **msg_kwargs(row)
            )
            producer.poll(0)

        _utils.register_output(table, on_data, on_end=producer.flush, name=f"kafka:{topic}")
    else:
        producer = client.KafkaProducer(
            bootstrap_servers=rdkafka_settings.get("bootstrap.servers")
        )

        def on_data(key_, row, time, diff):
            producer.send(
                topic, payload_of(row, time, diff), **msg_kwargs(row)
            )

        _utils.register_output(table, on_data, on_end=producer.flush, name=f"kafka:{topic}")


def _plain(v):
    return _utils.plain_value(v)


def simple_read(
    server: str,
    topic: str,
    *,
    read_only_new: bool = False,
    schema: type[schema_mod.Schema] | None = None,
    format: str = "raw",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Simplified ``read``: just a bootstrap server and a topic (parity:
    io/kafka/__init__.py:276).  Reads from the beginning of the topic
    unless ``read_only_new``; a random group id keeps replays independent."""
    import uuid as _uuid

    settings = {
        "bootstrap.servers": server,
        "group.id": str(_uuid.uuid4()),
        "session.timeout.ms": "6000",
        "auto.offset.reset": "latest" if read_only_new else "earliest",
    }
    return read(
        settings,
        topic,
        schema=schema,
        format=format,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        **kwargs,
    )


def read_from_upstash(
    endpoint: str,
    username: str,
    password: str,
    topic: str,
    *,
    read_only_new: bool = False,
    schema: type[schema_mod.Schema] | None = None,
    format: str = "raw",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """``read`` preconfigured for Upstash-hosted Kafka (SCRAM over SSL;
    parity: io/kafka/__init__.py:375)."""
    import uuid as _uuid

    settings = {
        "bootstrap.servers": endpoint,
        "group.id": str(_uuid.uuid4()),
        "session.timeout.ms": "6000",
        "security.protocol": "sasl_ssl",
        "sasl.mechanism": "SCRAM-SHA-256",
        "sasl.username": username,
        "sasl.password": password,
        "auto.offset.reset": "latest" if read_only_new else "earliest",
    }
    return read(
        settings,
        topic,
        schema=schema,
        format=format,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        **kwargs,
    )
