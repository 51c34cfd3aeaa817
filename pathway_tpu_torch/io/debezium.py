"""Debezium CDC connector (parity: python/pathway/io/debezium;
``DebeziumMessageParser`` ``src/connectors/data_format.rs:1017``).

Parses Debezium change envelopes — ``payload.op`` of ``r`` (snapshot read),
``c`` (create), ``u`` (update), ``d`` (delete) with ``before``/``after``
row images — into engine insert/retract deltas.  Transport is Kafka (the
reference's only Debezium transport), reusing ``pw.io.kafka``'s reader with
a CDC payload parser.  ``parse_debezium_message`` is exposed for testing
and for custom transports.
"""

from __future__ import annotations

import json as _json
from typing import Any

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._utils import DELETE
from pathway_tpu_torch.io.kafka import _KafkaReader

__all__ = ["read", "parse_debezium_message"]


def parse_debezium_message(
    payload: bytes | str | None, names: list[str]
) -> list[tuple[dict, int]]:
    """One Debezium value message → [(row_dict, diff)].

    Mirrors DebeziumMessageParser: r/c emit +1 of ``after``; d emits -1 of
    ``before``; u emits -1 of ``before`` then +1 of ``after``.  Tombstones
    (null payloads, emitted by Debezium after deletes for log compaction)
    parse to nothing.
    """
    if payload is None or payload == b"" or payload == "":
        return []
    try:
        obj = _json.loads(payload)
    except (ValueError, TypeError):
        return []
    if obj is None:
        return []
    # messages may or may not carry the schema envelope
    body = obj.get("payload", obj)
    if body is None:
        return []
    op = body.get("op")
    before, after = body.get("before"), body.get("after")

    def project(img: dict) -> dict:
        return {
            n: (Json(v) if isinstance(v, (dict, list)) else v)
            for n, v in ((n, img.get(n)) for n in names)
        }

    out: list[tuple[dict, int]] = []
    if op in ("r", "c"):
        if after:
            out.append((project(after), 1))
    elif op == "d":
        if before:
            out.append((project(before), -1))
    elif op == "u":
        if before:
            out.append((project(before), -1))
        if after:
            out.append((project(after), 1))
    return out


class _DebeziumKafkaReader(_KafkaReader):
    # takes the reader loop's message key and metadata (unused: rows are
    # keyed by the schema's primary key); the JAX package's override lacks
    # them, so its read loop fails on the first message
    def _emit_payload(self, payload, names, emit, *, key=None, meta=None) -> None:
        for row, diff in parse_debezium_message(payload, names):
            if diff < 0:
                row = dict(row)
                row[DELETE] = True
            emit(row)


def read(
    rdkafka_settings: dict,
    topic_name: str | None = None,
    *,
    schema: type[schema_mod.Schema] | None = None,
    db_type: str | None = None,
    autocommit_duration_ms: int | None = 1500,
    debug_data: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read a Debezium CDC topic into a live table.

    ``db_type`` (postgres/mongodb) is accepted for parity; the envelope
    parser here auto-detects both payload shapes, so the hint only
    documents intent.

    Reference: ``pw.io.debezium.read`` (python/pathway/io/debezium).
    """
    if schema is None:
        raise ValueError("debezium.read requires schema=")
    if not schema.primary_key_columns():
        # retractions cancel insertions only when row keys derive from the
        # primary key; without one each before-image would land under a
        # fresh key and updates/deletes would corrupt the table
        raise ValueError(
            "debezium.read requires a schema with primary-key columns "
            "(pw.column_definition(primary_key=True))"
        )
    topic = topic_name or kwargs.get("topic")
    return _utils.make_input_table(
        schema,
        lambda: _DebeziumKafkaReader(
            rdkafka_settings,
            topic,
            "json",
            schema,
            commit_interval_s=(autocommit_duration_ms or 1500) / 1000.0,
        ),
        debug_data=debug_data,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
    )
