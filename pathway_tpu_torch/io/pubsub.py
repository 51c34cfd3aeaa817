"""Google Pub/Sub connector (parity: python/pathway/io/pubsub).

Speaks the documented REST API with service-account JWT auth
(``io/_gauth.py``) — no google-cloud client.  ``write`` publishes one
message per change-stream row; ``read`` pulls + acks from a subscription
(at-least-once, the subscription tracks delivery so the reader is an
external-resume source like Kafka consumer groups).
"""

from __future__ import annotations

import base64
import json as _json
import threading
import time as _time
from typing import Any

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._gauth import (
    ServiceAccountCredentials,
    api_request,
    api_request_retry,
)
from pathway_tpu_torch.io._utils import COMMIT, Reader

__all__ = ["read", "write"]

_SCOPE = "https://www.googleapis.com/auth/pubsub"
_DEFAULT_API = "https://pubsub.googleapis.com"


class _PubSubSink:
    def __init__(self, creds, project: str, topic: str, api_base: str):
        self.creds = creds
        self.url = f"{api_base}/v1/projects/{project}/topics/{topic}:publish"
        self._messages: list[dict] = []
        self._lock = threading.Lock()

    def add(self, data: bytes, attributes: dict | None = None) -> None:
        msg = {"data": base64.b64encode(data).decode()}
        if attributes:
            msg["attributes"] = attributes
        with self._lock:
            self._messages.append(msg)

    def flush(self, _time: int | None = None) -> None:
        with self._lock:
            if not self._messages:
                return
            body = _json.dumps({"messages": self._messages}).encode()
            status, payload = api_request(self.creds, "POST", self.url, body)
            if status >= 300:
                raise RuntimeError(
                    f"pubsub publish failed ({status}): {payload[:300]!r}"
                )
            self._messages = []


class _ClientPublisherSink:
    """Adapter over a user-supplied Pub/Sub publisher client."""

    def __init__(self, publisher: Any, project_id: str, topic_id: str):
        self.publisher = publisher
        if hasattr(publisher, "topic_path"):
            self.topic = publisher.topic_path(project_id, topic_id)
        else:
            self.topic = f"projects/{project_id}/topics/{topic_id}"
        self._futures: list = []

    def add(self, payload: bytes, attributes: dict | None = None) -> None:
        self._futures.append(
            self.publisher.publish(self.topic, data=payload, **(attributes or {}))
        )

    def flush(self, _time: int | None = None) -> None:
        futures, self._futures = self._futures, []
        for f in futures:
            if hasattr(f, "result"):
                f.result(timeout=60)


def write(
    table: Table,
    project_id: str | None = None,
    topic_id: str | None = None,
    service_user_credentials_file: str | None = None,
    *,
    publisher: Any = None,
    name: str | None = None,
    _api_base: str = _DEFAULT_API,
    _sink_factory: Any = None,
) -> None:
    """Publish the change stream to a Pub/Sub topic.

    Reference: ``pw.io.pubsub.write`` (python/pathway/io/pubsub).
    ``publisher`` takes a prebuilt google-cloud-pubsub PublisherClient
    (or any object with ``publish(topic, data=...)``) instead of a
    service-account file; messages then go through that client.
    """
    names = table.column_names()
    if publisher is not None:
        if project_id is None or topic_id is None:
            raise ValueError("pubsub.write with publisher= needs project_id and topic_id")
        sink = _ClientPublisherSink(publisher, project_id, topic_id)
    else:
        if service_user_credentials_file is None:
            raise ValueError(
                "pubsub.write requires service_user_credentials_file= or publisher="
            )
        creds = ServiceAccountCredentials.from_file(
            service_user_credentials_file, [_SCOPE]
        )
        sink = (_sink_factory or _PubSubSink)(creds, project_id, topic_id, _api_base)

    def on_data(key, row, time, diff):
        obj = {n: _utils.plain_value(v, bytes_as="base64") for n, v in zip(names, row)}
        sink.add(
            _json.dumps(obj).encode(),
            attributes={"pathway_time": str(time), "pathway_diff": str(diff)},
        )

    _utils.register_output(
        table,
        on_data,
        on_time_end=sink.flush,
        on_end=sink.flush,
        name=name or f"pubsub:{topic_id}",
    )


class _PubSubReader(Reader):
    # the subscription tracks acked messages server-side
    external_resume = True

    def __init__(self, creds, project: str, subscription: str, format: str, schema, api_base: str):
        self.creds = creds
        self.base = f"{api_base}/v1/projects/{project}/subscriptions/{subscription}"
        self.format = format
        self.schema = schema
        # ack only at the engine's durability point (the Kafka consumer-
        # group pattern: _utils.ack_processed → request_offset_commit);
        # acking at pull time would make delivery at-most-once
        self._lock = threading.Lock()
        self._commit_seq = 0
        self._ack_up_to = 0
        self._captured: dict[int, list[str]] = {}
        self._pending_ids: list[str] = []
        self._ack_requested = threading.Event()

    def request_offset_commit(self, up_to: int | None = None) -> None:
        with self._lock:
            self._ack_up_to = max(
                self._ack_up_to, self._commit_seq if up_to is None else up_to
            )
        self._ack_requested.set()

    def _capture(self) -> None:
        with self._lock:
            self._commit_seq += 1
            if self._pending_ids:
                self._captured[self._commit_seq] = self._pending_ids
                self._pending_ids = []

    def _take_acked(self) -> list[str]:
        self._ack_requested.clear()
        with self._lock:
            acked = [s for s in self._captured if s <= self._ack_up_to]
            out = [i for s in acked for i in self._captured.pop(s)]
            return out

    def run(self, emit) -> None:
        names = list(self.schema.__columns__.keys()) if self.schema else ["data"]
        while True:
            body = _json.dumps({"maxMessages": 100}).encode()
            status, payload = api_request_retry(
                self.creds, "POST", f"{self.base}:pull", body
            )
            if status >= 300:
                raise RuntimeError(f"pubsub pull failed ({status}): {payload[:300]!r}")
            received = _json.loads(payload or b"{}").get("receivedMessages", [])
            for rm in received:
                with self._lock:
                    self._pending_ids.append(rm["ackId"])
                data = base64.b64decode(rm.get("message", {}).get("data", ""))
                self._emit_payload(data, names, emit)
            emit(COMMIT)
            self._capture()
            if self._ack_requested.is_set():
                ids = self._take_acked()
                if ids:
                    api_request(
                        self.creds,
                        "POST",
                        f"{self.base}:acknowledge",
                        _json.dumps({"ackIds": ids}).encode(),
                    )
            if not received:
                _time.sleep(1.0)

    def _emit_payload(self, payload: bytes, names, emit) -> None:
        if self.format == "raw":
            emit({"data": payload})
        elif self.format == "plaintext":
            emit({"data": payload.decode("utf-8", errors="replace")})
        else:
            try:
                obj = _json.loads(payload)
            except _json.JSONDecodeError:
                return
            if not isinstance(obj, dict):
                return
            emit(
                {
                    n: (Json(v) if isinstance(v, (dict, list)) else v)
                    for n, v in ((n, obj.get(n)) for n in names)
                }
            )


def read(
    project_id: str,
    subscription_id: str,
    service_user_credentials_file: str,
    *,
    schema: type[schema_mod.Schema] | None = None,
    format: str = "json",
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    _api_base: str = _DEFAULT_API,
    **kwargs: Any,
) -> Table:
    """Pull messages from a Pub/Sub subscription into a live table."""
    if format in ("raw", "plaintext") and schema is None:
        schema = schema_mod.schema_from_types(
            data=bytes if format == "raw" else str
        )
    if schema is None:
        raise ValueError("pubsub.read with json format requires schema=")
    creds = ServiceAccountCredentials.from_file(
        service_user_credentials_file, [_SCOPE]
    )
    return _utils.make_input_table(
        schema,
        lambda: _PubSubReader(
            creds, project_id, subscription_id, format, schema, _api_base
        ),
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
    )
