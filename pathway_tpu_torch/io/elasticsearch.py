"""Elasticsearch sink connector (parity: python/pathway/io/elasticsearch;
engine ``ElasticSearchWriter`` ``src/connectors/data_storage.rs:1416``).

Writes through the documented ``_bulk`` REST API over ``http.client`` — no
elasticsearch-py needed.  Inserts index a document per row (doc id = row
key, so retractions delete the same document); each engine epoch flushes
one bulk request.
"""

from __future__ import annotations

import base64
import http.client
import json as _json
import threading
import urllib.parse
from typing import Any

from pathway_tpu_torch.engine.types import Json, Pointer
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils

__all__ = ["ElasticSearchAuth", "ElasticSearchParams", "write"]


class ElasticSearchAuth:
    """Parity: pw.io.elasticsearch.ElasticSearchAuth (basic/apikey/bearer)."""

    def __init__(self, kind: str, **kw: str):
        self.kind = kind
        self.kw = kw

    @classmethod
    def basic(cls, username: str, password: str) -> "ElasticSearchAuth":
        return cls("basic", username=username, password=password)

    @classmethod
    def apikey(cls, apikey_id: str, apikey: str) -> "ElasticSearchAuth":
        return cls("apikey", apikey_id=apikey_id, apikey=apikey)

    @classmethod
    def bearer(cls, bearer: str) -> "ElasticSearchAuth":
        return cls("bearer", bearer=bearer)

    def header(self) -> str:
        if self.kind == "basic":
            tok = base64.b64encode(
                f"{self.kw['username']}:{self.kw['password']}".encode()
            ).decode()
            return f"Basic {tok}"
        if self.kind == "apikey":
            tok = base64.b64encode(
                f"{self.kw['apikey_id']}:{self.kw['apikey']}".encode()
            ).decode()
            return f"ApiKey {tok}"
        return f"Bearer {self.kw['bearer']}"


class ElasticSearchParams:
    """Parity: pw.io.elasticsearch.ElasticSearchParams."""

    def __init__(self, host: str, index_name: str, auth: ElasticSearchAuth | None = None):
        self.host = host
        self.index_name = index_name
        self.auth = auth


def _plain(v: Any):
    return _utils.plain_value(v, bytes_as="base64")


class _BulkSink:
    def __init__(self, params: ElasticSearchParams, max_batch_size: int | None):
        parsed = urllib.parse.urlparse(
            params.host if "//" in params.host else "http://" + params.host
        )
        self.secure = parsed.scheme == "https"
        self.netloc = parsed.netloc
        self.index = params.index_name
        self.auth = params.auth
        self.max_batch_size = max_batch_size
        self._lines: list[bytes] = []
        self._lock = threading.Lock()

    def add(self, action: dict, doc: dict | None) -> None:
        with self._lock:
            self._lines.append(_json.dumps(action).encode())
            if doc is not None:
                self._lines.append(_json.dumps(doc).encode())
            if self.max_batch_size and len(self._lines) >= 2 * self.max_batch_size:
                self._flush_locked()

    def flush(self, _time: int | None = None) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._lines:
            return
        body = b"\n".join(self._lines) + b"\n"
        conn_cls = http.client.HTTPSConnection if self.secure else http.client.HTTPConnection
        conn = conn_cls(self.netloc, timeout=30)
        try:
            headers = {"Content-Type": "application/x-ndjson"}
            if self.auth is not None:
                headers["Authorization"] = self.auth.header()
            conn.request("POST", f"/{self.index}/_bulk", body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status >= 300:
                raise RuntimeError(
                    f"elasticsearch bulk failed ({resp.status}): "
                    f"{payload[:500].decode(errors='replace')}"
                )
            # a 200 can still carry per-item failures (mapping conflicts,
            # 429 rejections) under "errors": true — silent success here
            # would drop the batch
            try:
                parsed = _json.loads(payload)
            except ValueError:
                parsed = {}
            if parsed.get("errors"):
                failed = [
                    item
                    for item in parsed.get("items", [])
                    for action in item.values()
                    if action.get("status", 200) >= 300
                ]
                raise RuntimeError(
                    f"elasticsearch bulk reported {len(failed)} failed items: "
                    f"{str(failed[:3])[:500]}"
                )
        finally:
            conn.close()
        # drain only after the bulk posted — a failed flush keeps the batch
        self._lines = []


def write(
    table: Table,
    host: "str | ElasticSearchParams",
    auth: "ElasticSearchAuth | None" = None,
    index_name: str | None = None,
    *,
    max_batch_size: int | None = None,
    name: str | None = None,
    _sink_factory: Any = None,
) -> None:
    """Index the table into Elasticsearch; row key is the document id.

    Accepts the reference's positional form ``write(table, host, auth,
    index_name)`` or a prebuilt ``ElasticSearchParams`` as the second
    argument."""
    if isinstance(host, ElasticSearchParams):
        elasticsearch_params = host
    else:
        if index_name is None:
            raise ValueError("elasticsearch.write requires index_name=")
        elasticsearch_params = ElasticSearchParams(host, index_name, auth)
    names = table.column_names()
    sink = (_sink_factory or _BulkSink)(elasticsearch_params, max_batch_size)
    index = elasticsearch_params.index_name

    def on_data(key, row, time, diff):
        doc_id = str(Pointer(key))
        if diff > 0:
            doc = {n: _plain(v) for n, v in zip(names, row)}
            doc["time"], doc["diff"] = time, diff
            sink.add({"index": {"_index": index, "_id": doc_id}}, doc)
        else:
            sink.add({"delete": {"_index": index, "_id": doc_id}}, None)

    _utils.register_output(
        table,
        on_data,
        on_time_end=sink.flush,
        on_end=sink.flush,
        name=name or f"elasticsearch:{index}",
    )
