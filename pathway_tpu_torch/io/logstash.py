"""Logstash sink connector (parity: python/pathway/io/logstash).

Posts change-stream rows as JSON to a Logstash HTTP input plugin over
``http.client`` (the reference posts via its generic HTTP sink).  Rows
carry ``time``/``diff`` like the reference's formatter output.
"""

from __future__ import annotations

import http.client
import json as _json
import threading
import time as _time
import urllib.parse
from typing import Any

from pathway_tpu_torch.engine.types import Json, Pointer
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils

__all__ = ["write"]


def _plain(v: Any):
    return _utils.plain_value(v)


class _HttpSink:
    def __init__(
        self,
        endpoint: str,
        headers: dict[str, str] | None,
        *,
        n_retries: int = 0,
        retry_policy: Any = None,
        connect_timeout_ms: int | None = None,
        request_timeout_ms: int | None = None,
    ):
        parsed = urllib.parse.urlparse(
            endpoint if "//" in endpoint else "http://" + endpoint
        )
        self.secure = parsed.scheme == "https"
        self.netloc = parsed.netloc
        self.path = parsed.path or "/"
        self.headers = {"Content-Type": "application/json", **(headers or {})}
        self.n_retries = n_retries
        self.retry_policy_factory = retry_policy
        # one connection timeout: the stdlib client has a single deadline
        # covering connect + request; the stricter of the two applies
        timeouts = [
            t / 1000.0
            for t in (connect_timeout_ms, request_timeout_ms)
            if t is not None
        ]
        self.timeout = min(timeouts) if timeouts else 30
        self._rows: list[dict] = []
        self._lock = threading.Lock()

    def add(self, obj: dict) -> None:
        with self._lock:
            self._rows.append(obj)

    def flush(self, _time: int | None = None) -> None:
        conn_cls = http.client.HTTPSConnection if self.secure else http.client.HTTPConnection
        conn = None
        try:
            while True:
                with self._lock:
                    if not self._rows:
                        return
                    obj = self._rows[0]
                attempts = 0
                proto = self.retry_policy_factory
                if isinstance(proto, type):  # a policy CLASS: fresh default
                    policy = proto.default()
                elif proto is not None:
                    # an instance: copy so each row's retry sequence starts
                    # from the configured first delay (the policy mutates)
                    import copy as _copy

                    policy = _copy.copy(proto)
                else:
                    policy = None
                while True:
                    try:
                        if conn is None:
                            conn = conn_cls(self.netloc, timeout=self.timeout)
                        conn.request(
                            "POST", self.path, body=_json.dumps(obj).encode(), headers=self.headers
                        )
                        resp = conn.getresponse()
                        resp.read()
                        if resp.status >= 300:
                            raise RuntimeError(
                                f"logstash POST failed ({resp.status})"
                            )
                        break
                    except Exception:
                        if conn is not None:
                            conn.close()
                            conn = None
                        attempts += 1
                        if attempts > self.n_retries:
                            raise
                        if policy is not None:
                            _time.sleep(policy.wait_duration_before_retry())
                # drain only after the row is durably posted — a mid-flush
                # failure keeps the remainder for the next flush
                with self._lock:
                    self._rows.pop(0)
        finally:
            if conn is not None:
                conn.close()


def write(
    table: Table,
    endpoint: str,
    n_retries: int = 0,
    retry_policy: Any = None,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int | None = None,
    *,
    headers: dict[str, str] | None = None,
    name: str | None = None,
    _sink_factory: Any = None,
) -> None:
    if retry_policy is None:
        from pathway_tpu_torch.io.http import RetryPolicy

        retry_policy = RetryPolicy
    names = table.column_names()
    sink = (_sink_factory or _HttpSink)(
        endpoint,
        headers,
        n_retries=n_retries,
        retry_policy=retry_policy,
        connect_timeout_ms=connect_timeout_ms,
        request_timeout_ms=request_timeout_ms,
    )

    def on_data(key, row, time, diff):
        obj = {n: _plain(v) for n, v in zip(names, row)}
        obj["time"], obj["diff"] = time, diff
        sink.add(obj)

    _utils.register_output(
        table, on_data, on_time_end=sink.flush, on_end=sink.flush, name=name or "logstash"
    )
