"""HTTP client-side connectors: streaming ``read`` and per-row ``write``.

A copy of ``pathway_tpu/io/http/_client.py`` (parity target:
``python/pathway/io/http/{__init__,_common,_streaming}.py``; the reference
wraps ``requests``, this speaks HTTP via urllib).
"""

from __future__ import annotations

import json as _json
import random
import time
import urllib.error
import urllib.request
from typing import Any, Callable

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table

__all__ = ["RetryPolicy", "read", "write"]


class RetryPolicy:
    """Delay/backoff policy for retried requests (reference _common.py:13)."""

    def __init__(self, first_delay_ms: int, backoff_factor: float, jitter_ms: int):
        self._next_retry_duration = first_delay_ms * 1e-3
        self._backoff_factor = backoff_factor
        self._jitter = jitter_ms * 1e-3

    @classmethod
    def default(cls) -> "RetryPolicy":
        return cls(first_delay_ms=1000, backoff_factor=1.5, jitter_ms=300)

    def wait_duration_before_retry(self) -> float:
        result = self._next_retry_duration
        self._next_retry_duration *= self._backoff_factor
        self._next_retry_duration += random.random() * self._jitter
        return result


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None


class Sender:
    """One configured request channel with retry semantics."""

    def __init__(
        self,
        *,
        request_method: str,
        n_retries: int,
        retry_policy: RetryPolicy,
        connect_timeout_ms: int | None,
        request_timeout_ms: int | None,
        allow_redirects: bool,
        retry_codes: tuple | None,
    ):
        self.method = request_method.upper()
        self.n_retries = n_retries
        self.retry_policy = retry_policy
        # urllib has one deadline knob; the stricter of the two applies
        timeouts = [
            t / 1000.0 for t in (connect_timeout_ms, request_timeout_ms) if t
        ]
        self.timeout = min(timeouts) if timeouts else None
        self.retry_codes = tuple(retry_codes or ())
        self._opener = (
            urllib.request.build_opener()
            if allow_redirects
            else urllib.request.build_opener(_NoRedirect)
        )

    def send(self, url: str, *, headers=None, data=None):
        """Response object (file-like, streamable); raises after retries."""
        body = data
        if isinstance(body, str):
            body = body.encode()
        attempt = 0
        while True:
            req = urllib.request.Request(
                url, data=body, headers=dict(headers or {}), method=self.method
            )
            try:
                return self._opener.open(req, timeout=self.timeout)
            except urllib.error.HTTPError as exc:
                if attempt >= self.n_retries or exc.code not in self.retry_codes:
                    raise
            except urllib.error.URLError:
                if attempt >= self.n_retries:
                    raise
            attempt += 1
            time.sleep(self.retry_policy.wait_duration_before_retry())


def read(
    url: str,
    *,
    schema: type[schema_mod.Schema] | None = None,
    method: str = "GET",
    payload: Any | None = None,
    headers: dict[str, str] | None = None,
    response_mapper: Callable[[bytes], bytes] | None = None,
    format: str = "json",
    delimiter: bytes | str | None = None,
    n_retries: int = 0,
    retry_policy: RetryPolicy | None = None,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int | None = None,
    allow_redirects: bool = True,
    retry_codes: tuple | None = (429, 500, 502, 503, 504),
    autocommit_duration_ms: int = 10000,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Stream a table from an HTTP endpoint: one message per
    ``delimiter``-separated slice of the response body ("json" parses each
    slice into schema columns; "raw"/"plaintext" yield a ``data`` column).
    Parity: ``pw.io.http.read`` (io/http/__init__.py:28)."""
    from pathway_tpu_torch.io import python as io_python

    sender = Sender(
        request_method=method,
        n_retries=n_retries,
        retry_policy=retry_policy or RetryPolicy.default(),
        connect_timeout_ms=connect_timeout_ms,
        request_timeout_ms=request_timeout_ms,
        allow_redirects=allow_redirects,
        retry_codes=retry_codes,
    )
    delim = delimiter.encode() if isinstance(delimiter, str) else (delimiter or b"\n")

    class HttpStreamingSubject(io_python.ConnectorSubject):
        def run(self) -> None:
            response = sender.send(url, headers=headers, data=payload)
            buffer = b""
            while True:
                chunk = response.read(65536)
                if not chunk:
                    break
                buffer += chunk
                while delim in buffer:
                    line, buffer = buffer.split(delim, 1)
                    self._emit_line(line)
                self.commit()
            if buffer:
                self._emit_line(buffer)
            self.commit()

        def _emit_line(self, line: bytes) -> None:
            if response_mapper is not None:
                line = response_mapper(line)
            if not line:
                return
            if format == "json":
                obj = _json.loads(line)
                self.next(**obj)
            elif format == "plaintext":
                self.next(data=line.decode("utf-8", errors="replace"))
            else:
                self.next(data=line)

    if format in ("raw", "plaintext") and schema is None:
        schema = schema_mod.schema_from_types(
            data=bytes if format == "raw" else str
        )
    return io_python.read(
        HttpStreamingSubject(),
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        **kwargs,
    )


def _fill_wildcards(template: str, row: dict) -> str:
    out = template
    for col, value in row.items():
        out = out.replace("{table." + col + "}", str(value))
    return out


def write(
    table: Table,
    url: str,
    *,
    method: str = "POST",
    format: str = "json",
    request_payload_template: str | None = None,
    n_retries: int = 0,
    retry_policy: RetryPolicy | None = None,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int | None = None,
    content_type: str | None = None,
    headers: dict[str, str] | None = None,
    allow_redirects: bool = True,
    retry_codes: tuple | None = (429, 500, 502, 503, 504),
    name: str | None = None,
) -> None:
    """Send every change-stream row as one HTTP request.  ``{table.col}``
    wildcards resolve in the url, headers and the custom payload template.
    Parity: ``pw.io.http.write`` (io/http/__init__.py:145)."""
    from pathway_tpu_torch.io._subscribe import subscribe

    if format not in ("json", "custom"):
        raise ValueError(f"unsupported format {format!r}; use 'json' or 'custom'")
    if format == "custom" and request_payload_template is None:
        raise ValueError("format='custom' requires request_payload_template")

    sender = Sender(
        request_method=method,
        n_retries=n_retries,
        retry_policy=retry_policy or RetryPolicy.default(),
        connect_timeout_ms=connect_timeout_ms,
        request_timeout_ms=request_timeout_ms,
        allow_redirects=allow_redirects,
        retry_codes=retry_codes,
    )
    names = table.column_names()

    def on_change(key, row, time, is_addition):
        from pathway_tpu_torch.io._utils import plain_value

        plain = {n: plain_value(row[n]) for n in names}
        plain["time"] = time
        plain["diff"] = 1 if is_addition else -1
        target = _fill_wildcards(url, plain)
        hdrs = {
            _fill_wildcards(k, plain): _fill_wildcards(v, plain)
            for k, v in (headers or {}).items()
        }
        if format == "json":
            body = _json.dumps(plain)
            hdrs.setdefault("Content-Type", content_type or "application/json")
        else:
            body = _fill_wildcards(request_payload_template, plain)
            if content_type:
                hdrs.setdefault("Content-Type", content_type)
        sender.send(target, headers=hdrs, data=body).read()

    subscribe(table, on_change=on_change)
