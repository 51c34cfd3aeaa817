"""NATS messaging connector (parity: python/pathway/io/nats;
engine ``NatsReader`` ``src/connectors/data_storage.rs:1740`` /
``NatsWriter`` ``:1810``).

Speaks the NATS text protocol directly over a socket — no client library:
``CONNECT`` / ``SUB`` / ``PUB`` / ``MSG`` / ``PING``/``PONG`` per the
public protocol docs.  The reader subscribes (optionally in a queue group
so multi-worker runs stripe messages like the reference's consumer
striping); the writer publishes one JSON payload per change-stream row.
"""

from __future__ import annotations

import json as _json
import socket
import threading
from typing import Any

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._utils import COMMIT, Reader

__all__ = ["read", "write"]


class NatsError(RuntimeError):
    pass


class NatsClosed(NatsError):
    """Server closed the connection (EOF) — end-of-stream, not an error:
    the read loop finishes cleanly instead of burning the reader's
    consecutive-error budget on reconnect attempts."""


class _NatsConn:
    def __init__(self, uri: str, timeout: float = 15.0):
        import urllib.parse

        parsed = urllib.parse.urlparse(uri if "//" in uri else "nats://" + uri)
        self.sock = socket.create_connection(
            (parsed.hostname or "localhost", parsed.port or 4222), timeout=timeout
        )
        self.sock.settimeout(timeout)
        self._buf = b""
        info = self.read_line()
        if not info.startswith(b"INFO "):
            raise NatsError(f"expected INFO, got {info[:60]!r}")
        options = {"verbose": False, "pedantic": False, "name": "pathway_tpu_torch"}
        if parsed.username:
            options["user"] = urllib.parse.unquote(parsed.username)
            options["pass"] = urllib.parse.unquote(parsed.password or "")
        self.send(b"CONNECT " + _json.dumps(options).encode() + b"\r\n")

    def send(self, data: bytes) -> None:
        self.sock.sendall(data)

    def read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise NatsClosed("connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise NatsClosed("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def close(self) -> None:
        self.sock.close()


class _NatsReader(Reader):
    # NATS core is at-most-once fire-and-forget: no offsets to resume from
    external_resume = True
    # ride out transient server failures (parity: NatsReader
    # data_storage.rs:1788)
    max_allowed_consecutive_errors = 32

    def __init__(
        self,
        uri: str,
        topic: str,
        format: str,
        schema,
        queue_group: str | None,
        json_field_paths: dict | None = None,
    ):
        self.uri = uri
        self.topic = topic
        self.format = format
        self.schema = schema
        self.queue_group = queue_group
        self.json_field_paths = json_field_paths

    def partition(self, worker_id: int, worker_count: int) -> "_NatsReader":
        # all workers subscribe in one queue group: the server load-balances
        # messages across them (the reference's consumer striping analog)
        if self.queue_group is None:
            self.queue_group = "pathway-tpu-workers"
        return self

    def run(self, emit) -> None:
        conn = _NatsConn(self.uri)
        if self.queue_group:
            conn.send(f"SUB {self.topic} {self.queue_group} 1\r\n".encode())
        else:
            conn.send(f"SUB {self.topic} 1\r\n".encode())
        names = list(self.schema.__columns__.keys()) if self.schema else ["data"]
        import time as _time

        last_commit = _time.monotonic()
        # A server-initiated close (EOF) ends the subscription cleanly —
        # NATS core is at-most-once with no replay position, so there is
        # nothing to resume; this holds at ANY byte position (between
        # lines or mid-payload).  Protocol errors (-ERR) and connect
        # failures, by contrast, consume the reader's consecutive-error
        # budget and are retried by the supervisor.
        try:
            while True:
                try:
                    line = conn.read_line()
                except socket.timeout:
                    emit(COMMIT)
                    last_commit = _time.monotonic()
                    continue
                if line.startswith(b"MSG "):
                    parts = line.decode().split(" ")
                    nbytes = int(parts[-1])
                    payload = conn.read_exact(nbytes)
                    conn.read_exact(2)  # trailing \r\n
                    self._emit_payload(payload, names, emit)
                elif line == b"PING":
                    conn.send(b"PONG\r\n")
                elif line.startswith(b"-ERR"):
                    raise NatsError(line.decode())
                if (_time.monotonic() - last_commit) >= 1.0:
                    emit(COMMIT)
                    last_commit = _time.monotonic()
        except NatsClosed:
            return

    def _emit_payload(self, payload: bytes, names, emit) -> None:
        if self.format == "raw":
            emit({"data": payload})
        elif self.format == "plaintext":
            emit({"data": payload.decode("utf-8", errors="replace")})
        else:  # json
            try:
                obj = _json.loads(payload)
            except _json.JSONDecodeError:
                return
            if not isinstance(obj, dict):
                return  # arrays/scalars carry no named columns — skip
            paths = self.json_field_paths
            if paths:
                from pathway_tpu_torch.io.jsonlines import _extract_path

                row = {
                    n: (
                        _extract_path(obj, paths[n])
                        if n in paths
                        else obj.get(n)
                    )
                    for n in names
                }
            else:
                row = {n: obj.get(n) for n in names}
            emit(
                {
                    n: (Json(v) if isinstance(v, (dict, list)) else v)
                    for n, v in row.items()
                }
            )


def read(
    uri: str,
    *,
    topic: str,
    schema: type[schema_mod.Schema] | None = None,
    format: str = "json",
    queue_group: str | None = None,
    json_field_paths: dict | None = None,
    parallel_readers: int | None = None,
    autocommit_duration_ms: int | None = 1500,
    debug_data: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read a NATS subject (parity: pw.io.nats.read).

    ``parallel_readers`` is advisory here: queue-group striping across
    worker processes is this engine's read parallelism.
    """
    if format in ("raw", "plaintext") and schema is None:
        schema = schema_mod.schema_from_types(
            data=bytes if format == "raw" else str
        )
    if schema is None:
        raise ValueError("nats.read with json format requires schema=")
    return _utils.make_input_table(
        schema,
        lambda: _NatsReader(
            uri, topic, format, schema, queue_group,
            json_field_paths=json_field_paths,
        ),
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        debug_data=debug_data,
    )


class _NatsSink:
    def __init__(self, uri: str, topic: str):
        self.uri = uri
        self.topic = topic
        self._conn: _NatsConn | None = None
        self._lock = threading.Lock()
        self._closed = False

    def _drain(self, conn: _NatsConn) -> None:
        # the server PINGs periodically and drops clients that never PONG;
        # a publisher that only writes would be closed as stale mid-stream
        while not self._closed:
            try:
                line = conn.read_line()
            except (NatsError, OSError):
                return
            if line == b"PING":
                with self._lock:
                    try:
                        conn.send(b"PONG\r\n")
                    except OSError:
                        return

    def publish(self, payload: bytes) -> None:
        with self._lock:
            if self._conn is None:
                self._conn = _NatsConn(self.uri)
                self._conn.sock.settimeout(None)  # drain thread blocks
                threading.Thread(
                    target=self._drain, args=(self._conn,), daemon=True
                ).start()
            self._conn.send(
                f"PUB {self.topic} {len(payload)}\r\n".encode() + payload + b"\r\n"
            )

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._conn is not None:
                self._conn.close()
                self._conn = None


def write(
    table: Table,
    uri: str,
    *,
    topic: str,
    format: str = "json",
    delimiter: str = ",",
    value: Any = None,
    headers: Any = None,
    name: str | None = None,
    _sink_factory: Any = None,
) -> None:
    """Publish rows to a NATS subject (parity: pw.io.nats.write).

    ``value`` selects a single column as the raw payload; ``headers``
    (accepted for parity) are not transmitted — core NATS publish as
    implemented here has no header frame (HPUB); a configured header set
    raises rather than being dropped silently.
    """
    if headers:
        raise NotImplementedError(
            "nats.write: headers require the HPUB protocol, which this "
            "client does not speak yet"
        )
    names = table.column_names()
    sink = (_sink_factory or _NatsSink)(uri, topic)
    payload_of = _utils.make_payload_formatter(
        names, format, delimiter=delimiter, value=value, sink="nats.write"
    )

    def on_data(key, row, time, diff):
        sink.publish(payload_of(row, time, diff))

    _utils.register_output(
        table, on_data, on_end=sink.close, name=name or f"nats:{topic}"
    )
