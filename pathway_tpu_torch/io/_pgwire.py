"""Minimal PostgreSQL v3 wire-protocol client (no external driver).

The reference links the native ``postgres`` crate for its PsqlWriter
(``src/connectors/data_storage.rs:1025``); this build speaks
the protocol directly so ``pw.io.postgres`` works without psycopg.

Supported: startup, auth (trust / cleartext / MD5 / SCRAM-SHA-256), the
simple query protocol, and error surfacing.  That is exactly the surface a
writer executing INSERT/UPDATE/DELETE/DDL batches needs.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import socket
import struct
from typing import Any


class PgError(RuntimeError):
    pass


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise PgError("connection closed by server")
        buf += chunk
    return buf


def _read_message(sock: socket.socket) -> tuple[bytes, bytes]:
    tag = _read_exact(sock, 1)
    (length,) = struct.unpack("!I", _read_exact(sock, 4))
    payload = _read_exact(sock, length - 4) if length > 4 else b""
    return tag, payload


def _cstr(b: bytes) -> str:
    return b.split(b"\0", 1)[0].decode()


class PgConnection:
    """One blocking connection; ``execute`` runs simple-protocol queries."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 5432,
        user: str = "postgres",
        password: str = "",
        dbname: str = "postgres",
        connect_timeout: float = 10.0,
    ):
        self.user = user
        self.password = password
        self.sock = socket.create_connection((host, port), timeout=connect_timeout)
        self.sock.settimeout(connect_timeout)
        self._startup(user, dbname)

    # -- startup & auth --

    def _startup(self, user: str, dbname: str) -> None:
        params = b"user\0" + user.encode() + b"\0database\0" + dbname.encode() + b"\0\0"
        body = struct.pack("!I", 196608) + params  # protocol 3.0
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        while True:
            tag, payload = _read_message(self.sock)
            if tag == b"E":
                raise PgError(self._error_text(payload))
            if tag == b"R":
                (code,) = struct.unpack("!I", payload[:4])
                if code == 0:
                    continue  # AuthenticationOk
                if code == 3:  # cleartext password
                    self._send(b"p", self.password.encode() + b"\0")
                elif code == 5:  # MD5
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        self.password.encode() + self.user.encode()
                    ).hexdigest()
                    digest = hashlib.md5(inner.encode() + salt).hexdigest()
                    self._send(b"p", b"md5" + digest.encode() + b"\0")
                elif code == 10:  # SASL: pick SCRAM-SHA-256
                    mechanisms = [m for m in payload[4:].split(b"\0") if m]
                    if b"SCRAM-SHA-256" not in mechanisms:
                        raise PgError(f"unsupported SASL mechanisms {mechanisms}")
                    self._scram_start()
                elif code == 11:  # SASLContinue
                    self._scram_continue(payload[4:])
                elif code == 12:  # SASLFinal
                    self._scram_final(payload[4:])
                else:
                    raise PgError(f"unsupported auth method {code}")
            elif tag == b"Z":  # ReadyForQuery
                return
            # 'S' ParameterStatus / 'K' BackendKeyData — ignored

    def _scram_start(self) -> None:
        self._client_nonce = base64.b64encode(os.urandom(18)).decode()
        self._client_first_bare = f"n=,r={self._client_nonce}"
        msg = ("n,," + self._client_first_bare).encode()
        body = b"SCRAM-SHA-256\0" + struct.pack("!I", len(msg)) + msg
        self._send(b"p", body)

    def _scram_continue(self, server_first: bytes) -> None:
        fields = dict(kv.split("=", 1) for kv in server_first.decode().split(","))
        nonce, salt, iters = fields["r"], base64.b64decode(fields["s"]), int(fields["i"])
        if not nonce.startswith(self._client_nonce):
            raise PgError("SCRAM server nonce mismatch")
        salted = hashlib.pbkdf2_hmac("sha256", self.password.encode(), salt, iters)
        client_key = hmac.digest(salted, b"Client Key", "sha256")
        stored_key = hashlib.sha256(client_key).digest()
        without_proof = f"c=biws,r={nonce}"
        auth_message = ",".join(
            [self._client_first_bare, server_first.decode(), without_proof]
        ).encode()
        signature = hmac.digest(stored_key, auth_message, "sha256")
        proof = bytes(a ^ b for a, b in zip(client_key, signature))
        server_key = hmac.digest(salted, b"Server Key", "sha256")
        self._server_signature = hmac.digest(server_key, auth_message, "sha256")
        final = f"{without_proof},p={base64.b64encode(proof).decode()}"
        self._send(b"p", final.encode())

    def _scram_final(self, server_final: bytes) -> None:
        fields = dict(kv.split("=", 1) for kv in server_final.decode().split(","))
        if base64.b64decode(fields["v"]) != self._server_signature:
            raise PgError("SCRAM server signature mismatch")

    # -- queries --

    def execute(self, sql: str) -> list[tuple]:
        """Simple-protocol query; returns data rows (as text tuples)."""
        self._send(b"Q", sql.encode() + b"\0")
        rows: list[tuple] = []
        error: str | None = None
        while True:
            tag, payload = _read_message(self.sock)
            if tag == b"E":
                error = self._error_text(payload)
            elif tag == b"D":
                (n,) = struct.unpack("!H", payload[:2])
                off, vals = 2, []
                for _ in range(n):
                    (ln,) = struct.unpack("!i", payload[off : off + 4])
                    off += 4
                    if ln == -1:
                        vals.append(None)
                    else:
                        vals.append(payload[off : off + ln].decode())
                        off += ln
                rows.append(tuple(vals))
            elif tag == b"Z":
                if error is not None:
                    raise PgError(error)
                return rows
            # 'T' RowDescription / 'C' CommandComplete / 'N' Notice — ignored

    def close(self) -> None:
        try:
            self._send(b"X", b"")
        except Exception:
            pass
        self.sock.close()

    # -- helpers --

    def _send(self, tag: bytes, payload: bytes) -> None:
        self.sock.sendall(tag + struct.pack("!I", len(payload) + 4) + payload)

    @staticmethod
    def _error_text(payload: bytes) -> str:
        parts = {}
        for chunk in payload.split(b"\0"):
            if chunk:
                parts[chr(chunk[0])] = chunk[1:].decode(errors="replace")
        return parts.get("M", "postgres error") + (
            f" ({parts['C']})" if "C" in parts else ""
        )


def quote_literal(v: Any) -> str:
    """SQL literal rendering for the simple protocol."""
    import datetime
    import json as _json

    from pathway_tpu_torch.engine.types import Json, Pointer

    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        if v != v:  # NaN
            return "'NaN'::float8"
        if v in (float("inf"), float("-inf")):
            return f"'{'' if v > 0 else '-'}Infinity'::float8"
        return repr(v)
    if isinstance(v, bytes):
        return "'\\x" + v.hex() + "'::bytea"
    if isinstance(v, datetime.datetime):
        return f"'{v.isoformat()}'"
    if isinstance(v, datetime.timedelta):
        return f"'{v.total_seconds()} seconds'::interval"
    if isinstance(v, Json):
        return quote_literal(_json.dumps(v.value)) + "::jsonb"
    if isinstance(v, Pointer):
        return quote_literal(str(v))
    if isinstance(v, tuple):
        return quote_literal(_json.dumps([_plain_json(x) for x in v])) + "::jsonb"
    s = str(v).replace("'", "''")
    return f"'{s}'"


def _plain_json(v: Any):
    from pathway_tpu_torch.engine.types import Json

    if isinstance(v, Json):
        return v.value
    if isinstance(v, tuple):
        return [_plain_json(x) for x in v]
    return v


def quote_ident(name: str) -> str:
    return '"' + name.replace('"', '""') + '"'
