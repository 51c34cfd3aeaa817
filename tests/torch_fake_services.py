"""In-process stand-ins for a Kafka broker and an S3 endpoint.

Shared by the port's CPU tests and ``chip_smoke.py``'s ``[kafka]`` phase.
Standard library only: this module imports neither ``pathway_tpu`` nor
``pathway_tpu_torch``.

``KafkaBroker`` keeps topics of partitioned logs, per-group committed
offsets and message timestamps, and hands out a module-shaped client with
kafka-python's API (``KafkaConsumer``, ``KafkaProducer``,
``TopicPartition``, ``OffsetAndMetadata``).  Install it through a
package's seam: ``monkeypatch.setattr(kafka_mod, "_get_client",
broker.get_client)``.  A subscribed consumer is given every partition of
its topics (no group rebalancing); a manual ``assign`` takes the listed
ones.  A new position starts at the group's committed offset, else at
``auto_offset_reset`` (``"latest"`` by default, as kafka-python).  A
broker made ``finite`` raises ``TopicDrained`` from a poll that finds
nothing left; a reader's ``run`` wrapped by ``until_drained`` then returns,
and the source finishes, so a test run over pre-produced topics ends.

``S3Server`` serves path-style PUT, GET, ListObjectsV2 and DELETE on
127.0.0.1 and verifies every request's SigV4 ``Authorization`` header by
recomputing it from the request (AWS's published signing steps): a bad or
missing signature is answered 403.  It counts requests and bytes.

The sinks' servers, each on 127.0.0.1, count sessions or requests and
bytes and keep their net state:

- ``PgServer`` speaks the PostgreSQL v3 protocol: startup, then trust,
  MD5 or SCRAM-SHA-256 (RFC 5802/7677: it verifies the client's proof
  and signs its final message, so a client that checks the server
  signature is held to it), then simple queries.  Each statement runs in
  an in-memory ``sqlite3`` database (``::type`` casts stripped), so a
  table's rows are its net state; a transaction holds the database from
  ``BEGIN`` to ``COMMIT`` and a failed statement aborts it, as in
  PostgreSQL.  A wrong password or proof is answered ``28P01``.
- ``MongoServer`` speaks OP_MSG with its own BSON codec: SCRAM-SHA-256
  (``saslStart``/``saslContinue``, the proof verified, the server
  signature sent) when made with a user, then ``insert`` and ``delete``
  on documents by ``_id``.  A command before authentication is refused
  (code 13), a duplicate ``_id`` is a write error (11000).
- ``EsServer`` serves ``POST /<index>/_bulk``: NDJSON ``index`` and
  ``delete`` actions on documents by id, behind HTTP basic auth (or an
  API key); a wrong ``Authorization`` is answered 401.
- ``LogstashServer`` takes JSON bodies by POST on any path and keeps them.
"""

from __future__ import annotations

import base64
import collections
import datetime
import hashlib
import hmac
import http.server
import json
import re
import socket
import sqlite3
import struct
import threading
import time
import urllib.parse
import zlib

TopicPartition = collections.namedtuple("TopicPartition", "topic partition")
OffsetAndMetadata = collections.namedtuple("OffsetAndMetadata", "offset metadata leader_epoch")
OffsetAndTimestamp = collections.namedtuple("OffsetAndTimestamp", "offset timestamp")
ConsumerRecord = collections.namedtuple(
    "ConsumerRecord", "topic partition offset timestamp key value headers"
)


class TopicDrained(Exception):
    """A finite broker's poll found nothing left to read."""


def until_drained(run):
    """A reader's ``run`` that returns once its finite topic is drained."""

    def wrapped(reader, emit):
        try:
            return run(reader, emit)
        except TopicDrained:
            return None

    return wrapped


class KafkaBroker:
    """Partitioned topics, group offsets and timestamps behind a lock."""

    def __init__(self, finite: bool = False):
        self.finite = finite
        self.cond = threading.Condition()
        self.topics: dict[str, list[list[ConsumerRecord]]] = {}
        self.committed: dict[str, dict[TopicPartition, int]] = {}
        self.consumers: list[_Consumer] = []
        self._rr = 0
        self.client = _client_module(self)

    def get_client(self):
        """What a package's ``kafka._get_client`` returns."""
        return ("kafka-python", self.client)

    def create_topic(self, name: str, partitions: int = 1) -> None:
        with self.cond:
            self.topics.setdefault(name, [[] for _ in range(partitions)])

    def produce(self, topic, value, key=None, partition=None, timestamp_ms=None, headers=None):
        """Append one message; ``(partition, offset)``.  A keyed message goes
        to ``crc32(key) % partitions``, an unkeyed one round-robin."""
        with self.cond:
            parts = self.topics.setdefault(topic, [[]])
            if partition is None:
                if key is not None:
                    partition = zlib.crc32(key) % len(parts)
                else:
                    partition, self._rr = self._rr % len(parts), self._rr + 1
            log = parts[partition]
            ts = int(time.time() * 1000) if timestamp_ms is None else int(timestamp_ms)
            log.append(ConsumerRecord(topic, partition, len(log), ts, key, value, headers or []))
            self.cond.notify_all()
            return partition, len(log) - 1

    def messages(self, topic: str) -> list[ConsumerRecord]:
        with self.cond:
            return [m for part in self.topics.get(topic, []) for m in part]

    def committed_offsets(self, group: str, topic: str | None = None) -> dict[int, int]:
        with self.cond:
            got = self.committed.get(group, {})
            return {tp.partition: off for tp, off in got.items() if topic is None or tp.topic == topic}

    def park_consumers(self, settle_s: float = 0.0) -> int:
        """Every consumer made so far parks: a poll under way returns at
        once, the next one returns nothing, and the one after blocks for
        good.  A run that ended leaves its reader threads polling; parked,
        they take no more messages and commit nothing.  With ``settle_s``,
        waits that long at most for each consumer to block: its reader has
        then been once through its loop since the park, so a commit of
        offsets acknowledged before it has landed.  Returns the consumers
        not blocked (a drained reader polls no more)."""
        deadline = time.monotonic() + settle_s
        with self.cond:
            for c in self.consumers:
                if c.park_after is None:
                    c.park_after = c.polls + 1
            self.cond.notify_all()
            while True:
                left = [c for c in self.consumers if not c.parked]
                wait = deadline - time.monotonic()
                if not left or wait <= 0:
                    return len(left)
                self.cond.wait(wait)


class _Consumer:
    def __init__(self, broker: KafkaBroker, *topics, group_id=None, auto_offset_reset="latest",
                 max_poll_records=500, enable_auto_commit=True, **_kw):
        self.broker = broker
        self.group_id = group_id
        self.reset = auto_offset_reset
        self.max_poll_records = max_poll_records
        self.subscribed: list[str] = list(topics)
        self.assigned: list[TopicPartition] | None = None
        self.positions: dict[TopicPartition, int] = {}
        self.polls = 0
        self.park_after: int | None = None  # polls past this one block (``park_consumers``)
        self.parked = False
        with broker.cond:
            broker.consumers.append(self)

    # -- assignment --

    def subscribe(self, topics=(), pattern=None, listener=None):
        self.subscribed, self.assigned = list(topics), None

    def unsubscribe(self):
        self.subscribed = []

    def assign(self, partitions):
        self.assigned = [TopicPartition(tp.topic, tp.partition) for tp in partitions]
        self.subscribed = []

    def assignment(self) -> set:
        with self.broker.cond:
            if self.assigned is not None:
                return set(self.assigned)
            return {TopicPartition(t, p) for t in self.subscribed
                    for p in range(len(self.broker.topics.get(t, [])))}

    def partitions_for_topic(self, topic):
        with self.broker.cond:
            parts = self.broker.topics.get(topic)
            return set(range(len(parts))) if parts else None

    # -- positions --

    def _position(self, tp: TopicPartition) -> int:
        if tp not in self.positions:
            committed = self.broker.committed.get(self.group_id, {}) if self.group_id else {}
            if tp in committed:
                self.positions[tp] = committed[tp]
            elif self.reset == "earliest":
                self.positions[tp] = 0
            else:
                self.positions[tp] = len(self.broker.topics[tp.topic][tp.partition])
        return self.positions[tp]

    def position(self, tp):
        with self.broker.cond:
            return self._position(TopicPartition(tp.topic, tp.partition))

    def seek(self, tp, offset):
        self.positions[TopicPartition(tp.topic, tp.partition)] = int(offset)

    def seek_to_end(self, *tps):
        with self.broker.cond:
            for tp in tps or self.assignment():
                self.positions[tp] = len(self.broker.topics[tp.topic][tp.partition])

    def offsets_for_times(self, timestamps: dict) -> dict:
        out = {}
        with self.broker.cond:
            for tp, ts in timestamps.items():
                log = self.broker.topics[tp.topic][tp.partition]
                hit = next((m for m in log if m.timestamp >= ts), None)
                out[tp] = OffsetAndTimestamp(hit.offset, hit.timestamp) if hit else None
        return out

    # -- reading and committing --

    def poll(self, timeout_ms=0, max_records=None):
        """Up to ``max_poll_records`` records, taken a partition at a time in
        turn, waiting up to ``timeout_ms`` for the first one."""
        limit = max_records or self.max_poll_records
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self.broker.cond:
            self.polls += 1
            if self.park_after is not None:
                if self.polls > self.park_after:
                    self.parked = True
                    self.broker.cond.notify_all()
                    while True:
                        self.broker.cond.wait()
                return {}
            while True:
                out: dict[TopicPartition, list] = {}
                taken, progress = 0, True
                tps = sorted(self.assignment())
                while taken < limit and progress:
                    progress = False
                    for tp in tps:
                        log = self.broker.topics[tp.topic][tp.partition]
                        pos = self._position(tp)
                        if pos < len(log) and taken < limit:
                            out.setdefault(tp, []).append(log[pos])
                            self.positions[tp] = pos + 1
                            taken += 1
                            progress = True
                if not out and self.broker.finite:
                    raise TopicDrained(sorted(tps))
                left = deadline - time.monotonic()
                if out or left <= 0 or self.park_after is not None:
                    return out
                self.broker.cond.wait(left)

    def commit(self, offsets=None):
        if not self.group_id:
            raise AssertionError("kafka-python: commit() requires a group_id")
        with self.broker.cond:
            if offsets is None:
                offsets = {tp: OffsetAndMetadata(pos, "", -1) for tp, pos in self.positions.items()}
            plain = {TopicPartition(tp.topic, tp.partition): int(om.offset) for tp, om in offsets.items()}
            self.broker.committed.setdefault(self.group_id, {}).update(plain)


class _Producer:
    def __init__(self, broker: KafkaBroker, **_kw):
        self.broker = broker

    def send(self, topic, value=None, key=None, headers=None, partition=None, timestamp_ms=None):
        self.broker.produce(topic, value, key=key, partition=partition, timestamp_ms=timestamp_ms, headers=headers)

    def flush(self, timeout=None):
        pass

    def close(self, timeout=None):
        pass


def _client_module(broker: KafkaBroker):
    """A namespace shaped like the ``kafka`` (kafka-python) module."""

    class KafkaConsumer(_Consumer):
        def __init__(self, *topics, **kw):
            super().__init__(broker, *topics, **kw)

    class KafkaProducer(_Producer):
        def __init__(self, **kw):
            super().__init__(broker, **kw)

    class _Module:
        pass

    mod = _Module()
    mod.KafkaConsumer, mod.KafkaProducer = KafkaConsumer, KafkaProducer
    mod.TopicPartition, mod.OffsetAndMetadata = TopicPartition, OffsetAndMetadata
    return mod


# ---------------------------------------------------------------------------
# S3
# ---------------------------------------------------------------------------


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_authorization(method: str, raw_path: str, query: list[tuple[str, str]], headers: dict,
                        signed: list[str], access_key: str, secret_key: str, region: str) -> str:
    """The ``Authorization`` value AWS's SigV4 steps give for this request:
    ``raw_path`` is the URI as sent (already percent-encoded), ``query`` the
    decoded pairs, ``headers`` lower-cased names to values."""
    enc = lambda s: urllib.parse.quote(s, safe="-_.~")  # noqa: E731
    canonical_query = "&".join(f"{enc(k)}={enc(v)}" for k, v in sorted(query))
    canonical_headers = "".join(f"{h}:{' '.join(headers[h].split())}\n" for h in signed)
    payload = headers.get("x-amz-content-sha256", "UNSIGNED-PAYLOAD")
    request = "\n".join([method, raw_path, canonical_query, canonical_headers, ";".join(signed), payload])
    amz_date = headers["x-amz-date"]
    scope = f"{amz_date[:8]}/{region}/s3/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope, hashlib.sha256(request.encode()).hexdigest()])
    key = ("AWS4" + secret_key).encode()
    for part in (amz_date[:8], region, "s3", "aws4_request"):
        key = _hmac(key, part)
    sig = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()
    return f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, SignedHeaders={';'.join(signed)}, Signature={sig}"


class S3Server:
    """A path-style S3 endpoint on 127.0.0.1 for one access key."""

    def __init__(self, access_key: str = "AK", secret_key: str = "SK", region: str = "us-east-1"):
        self.access_key, self.secret_key, self.region = access_key, secret_key, region
        self.objects: dict[tuple[str, str], bytes] = {}
        self.lock = threading.RLock()
        self.requests: collections.Counter = collections.Counter()
        self.bytes_in = self.bytes_out = 0
        self.rejected = 0
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, status: int, body: bytes = b"") -> None:
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)
                with server.lock:
                    server.bytes_out += len(body)

            def _handle(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                raw_path, _, raw_query = self.path.partition("?")
                query = urllib.parse.parse_qsl(raw_query, keep_blank_values=True)
                with server.lock:
                    server.requests[self.command] += 1
                    server.bytes_in += len(body)
                if not server._authorized(self.command, raw_path, query, self.headers, body):
                    with server.lock:
                        server.rejected += 1
                    return self._reply(403, b"<Error><Code>SignatureDoesNotMatch</Code></Error>")
                bucket, _, key = urllib.parse.unquote(raw_path).lstrip("/").partition("/")
                q = dict(query)
                with server.lock:
                    if self.command == "PUT":
                        server.objects[(bucket, key)] = body
                        return self._reply(200)
                    if self.command == "DELETE":
                        server.objects.pop((bucket, key), None)
                        return self._reply(204)
                    if self.command == "GET" and q.get("list-type") == "2":
                        return self._reply(200, server._listing(bucket, q))
                    data = server.objects.get((bucket, key))
                if data is None:
                    return self._reply(404, b"<Error><Code>NoSuchKey</Code></Error>")
                return self._reply(200, data)

            do_PUT = do_GET = do_DELETE = _handle

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.endpoint = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def _authorized(self, method, raw_path, query, headers, body) -> bool:
        auth = headers.get("Authorization") or ""
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return False
        try:
            fields = dict(part.strip().split("=", 1) for part in auth[len("AWS4-HMAC-SHA256 "):].split(","))
            signed = fields["SignedHeaders"].split(";")
            lower = {k.lower(): v for k, v in headers.items()}
            if lower.get("x-amz-content-sha256") != hashlib.sha256(body).hexdigest():
                return False
            want = sigv4_authorization(method, raw_path, query, lower, signed,
                                       self.access_key, self.secret_key, self.region)
        except (KeyError, ValueError):
            return False
        return hmac.compare_digest(auth, want)

    def _listing(self, bucket: str, q: dict) -> bytes:
        prefix = q.get("prefix", "")
        stamp = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        items = "".join(
            f"<Contents><Key>{k}</Key><Size>{len(v)}</Size><ETag>&quot;{hashlib.md5(v).hexdigest()}&quot;</ETag>"
            f"<LastModified>{stamp}</LastModified></Contents>"
            for (b, k), v in sorted(self.objects.items()) if b == bucket and k.startswith(prefix)
        )
        return ("<?xml version='1.0'?><ListBucketResult><IsTruncated>false</IsTruncated>"
                f"{items}</ListBucketResult>").encode()

    def stats(self) -> dict:
        with self.lock:
            return {"requests": dict(self.requests), "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                    "rejected": self.rejected, "objects": len(self.objects),
                    "stored_bytes": sum(len(v) for v in self.objects.values())}

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


# ---------------------------------------------------------------------------
# The sinks: PostgreSQL, MongoDB, Elasticsearch, Logstash
# ---------------------------------------------------------------------------


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed")
        buf += chunk
    return buf


def scram_server_keys(password: str, salt: bytes, iters: int) -> tuple[bytes, bytes, bytes]:
    """RFC 5802's ``ClientKey``, ``StoredKey`` and ``ServerKey``."""
    salted = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iters)
    client_key = hmac.digest(salted, b"Client Key", "sha256")
    return client_key, hashlib.sha256(client_key).digest(), hmac.digest(salted, b"Server Key", "sha256")


def scram_verify(stored_key: bytes, auth_message: bytes, proof: bytes) -> bool:
    """Whether ``proof`` is the client proof of ``auth_message``: the
    client key it carries hashes to ``stored_key``."""
    signature = hmac.digest(stored_key, auth_message, "sha256")
    client_key = bytes(a ^ b for a, b in zip(proof, signature))
    return len(proof) == 32 and hmac.compare_digest(hashlib.sha256(client_key).digest(), stored_key)


class _Listener:
    """A TCP listener on 127.0.0.1 with a thread a connection."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.lock = threading.RLock()
        self.sessions = self.authenticated = self.rejected = 0
        self.bytes_in = self.bytes_out = 0
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with self.lock:
                self.sessions += 1
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)  # as the real servers do
        try:
            self.handle(conn)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _recv(self, conn, n: int) -> bytes:
        data = _recv_exact(conn, n)
        with self.lock:
            self.bytes_in += n
        return data

    def _send(self, conn, data: bytes) -> None:
        conn.sendall(data)
        with self.lock:
            self.bytes_out += len(data)

    def close(self) -> None:
        self.sock.close()


_CAST = re.compile(r"('(?:[^']|'')*')::\w+")


class PgServer(_Listener):
    """PostgreSQL's v3 protocol for one user (``auth`` ``"trust"``,
    ``"md5"`` or ``"scram"``) over an in-memory ``sqlite3`` database."""

    SALT, ITERS = b"pathway-fake-pg!", 4096

    def __init__(self, auth: str = "scram", user: str = "pathway", password: str = "secret", on_commit=None):
        self.auth, self.user, self.password = auth, user, password
        self.on_commit = on_commit  # called as on_commit(server) after each COMMIT, the database held
        self.db = sqlite3.connect(":memory:", check_same_thread=False, isolation_level=None)
        self.db_lock = threading.Lock()  # a transaction holds it from BEGIN to its end
        self.statements: list[str] = []
        self.errors: list[str] = []
        self.transactions = 0
        super().__init__()

    # -- the database, from the test's side --------------------------------
    def execute(self, sql: str) -> list[tuple]:
        with self.db_lock:
            return self.db.execute(_CAST.sub(r"\1", sql)).fetchall()

    def rows(self, table: str) -> list[tuple]:
        """The table's net rows, sorted."""
        return sorted(self.execute(f'SELECT * FROM "{table}"'), key=repr)

    def stats(self) -> dict:
        with self.lock:
            return {"sessions": self.sessions, "authenticated": self.authenticated, "rejected": self.rejected,
                    "statements": len(self.statements), "transactions": self.transactions,
                    "errors": len(self.errors), "bytes_in": self.bytes_in, "bytes_out": self.bytes_out}

    # -- the protocol --------------------------------------------------------
    def _msg(self, conn) -> tuple[bytes, bytes]:
        tag = self._recv(conn, 1)
        (n,) = struct.unpack("!I", self._recv(conn, 4))
        return tag, self._recv(conn, n - 4)

    def _out(self, conn, tag: bytes, payload: bytes = b"") -> None:
        self._send(conn, tag + struct.pack("!I", len(payload) + 4) + payload)

    def _error(self, conn, code: str, message: str, fatal: bool = False) -> None:
        severity = b"FATAL" if fatal else b"ERROR"
        self._out(conn, b"E", b"S" + severity + b"\0C" + code.encode() + b"\0M" + message.encode() + b"\0\0")

    def _login(self, conn) -> bool:
        (n,) = struct.unpack("!I", self._recv(conn, 4))
        body = self._recv(conn, n - 4)
        parts = body[4:].split(b"\0")
        params = dict(zip(parts[0::2], parts[1::2]))
        if struct.unpack("!I", body[:4])[0] != 196608 or params.get(b"user", b"").decode() != self.user:
            self._error(conn, "28000", "unknown user or protocol", fatal=True)
            return False
        if self.auth == "md5":
            salt = b"pwfk"
            self._out(conn, b"R", struct.pack("!I", 5) + salt)
            _tag, payload = self._msg(conn)
            inner = hashlib.md5(self.password.encode() + self.user.encode()).hexdigest()
            if payload.rstrip(b"\0").decode() != "md5" + hashlib.md5(inner.encode() + salt).hexdigest():
                self._error(conn, "28P01", "password authentication failed", fatal=True)
                return False
        elif self.auth == "scram":
            self._out(conn, b"R", struct.pack("!I", 10) + b"SCRAM-SHA-256\0\0")
            _tag, payload = self._msg(conn)
            mech, _, rest = payload.partition(b"\0")
            (mlen,) = struct.unpack("!I", rest[:4])
            client_first = rest[4 : 4 + mlen].decode()
            if mech != b"SCRAM-SHA-256" or not client_first.startswith("n,,"):
                self._error(conn, "28000", "bad SASL start", fatal=True)
                return False
            client_bare = client_first[3:]
            nonce = dict(kv.split("=", 1) for kv in client_bare.split(","))["r"] + "fakepg"
            server_first = f"r={nonce},s={base64.b64encode(self.SALT).decode()},i={self.ITERS}"
            self._out(conn, b"R", struct.pack("!I", 11) + server_first.encode())
            _tag, payload = self._msg(conn)
            without_proof, _, proof = payload.decode().rpartition(",p=")
            _ck, stored, server_key = scram_server_keys(self.password, self.SALT, self.ITERS)
            auth_message = ",".join([client_bare, server_first, without_proof]).encode()
            if without_proof != f"c=biws,r={nonce}" or not scram_verify(stored, auth_message, base64.b64decode(proof)):
                self._error(conn, "28P01", "password authentication failed", fatal=True)
                return False
            signature = hmac.digest(server_key, auth_message, "sha256")
            self._out(conn, b"R", struct.pack("!I", 12) + b"v=" + base64.b64encode(signature))
        self._out(conn, b"R", struct.pack("!I", 0))
        self._out(conn, b"S", b"server_version\x0016.0\0")
        self._out(conn, b"Z", b"I")
        return True

    def handle(self, conn) -> None:
        if not self._login(conn):
            with self.lock:
                self.rejected += 1
            return
        with self.lock:
            self.authenticated += 1
        state = "I"  # I idle, T in a transaction, E in a failed one
        try:
            while True:
                tag, payload = self._msg(conn)
                if tag == b"X":
                    return
                if tag != b"Q":
                    self._error(conn, "08P01", f"unexpected message {tag!r}")
                    self._out(conn, b"Z", state.encode())
                    continue
                sql = payload.rstrip(b"\0").decode()
                with self.lock:
                    self.statements.append(sql)
                state = self._query(conn, sql, state)
                self._out(conn, b"Z", state.encode())
        finally:
            if state != "I":
                self.db.execute("ROLLBACK")
                self.db_lock.release()

    def _query(self, conn, sql: str, state: str) -> str:
        word = sql.split(None, 1)[0].upper() if sql.strip() else ""
        if word == "BEGIN":
            if state == "I":
                self.db_lock.acquire()
                self.db.execute("BEGIN")
            self._out(conn, b"C", b"BEGIN\0")
            return "T" if state == "I" else state
        if word in ("COMMIT", "ROLLBACK"):
            if state == "I":
                self._out(conn, b"C", word.encode() + b"\0")
                return "I"
            committed = word == "COMMIT" and state == "T"
            try:
                self.db.execute("COMMIT" if committed else "ROLLBACK")
                if committed:
                    with self.lock:
                        self.transactions += 1
                    if self.on_commit is not None:
                        self.on_commit(self)
            finally:
                self.db_lock.release()
            self._out(conn, b"C", (b"COMMIT" if committed else b"ROLLBACK") + b"\0")
            return "I"
        if state == "E":
            self._error(conn, "25P02", "current transaction is aborted, commands ignored until end of transaction block")
            return "E"
        try:
            if state == "I":
                with self.db_lock:
                    cur = self.db.execute(_CAST.sub(r"\1", sql))
                    rows = cur.fetchall()
            else:
                cur = self.db.execute(_CAST.sub(r"\1", sql))
                rows = cur.fetchall()
        except sqlite3.Error as exc:
            with self.lock:
                self.errors.append(f"{sql[:200]}: {exc}")
            self._error(conn, "42601" if isinstance(exc, sqlite3.OperationalError) else "23505", str(exc))
            return "E" if state == "T" else state
        if cur.description:
            names = b"".join(d[0].encode() + b"\0" + struct.pack("!IhIhih", 0, 0, 25, -1, -1, 0)
                             for d in cur.description)
            self._out(conn, b"T", struct.pack("!H", len(cur.description)) + names)
            for row in rows:
                cells = b"".join(struct.pack("!i", -1) if v is None else
                                 struct.pack("!i", len(str(v).encode())) + str(v).encode() for v in row)
                self._out(conn, b"D", struct.pack("!H", len(row)) + cells)
            done = f"SELECT {len(rows)}"
        elif word == "INSERT":
            done = f"INSERT 0 {cur.rowcount}"
        else:
            done = f"{word} {max(cur.rowcount, 0)}" if word in ("DELETE", "UPDATE") else word
        self._out(conn, b"C", done.encode() + b"\0")
        return state


# -- BSON (the spec's subset a row sink and SCRAM use) ----------------------


def bson_encode(doc: dict) -> bytes:
    out = b""
    for k, v in doc.items():
        key = k.encode() + b"\0"
        if v is None:
            out += b"\x0a" + key
        elif isinstance(v, bool):
            out += b"\x08" + key + (b"\x01" if v else b"\x00")
        elif isinstance(v, int):
            out += (b"\x10" + key + struct.pack("<i", v)) if -(2**31) <= v < 2**31 else \
                (b"\x12" + key + struct.pack("<q", v))
        elif isinstance(v, float):
            out += b"\x01" + key + struct.pack("<d", v)
        elif isinstance(v, str):
            data = v.encode() + b"\0"
            out += b"\x02" + key + struct.pack("<i", len(data)) + data
        elif isinstance(v, bytes):
            out += b"\x05" + key + struct.pack("<i", len(v)) + b"\x00" + v
        elif isinstance(v, dict):
            out += b"\x03" + key + bson_encode(v)
        elif isinstance(v, (list, tuple)):
            out += b"\x04" + key + bson_encode({str(i): x for i, x in enumerate(v)})
        else:
            raise TypeError(f"bson_encode: {type(v).__name__}")
    return struct.pack("<i", len(out) + 5) + out + b"\0"


def bson_decode(buf: bytes, pos: int = 0) -> tuple[dict, int]:
    (total,) = struct.unpack_from("<i", buf, pos)
    end, pos, doc = pos + total - 1, pos + 4, {}
    while pos < end:
        t = buf[pos]
        zero = buf.index(b"\0", pos + 1)
        key, pos = buf[pos + 1 : zero].decode(), zero + 1
        if t == 0x01:
            (doc[key],), pos = struct.unpack_from("<d", buf, pos), pos + 8
        elif t == 0x02:
            (n,) = struct.unpack_from("<i", buf, pos)
            doc[key], pos = buf[pos + 4 : pos + 3 + n].decode(), pos + 4 + n
        elif t in (0x03, 0x04):
            sub, pos = bson_decode(buf, pos)
            doc[key] = [sub[str(i)] for i in range(len(sub))] if t == 0x04 else sub
        elif t == 0x05:
            (n,) = struct.unpack_from("<i", buf, pos)
            doc[key], pos = buf[pos + 5 : pos + 5 + n], pos + 5 + n
        elif t == 0x08:
            doc[key], pos = buf[pos] == 1, pos + 1
        elif t == 0x09:
            (ms,) = struct.unpack_from("<q", buf, pos)
            doc[key], pos = datetime.datetime.fromtimestamp(ms / 1000, tz=datetime.timezone.utc), pos + 8
        elif t == 0x0A:
            doc[key] = None
        elif t == 0x10:
            (doc[key],), pos = struct.unpack_from("<i", buf, pos), pos + 4
        elif t == 0x12:
            (doc[key],), pos = struct.unpack_from("<q", buf, pos), pos + 8
        else:
            raise ValueError(f"bson_decode: type 0x{t:02x}")
    return doc, end + 1


class MongoServer(_Listener):
    """OP_MSG commands on collections of documents by ``_id``; SCRAM-SHA-256
    for ``user`` (on its ``auth_db``) when one is given."""

    SALT, ITERS = b"pathway-fake-mongo", 4096

    def __init__(self, user: str | None = None, password: str = "", auth_db: str = "admin"):
        self.user, self.password, self.auth_db = user, password, auth_db
        self.collections: dict[tuple[str, str], dict] = {}
        self.commands: list[dict] = []
        self.requests = 0
        super().__init__()

    def documents(self, db: str, collection: str) -> dict:
        with self.lock:
            return dict(self.collections.get((db, collection), {}))

    def stats(self) -> dict:
        with self.lock:
            return {"sessions": self.sessions, "authenticated": self.authenticated, "rejected": self.rejected,
                    "requests": self.requests, "commands": collections.Counter(next(iter(c)) for c in self.commands),
                    "bytes_in": self.bytes_in, "bytes_out": self.bytes_out}

    def handle(self, conn) -> None:
        session = {"authed": self.user is None}
        while True:
            length, req_id, _to, opcode = struct.unpack("<iiii", self._recv(conn, 16))
            payload = self._recv(conn, length - 16)
            if opcode != 2013 or payload[4] != 0:
                raise ConnectionError(f"unexpected opcode {opcode}")
            doc, _ = bson_decode(payload, 5)
            with self.lock:
                self.requests += 1
                self.commands.append(doc)
            reply = self._command(doc, session)
            body = struct.pack("<I", 0) + b"\x00" + bson_encode(reply)
            self._send(conn, struct.pack("<iiii", 16 + len(body), req_id + 1000, req_id, 2013) + body)

    def _command(self, doc: dict, session: dict) -> dict:
        name = next(iter(doc))
        if name == "saslStart":
            client_first = bytes(doc["payload"]).decode()
            bare = client_first[3:]
            fields = dict(kv.split("=", 1) for kv in bare.split(","))
            if doc.get("mechanism") != "SCRAM-SHA-256" or fields.get("n") != self.user or doc["$db"] != self.auth_db:
                return self._refuse("bad saslStart", 18)
            nonce = fields["r"] + "fakemongo"
            server_first = f"r={nonce},s={base64.b64encode(self.SALT).decode()},i={self.ITERS}"
            session.update(bare=bare, server_first=server_first, nonce=nonce)
            return {"conversationId": 1, "done": False, "payload": server_first.encode(), "ok": 1.0}
        if name == "saslContinue":
            if "server_first" not in session:
                return self._refuse("no SASL conversation", 17)
            if session.get("signed"):  # the client's closing empty step
                session["authed"] = True
                with self.lock:
                    self.authenticated += 1
                return {"conversationId": 1, "done": True, "payload": b"", "ok": 1.0}
            final = bytes(doc["payload"]).decode()
            without_proof, _, proof = final.rpartition(",p=")
            _ck, stored, server_key = scram_server_keys(self.password, self.SALT, self.ITERS)
            auth_message = ",".join([session["bare"], session["server_first"], without_proof]).encode()
            if without_proof != f"c=biws,r={session['nonce']}" or not scram_verify(stored, auth_message,
                                                                                    base64.b64decode(proof)):
                return self._refuse("Authentication failed.", 18)
            session["signed"] = True
            signature = base64.b64encode(hmac.digest(server_key, auth_message, "sha256"))
            return {"conversationId": 1, "done": False, "payload": b"v=" + signature, "ok": 1.0}
        if not session["authed"]:
            return self._refuse(f"command {name} requires authentication", 13)
        coll = (doc["$db"], doc[name])
        with self.lock:
            docs = self.collections.setdefault(coll, {}) if name in ("insert", "delete") else {}
            if name == "insert":
                errors = []
                for i, d in enumerate(doc["documents"]):
                    if d["_id"] in docs:
                        errors.append({"index": i, "code": 11000, "errmsg": f"E11000 duplicate key {d['_id']}"})
                    else:
                        docs[d["_id"]] = d
                reply = {"n": len(doc["documents"]) - len(errors), "ok": 1.0}
                return dict(reply, writeErrors=errors) if errors else reply
            if name == "delete":
                n = sum(docs.pop(q["q"]["_id"], None) is not None for q in doc["deletes"])
                return {"n": n, "ok": 1.0}
        return {"ok": 1.0}

    def _refuse(self, message: str, code: int) -> dict:
        with self.lock:
            self.rejected += 1
        return {"ok": 0.0, "errmsg": message, "code": code}


class _HttpFake:
    """A ``ThreadingHTTPServer`` on 127.0.0.1 that counts requests and bytes."""

    def __init__(self):
        self.lock = threading.RLock()
        self.requests = self.rejected = self.bytes_in = self.bytes_out = 0
        self.log: list[tuple[float, str, bytes]] = []  # (perf_counter at receipt, path, body)
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True  # as the real servers do

            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                with server.lock:
                    server.requests += 1
                    server.bytes_in += len(body)
                status, out = server.post(self.path, self.headers, body)
                with server.lock:
                    server.bytes_out += len(out)
                    if status >= 400:
                        server.rejected += 1
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.endpoint = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stats(self) -> dict:
        with self.lock:
            return {"requests": self.requests, "rejected": self.rejected,
                    "bytes_in": self.bytes_in, "bytes_out": self.bytes_out}

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


class EsServer(_HttpFake):
    """Elasticsearch's ``_bulk`` API behind basic auth for ``user`` (or the
    API key ``api_key`` as ``(id, key)``)."""

    def __init__(self, user: str = "elastic", password: str = "secret", api_key: tuple | None = None):
        token = f"{api_key[0]}:{api_key[1]}" if api_key else f"{user}:{password}"
        self.authorization = ("ApiKey " if api_key else "Basic ") + base64.b64encode(token.encode()).decode()
        self.indices: dict[str, dict] = {}
        self.actions: collections.Counter = collections.Counter()
        super().__init__()

    def documents(self, index: str) -> dict:
        with self.lock:
            return dict(self.indices.get(index, {}))

    def stats(self) -> dict:
        return dict(super().stats(), actions=dict(self.actions))

    def post(self, path: str, headers, body: bytes) -> tuple[int, bytes]:
        if not hmac.compare_digest(headers.get("Authorization") or "", self.authorization):
            return 401, b'{"error": "security_exception", "status": 401}'
        index, _, op = path.lstrip("/").partition("/")
        if op != "_bulk" or headers.get("Content-Type") != "application/x-ndjson":
            return 400, b'{"error": "only NDJSON _bulk is served", "status": 400}'
        lines = [json.loads(line) for line in body.splitlines() if line.strip()]
        items, at = [], 0
        now = time.perf_counter()
        with self.lock:
            self.log.append((now, path, body))
            while at < len(lines):
                (kind, meta), = lines[at].items()
                docs = self.indices.setdefault(meta.get("_index", index), {})
                self.actions[kind] += 1
                if kind == "index":
                    docs[meta["_id"]] = lines[at + 1]
                    items.append({"index": {"_id": meta["_id"], "status": 201}})
                    at += 2
                elif kind == "delete":
                    found = docs.pop(meta["_id"], None) is not None
                    items.append({"delete": {"_id": meta["_id"], "status": 200 if found else 404}})
                    at += 1
                else:
                    return 400, json.dumps({"error": f"action {kind}", "status": 400}).encode()
        return 200, json.dumps({"took": 1, "errors": False, "items": items}).encode()


class LogstashServer(_HttpFake):
    """Logstash's HTTP input: one JSON body a POST, kept with its path."""

    def __init__(self):
        self.events: list[tuple[str, dict]] = []
        super().__init__()

    def post(self, path: str, headers, body: bytes) -> tuple[int, bytes]:
        try:
            event = json.loads(body)
        except ValueError:
            return 400, b'{"error": "not JSON"}'
        with self.lock:
            self.log.append((time.perf_counter(), path, body))
            self.events.append((path, event))
        return 200, b"ok"
