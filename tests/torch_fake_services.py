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
"""

from __future__ import annotations

import collections
import datetime
import hashlib
import hmac
import http.server
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
