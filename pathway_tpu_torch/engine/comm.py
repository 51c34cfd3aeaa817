"""Host-side worker communication: the TCP exchange mesh.

Parity target: timely's communication crate — zero-copy TCP allocator and
exchange channels routed by key shard
(``external/timely-dataflow/communication/src/allocator/zero_copy/tcp.rs``,
``src/engine/dataflow.rs:1414``).  The design here is different and much
smaller because the engine is epoch-batched (BSP), not asynchronous
record-at-a-time dataflow:

* every process runs the identical script → identical operator DAG, so
  node ids agree across workers (the SPMD invariant of
  ``docs/.../10.worker-architecture.md:36-43``);
* each epoch is a superstep: workers agree on the epoch time (worker 0
  sequences), then walk the DAG in the same topological order, performing
  one all-to-all per exchange point;
* routing is by the 16-bit shard field of the 128-bit row key —
  ``shard_to_worker(key, n)`` — exactly the reference's rule.

Wire format: a mutual HMAC-SHA256 handshake (shared secret from
``PATHWAY_COMM_SECRET``; ``cli spawn`` generates a fresh one per run), a
16-byte **resume header** ``(incarnation, last-seq-received)``, then
16-byte ``(length, sequence)`` headers framing PWT1-typed ``(tag,
payload)`` bodies — the same typed codec the persistence layer uses
(``engine/codec.py``, native-accelerated), matching the reference's typed
bincode exchange rather than trusting arbitrary object streams.
Unauthenticated or malformed peers are rejected before any frame decode.

Fault tolerance (see ``docs/fault_tolerance.md``): a transient link
failure — TCP reset, dropped/corrupted frame — no longer poisons the
mesh.  Every link keeps a bounded retransmit buffer of unacknowledged
frames; heartbeat frames piggyback cumulative acks and detect hung peers;
a failed link reconnects with bounded exponential backoff + jitter (the
``udfs`` retry schedule — one backoff policy for the whole codebase) and
resynchronizes from the peer's last received sequence number, so deltas
are delivered exactly once across the reconnect.  Only when the reconnect
window is exhausted, or the peer comes back as a **new incarnation**
(respawned process), is the peer declared dead — the supervisor
(``engine/supervisor.py``) then restarts the cluster from the last
committed checkpoint.  Everything rides localhost or inter-host TCP;
dense device state never crosses here (it lives on the card and moves
through ``torch.distributed`` collectives — see
``pathway_tpu_torch/parallel/``).
"""

from __future__ import annotations

import hmac as _hmac
import itertools as _itertools
import logging
import math
import os
import secrets as _secrets
import socket
import struct
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable, Hashable

from pathway_tpu_torch.engine import codec as _codec
from pathway_tpu_torch.engine import faults as _faults
from pathway_tpu_torch.engine import flight_recorder as _blackbox
from pathway_tpu_torch.engine import metrics as _metrics
from pathway_tpu_torch.engine.types import SHARD_BITS, shard_to_worker

_log = logging.getLogger("pathway_tpu_torch.comm")

_FRAME = struct.Struct(">Q")  # handshake worker id / heartbeat ack body
_HDR = struct.Struct(">QQ")  # (payload length, sequence); sequence 0 = control
_RESUME = struct.Struct(">QQ")  # (incarnation, last sequence received from you)


def _env_float(name: str, default: float) -> float:
    from pathway_tpu_torch.internals.config import env_float

    return env_float(name, default)


CONNECT_TIMEOUT_S = 60.0
# receive timeout default; per-mesh override via PATHWAY_COMM_RECV_TIMEOUT_S
# (read at mesh construction, like the frame cap below)
RECV_TIMEOUT_S = 300.0
HANDSHAKE_TIMEOUT_S = 10.0
# liveness + recovery tunables (all per-mesh, env-overridable):
HEARTBEAT_INTERVAL_S = 2.0  # PATHWAY_COMM_HEARTBEAT_S
HEARTBEAT_TIMEOUT_S = 30.0  # PATHWAY_COMM_HEARTBEAT_TIMEOUT_S
RECONNECT_WINDOW_S = 15.0  # PATHWAY_COMM_RECONNECT_WINDOW_S
SEND_BUFFER_MB = 64  # PATHWAY_COMM_SEND_BUFFER_MB
# PATHWAY_COMM_SEND_DEADLINE_S — deadline on any single blocking socket
# write (SO_SNDTIMEO): a hung peer with a full TCP buffer can otherwise
# park a data-phase sendall forever WHILE it holds send_lock.  0 disables.
# Defaults to the (possibly env-overridden) heartbeat timeout — a peer
# that cannot drain one frame for that long is treated exactly like one
# that stopped acking — so there is no separate module constant.
# frame-size cap: a corrupt or hostile length field must not OOM the
# worker.  256 MiB default comfortably covers real epoch batches (tune via
# PATHWAY_COMM_MAX_FRAME_MB for enormous-epoch deployments).
from pathway_tpu_torch.internals.config import env_int as _env_int  # noqa: E402

MAX_FRAME_BYTES = _env_int("PATHWAY_COMM_MAX_FRAME_MB") << 20

_MAGIC = b"PWC1"
_NONCE = 16
_TAG = 32  # HMAC-SHA256


class CommError(RuntimeError):
    pass


class MeshPoisoned(CommError):
    """This mesh was deliberately abandoned (``TcpMesh.poison``): a peer
    died and the supervisor is promoting a warm standby into its worker
    id, so every surviving worker must leave its blocked collectives NOW
    and rejoin a fresh mesh in-process — waiting out heartbeat timeouts
    (or the reconnect window) on a peer that will come back as a NEW
    process would turn a sub-second promotion into a multi-second stall
    or, worse, a whole-group restart."""


def _resolve_secret(secret: bytes | str | None) -> bytes:
    """Shared handshake secret: explicit arg, else PATHWAY_COMM_SECRET
    (``cli spawn`` mints one per run).  Deliberately NOT the run id — the
    monitoring endpoints publish it, so it cannot double as an auth token.

    With an empty secret the handshake still runs (frames stay typed and
    framed) but offers no authentication, so frame decode additionally
    refuses pickled values (``decode_row_typed``) — set
    PATHWAY_COMM_SECRET for any mesh that crosses a machine boundary.
    """
    if secret is None:
        from pathway_tpu_torch.internals.config import env_str

        secret = env_str("PATHWAY_COMM_SECRET")
    if isinstance(secret, str):
        secret = secret.encode()
    return secret


def _auth_tag(secret: bytes, role: bytes, a: bytes, b: bytes) -> bytes:
    return _hmac.new(secret, role + _MAGIC + a + b, "sha256").digest()


def _handshake_dial(sock: socket.socket, my_id: int, secret: bytes) -> None:
    """Dialer side: send hello, verify listener's proof, send ours."""
    nonce_d = _secrets.token_bytes(_NONCE)
    sock.sendall(_MAGIC + _FRAME.pack(my_id) + nonce_d)
    reply = _recv_exact(sock, _NONCE + _TAG)
    nonce_l, tag_l = reply[:_NONCE], reply[_NONCE:]
    if not _hmac.compare_digest(tag_l, _auth_tag(secret, b"l", nonce_d, nonce_l)):
        raise CommError("handshake failed: listener authentication mismatch")
    sock.sendall(_auth_tag(secret, b"d", nonce_l, nonce_d))


def _handshake_accept(sock: socket.socket, secret: bytes) -> int:
    """Listener side: verify dialer; returns the peer worker id."""
    hello = _recv_exact(sock, len(_MAGIC) + _FRAME.size + _NONCE)
    if hello[: len(_MAGIC)] != _MAGIC:
        raise CommError("handshake failed: bad magic")
    (peer,) = _FRAME.unpack(hello[len(_MAGIC) : len(_MAGIC) + _FRAME.size])
    nonce_d = hello[len(_MAGIC) + _FRAME.size :]
    nonce_l = _secrets.token_bytes(_NONCE)
    sock.sendall(nonce_l + _auth_tag(secret, b"l", nonce_d, nonce_l))
    tag_d = _recv_exact(sock, _TAG)
    if not _hmac.compare_digest(tag_d, _auth_tag(secret, b"d", nonce_l, nonce_d)):
        raise CommError("handshake failed: dialer authentication mismatch")
    return peer


def _encode_frame(tag: Hashable, payload: Any) -> bytes:
    """Legacy 8-byte-length framing, kept for the wire-security tests that
    hand-craft malformed frames; mesh traffic uses ``(length, seq)``
    headers (``_HDR``) stamped in :meth:`TcpMesh.send`."""
    blob = _codec.encode_row((tag, payload))
    return _FRAME.pack(len(blob)) + blob


def _decode_frame(blob: bytes, typed_only: bool) -> tuple[Hashable, Any]:
    if typed_only:
        row, _pos = _codec.decode_row_typed(blob)
    else:
        row, _pos = _codec.decode_row(blob)
    if len(row) != 2:
        raise ValueError(f"comm frame: expected (tag, payload), got {len(row)} values")
    return row[0], row[1]


class _Link:
    """Per-peer duplex link state.

    Locking: ``cv`` guards connection state (sock/gen/ready/dead/
    relinking/recv_seq/last_seen/peer incarnation) and is the condition
    senders and reconnect threads wait on; ``send_lock`` serializes socket
    writes and guards send-side state (send_seq, retransmit buffer).  The
    two are never held nested.
    """

    __slots__ = (
        "peer", "sock", "gen", "ready", "dead", "relinking",
        "relink_deadline", "cv", "send_lock", "send_seq", "sent_buf",
        "sent_bytes", "evicted_seq", "unacked_since", "recv_seq",
        "peer_inc", "last_seen",
    )

    def __init__(self, peer: int):
        self.peer = peer
        self.sock: socket.socket | None = None
        self.gen = 0  # bumped on every (re)attach; stale readers check it
        self.ready = False
        self.dead = False
        self.relinking = False
        self.relink_deadline: float | None = None
        self.cv = threading.Condition()
        self.send_lock = threading.Lock()
        self.send_seq = 0
        self.sent_buf: deque[tuple[int, bytes]] = deque()  # (seq, wire)
        self.sent_bytes = 0
        # highest sequence ever evicted unacked from the buffer: a resync
        # is lossless iff the peer already holds everything up to here
        self.evicted_seq = 0
        self.unacked_since: float | None = None
        self.recv_seq = 0  # highest in-order sequence received
        self.peer_inc: int | None = None  # peer process incarnation
        self.last_seen = time.monotonic()


class TcpMesh:
    """Full mesh of TCP links between N worker processes.

    Worker ``i`` listens on ``first_port + i``; workers with higher ids dial
    workers with lower ids, so every pair has exactly one duplex link.
    A reader thread per link demultiplexes frames into per-(src, tag)
    queues.  Links survive transient failures via the retransmit/resync
    protocol described in the module docstring.
    """

    def __init__(
        self,
        worker_id: int,
        worker_count: int,
        first_port: int,
        host: str = "127.0.0.1",
        peer_hosts: list[str] | None = None,
        secret: bytes | str | None = None,
    ):
        self.worker_id = worker_id
        self.worker_count = worker_count
        self.first_port = first_port
        self.host = host
        self.secret = _resolve_secret(secret)
        # incarnation-fenced handshakes: when the supervisor runs this
        # worker under an incarnation lease (PATHWAY_INCARNATION, see
        # engine/supervisor.py), the handshake secret is derived from
        # (secret, incarnation) — a zombie worker from a superseded
        # restart attempt then FAILS authentication against the respawned
        # cluster's mesh and is dropped before it can exchange a single
        # frame, mirroring the persistence-root fencing.  The base secret
        # keeps deciding typed-only decode (an incarnation number is
        # public, so it must never upgrade an unauthenticated mesh).
        self._auth_secret = self.secret
        # lazy: persistence's env parse is the single authority on what
        # counts as "this process holds an incarnation" (persistence does
        # not import comm, so the import stays one-way)
        from pathway_tpu_torch.engine.persistence import writer_incarnation

        fence_inc = writer_incarnation()
        if self.secret and fence_inc > 0:
            self._auth_secret = _hmac.new(
                self.secret, b"incarnation:%d" % fence_inc, "sha256"
            ).digest()
        # multi-host deployments (one process per k8s pod / card host):
        # peer_hosts[i] is worker i's hostname; ports stay first_port+i so
        # the same config also works on localhost
        if peer_hosts is not None and len(peer_hosts) != worker_count:
            raise CommError(
                f"peer_hosts has {len(peer_hosts)} entries for "
                f"{worker_count} workers"
            )
        self.peer_hosts = peer_hosts
        # a fresh random incarnation per mesh instance: after a crash +
        # respawn the peer's resume header proves it is a NEW process, so
        # stale pre-crash frames and sequence state must be discarded
        self.incarnation = int.from_bytes(_secrets.token_bytes(8), "big") or 1
        self.recv_timeout = _env_float("PATHWAY_COMM_RECV_TIMEOUT_S", RECV_TIMEOUT_S)
        self.heartbeat_interval = _env_float(
            "PATHWAY_COMM_HEARTBEAT_S", HEARTBEAT_INTERVAL_S
        )
        self.heartbeat_timeout = _env_float(
            "PATHWAY_COMM_HEARTBEAT_TIMEOUT_S", HEARTBEAT_TIMEOUT_S
        )
        self.reconnect_window = _env_float(
            "PATHWAY_COMM_RECONNECT_WINDOW_S", RECONNECT_WINDOW_S
        )
        self.send_deadline = _env_float(
            "PATHWAY_COMM_SEND_DEADLINE_S",
            max(self.heartbeat_timeout, 1.0),
        )
        # the retransmit buffer must hold at least one max-size frame, or
        # a single legal frame would be evicted the moment it is sent and
        # any reconnect before its ack would falsely declare the peer dead
        self.send_buffer_bytes = max(
            int(_env_float("PATHWAY_COMM_SEND_BUFFER_MB", SEND_BUFFER_MB))
            << 20,
            MAX_FRAME_BYTES + _HDR.size,
        )
        plan = _faults.active_plan()
        self._fault_comm = plan is not None and plan.has(
            "comm_drop", "comm_reset", "comm_corrupt", "comm_delay"
        )
        self._links: dict[int, _Link] = {}
        self._inbox: dict[tuple[int, Hashable], deque] = defaultdict(deque)
        self._cv = threading.Condition()
        self._closed = False
        self._retiring = False  # see retire(): coordinated-teardown mode
        self._poisoned: str | None = None  # see poison(): promotion rejoin
        self._threads: list[threading.Thread] = []
        self._listener: socket.socket | None = None
        self._acceptor: threading.Thread | None = None
        self._hb_stop = threading.Event()
        self._acc_lock = threading.Lock()
        self._accepted: set[int] = set()
        self._acc_done = threading.Event()
        self._acc_err: list[BaseException] = []
        # mesh observability: registered into the process-wide registry so
        # /metrics and the OTLP exporter see comm health without touching
        # the hot path (plain counter adds; see engine/metrics.py)
        reg = _metrics.get_registry()
        wl = {"worker": worker_id}
        self._m_frames_sent = reg.counter(
            "comm.frames.sent", "mesh data frames written", **wl
        )
        self._m_bytes_sent = reg.counter(
            "comm.bytes.sent", "mesh bytes written (headers included)", **wl
        )
        self._m_frames_recv = reg.counter(
            "comm.frames.received", "mesh data frames received", **wl
        )
        self._m_bytes_recv = reg.counter(
            "comm.bytes.received", "mesh bytes received (headers included)", **wl
        )
        self._m_reconnects = reg.counter(
            "comm.reconnects", "link reconnect attempts scheduled", **wl
        )
        self._m_retransmits = reg.counter(
            "comm.retransmits", "frames re-delivered by link resyncs", **wl
        )
        self._m_evictions = reg.counter(
            "comm.retransmit.evictions",
            "unacked frames evicted from the retransmit buffer", **wl,
        )
        self._m_peers_dead = reg.counter(
            "comm.peers.dead", "peers declared dead", **wl
        )
        self._m_staleness = reg.gauge(
            "comm.heartbeat.staleness.s",
            "seconds since the quietest live peer was last heard", **wl,
        )
        # per-peer inbox depth joins the backlog.* backpressure namespace
        # (engine/freshness.py) at pull time — a receiver whose epoch loop
        # falls behind its peers shows up here, ranked against every other
        # place records wait.  WeakMethod registration: dies with the mesh.
        reg.register_collector(
            f"comm.inbox.worker{worker_id}", self._backlog_snapshot
        )

    def _reconnect_delays(self):
        """Bounded backoff schedule for link reconnects — the udfs
        ``ExponentialBackoffRetryStrategy`` (one policy codebase-wide),
        preceded by one immediate attempt."""
        from pathway_tpu_torch.internals.udfs.retries import (
            ExponentialBackoffRetryStrategy,
        )

        strategy = ExponentialBackoffRetryStrategy(
            max_retries=12, initial_delay=50, backoff_factor=1.7, jitter_ms=50
        )
        return _itertools.chain([0.0], strategy.delays())

    # -- setup -----------------------------------------------------------
    def start(self) -> "TcpMesh":
        if self.worker_count <= 1:
            return self
        try:
            return self._start()
        except BaseException:
            # a failed start must release the listener port and every
            # half-open link — callers retry with a fresh mesh
            self.close()
            raise

    def _start(self) -> "TcpMesh":
        listen_host = "" if self.peer_hosts is not None else self.host
        self._listener = socket.create_server(
            (listen_host, self.first_port + self.worker_id), reuse_port=False
        )
        self._listener.settimeout(1.0)
        accept_from = [w for w in range(self.worker_count) if w > self.worker_id]
        dial_to = [w for w in range(self.worker_count) if w < self.worker_id]
        for w in accept_from + dial_to:
            self._links[w] = _Link(w)

        if not accept_from:
            self._acc_done.set()
        self._acceptor = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"pathway:comm-accept-{self.worker_id}",
        )
        self._acceptor.start()

        for peer in dial_to:
            sock = _dial(
                self._peer_host(peer), self.first_port + peer,
                self.worker_id, self._auth_secret,
            )
            self._attach(peer, sock)

        done = self._acc_done.wait(CONNECT_TIMEOUT_S)
        if self._acc_err:
            raise CommError(
                f"worker {self.worker_id}: accept failed: {self._acc_err[0]}"
            )
        if not done:
            with self._acc_lock:
                missing = sorted(set(accept_from) - self._accepted)
            raise CommError(
                f"worker {self.worker_id}: timed out waiting for peers "
                f"{missing}"
            )
        hb = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name=f"pathway:comm-hb-{self.worker_id}",
        )
        hb.start()
        self._threads.append(hb)
        return self

    def _peer_host(self, peer: int) -> str:
        return self.peer_hosts[peer] if self.peer_hosts is not None else self.host

    def _accept_loop(self) -> None:
        # runs for the life of the mesh: initial peers handshake here, and
        # so do RECONNECTING peers after a link failure.  A connection that
        # fails the handshake (port scanner, stray client, wrong secret) is
        # dropped and accepting continues; only listener-socket errors end
        # the loop.
        while not self._closed:
            try:
                sock, _addr = self._listener.accept()
            except TimeoutError:
                continue
            except OSError:
                return  # listener closed (close()) or broken
            except BaseException as exc:  # noqa: BLE001 — surfaced by start()
                self._acc_err.append(exc)
                return
            threading.Thread(
                target=self._handshake_one, args=(sock,), daemon=True
            ).start()

    def _handshake_one(self, sock: socket.socket) -> None:
        # per-connection thread: a stalled or malicious client burns only
        # its own HANDSHAKE_TIMEOUT_S, never the accept loop
        try:
            sock.settimeout(HANDSHAKE_TIMEOUT_S)
            peer = _handshake_accept(sock, self._auth_secret)
            if peer <= self.worker_id or peer not in self._links:
                raise CommError(f"unexpected peer id {peer}")
            sock.settimeout(None)
            self._attach(peer, sock)
            with self._acc_lock:
                self._accepted.add(peer)
                expect = sum(1 for w in self._links if w > self.worker_id)
                if len(self._accepted) == expect:
                    self._acc_done.set()
        except (CommError, OSError, EOFError):
            try:
                sock.close()
            except OSError:
                pass

    def _attach(self, peer: int, sock: socket.socket) -> None:
        """Install (or replace) the socket of a link and start its reader.
        The reader performs the resume exchange before the link goes ready."""
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        if self.send_deadline > 0:
            # SO_SNDTIMEO bounds each blocking WRITE syscall only (recv
            # stays governed by its own timeouts), so a data-phase sendall
            # to a hung peer errors out instead of parking forever while it
            # holds send_lock.  The frame stays in the retransmit buffer;
            # the failed link is cycled and resync re-delivers it.
            try:
                sec = int(self.send_deadline)
                usec = int((self.send_deadline - sec) * 1e6)
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                    struct.pack("ll", sec, usec),
                )
            except (OSError, struct.error):
                pass  # platform without SO_SNDTIMEO: keep the old behavior
        link = self._links[peer]
        with link.cv:
            link.gen += 1
            gen = link.gen
            old = link.sock
            link.sock = sock
            link.ready = False
            if old is not None:
                _close_quietly(old)  # stale reader exits via gen check
        t = threading.Thread(
            target=self._reader, args=(peer, link, sock, gen), daemon=True,
            name=f"pathway:comm-{self.worker_id}<-{peer}",
        )
        t.start()
        # prune finished readers so a flaky network (a new reader per
        # reconnect) cannot grow this list without bound
        self._threads = [x for x in self._threads if x.is_alive()]
        self._threads.append(t)

    # -- per-link reader / resume ---------------------------------------
    def _reader(self, peer: int, link: _Link, sock: socket.socket, gen: int) -> None:
        try:
            self._resume_link(peer, link, sock, gen)
            sock.settimeout(None)
            while not self._closed:
                header = _recv_exact(sock, _HDR.size)
                size, seq = _HDR.unpack(header)
                if size > MAX_FRAME_BYTES:
                    raise ValueError(f"comm frame of {size} bytes exceeds cap")
                blob = _recv_exact(sock, size)
                self._m_bytes_recv.inc(_HDR.size + size)
                if seq != 0:
                    self._m_frames_recv.inc()
                # every mutation below re-checks gen under the owning lock:
                # a superseded reader (its socket replaced by a reconnect)
                # must not write stale seq/ack/inbox state over the state
                # the new link's resume just (re)established
                with link.cv:
                    if link.gen != gen:
                        return
                    link.last_seen = time.monotonic()
                if seq == 0:
                    # control frame: heartbeat carrying the peer's
                    # cumulative ack — retire acknowledged frames
                    if size >= _FRAME.size:
                        (ack,) = _FRAME.unpack(blob[: _FRAME.size])
                        with link.send_lock:
                            if link.gen == gen:
                                self._trim_acked(link, ack)
                    continue
                with link.cv:
                    if link.gen != gen:
                        return
                    if seq <= link.recv_seq:
                        continue  # duplicate from a resync retransmit
                    if seq != link.recv_seq + 1:
                        # a frame vanished from the stream (injected drop /
                        # half-written frame before a reset): framing is
                        # intact but data is missing — force a resync
                        raise ValueError(
                            f"sequence gap from worker {peer}: got {seq}, "
                            f"expected {link.recv_seq + 1}"
                        )
                # no shared secret = unauthenticated link: refuse pickled
                # values so a reachable port is not code execution
                tag, payload = _decode_frame(blob, typed_only=not self.secret)
                with link.cv:
                    if link.gen != gen:
                        return
                    link.recv_seq = seq
                    # nested cv → _cv is the one lock-nesting order used
                    # anywhere, so the advance + enqueue stay atomic w.r.t.
                    # a concurrent purge/resume
                    with self._cv:
                        self._inbox[(peer, tag)].append(payload)
                        self._cv.notify_all()
        except Exception as exc:  # noqa: BLE001
            # socket errors AND decode errors land here: a malformed or
            # corrupt frame means framing is lost and the link is unusable
            # as-is.  Unlike the pre-recovery design this is no longer
            # instantly fatal — the link re-handshakes and resynchronizes
            # from the last acked sequence; only an exhausted reconnect
            # window (or an unrecoverable resync) declares the peer dead.
            if isinstance(exc, ValueError):
                _log.error(
                    "worker %d: link to peer %d failed: %s",
                    self.worker_id, peer, exc,
                )
            self._on_link_failure(peer, link, sock, gen, exc)

    def _resume_link(
        self, peer: int, link: _Link, sock: socket.socket, gen: int
    ) -> None:
        """Post-handshake resume exchange; sets the link ready on success."""
        sock.settimeout(HANDSHAKE_TIMEOUT_S)
        with link.cv:
            my_ack = link.recv_seq
        with link.send_lock:
            sock.sendall(_RESUME.pack(self.incarnation, my_ack))
        peer_inc, peer_ack = _RESUME.unpack(_recv_exact(sock, _RESUME.size))
        with link.cv:
            if link.gen != gen or self._closed:
                raise OSError("link superseded during resume")
            # first connect, or the peer is a respawned process: no
            # cross-incarnation delivery — reset both directions and
            # purge frames queued from the previous incarnation so a
            # rejoined worker never consumes pre-crash data
            new_inc = peer_inc != link.peer_inc
            if link.dead and not new_inc:
                # the death purged this peer's inbox, so our recv_seq
                # over-reports what survived — a same-incarnation resume
                # would silently skip those frames.  Only a respawned
                # (new-incarnation) peer may revive a dead link.
                raise OSError("peer was declared dead; refusing resume")
            purge = new_inc and link.peer_inc is not None
            link.peer_inc = peer_inc
            if new_inc:
                link.recv_seq = 0
                link.dead = False
        if purge:
            self._purge_inbox(peer, notify=True)
        resend: list[bytes] = []
        with link.send_lock:
            if new_inc:
                link.send_seq = 0
                link.sent_buf.clear()
                link.sent_bytes = 0
                link.evicted_seq = 0
                link.unacked_since = None
            elif peer_ack < link.send_seq and (
                peer_ack < link.evicted_seq
                or (link.sent_buf and link.sent_buf[0][0] > peer_ack + 1)
            ):
                raise CommError(
                    f"cannot resync link to worker {peer}: frames past the "
                    f"{self.send_buffer_bytes >> 20} MiB retransmit buffer "
                    "were lost (raise PATHWAY_COMM_SEND_BUFFER_MB)"
                )
            else:
                self._trim_acked(link, peer_ack)
                resend = [wire for _s, wire in link.sent_buf]
        if not resend:
            if not self._set_ready(link, gen):
                raise OSError("link superseded during resume")
            return
        # Retransmit OFF the reader thread: the reader must reach its frame
        # loop and drain the peer's (symmetric) retransmission while this
        # backlog is written, or two peers with large bidirectional backlogs
        # deadlock against full kernel socket buffers.  Ordering is safe:
        # normal senders wait for `ready`, which is set only after this
        # thread holds send_lock — nothing can interleave ahead of the
        # backlog.
        def retransmit() -> None:
            try:
                with link.send_lock:
                    if not self._set_ready(link, gen):
                        return
                    for wire in resend:
                        sock.sendall(wire)
                self._m_retransmits.inc(len(resend))
                # retransmitted wire bytes really crossed the link again
                # (frames.sent already counted them at first send; the
                # retransmits counter reconciles the difference)
                self._m_bytes_sent.inc(sum(len(w) for w in resend))
                _log.info(
                    "worker %d: link to peer %d resynced, retransmitted "
                    "%d frame(s)", self.worker_id, peer, len(resend),
                )
            except OSError as exc:
                self._on_link_failure(peer, link, sock, gen, exc)

        threading.Thread(
            target=retransmit, daemon=True,
            name=f"pathway:comm-resend-{self.worker_id}-{peer}",
        ).start()

    def _set_ready(self, link: _Link, gen: int) -> bool:
        with link.cv:
            if link.gen != gen or self._closed:
                return False
            link.ready = True
            link.relinking = False
            link.relink_deadline = None
            link.last_seen = time.monotonic()
            link.cv.notify_all()
            return True

    @staticmethod
    def _trim_acked(link: _Link, ack: int) -> None:
        """Retire buffered frames the peer confirmed (call with send_lock)."""
        trimmed = False
        while link.sent_buf and link.sent_buf[0][0] <= ack:
            _seq, wire = link.sent_buf.popleft()
            link.sent_bytes -= len(wire)
            trimmed = True
        if trimmed:
            link.unacked_since = None if not link.sent_buf else time.monotonic()

    # -- failure handling / reconnect ------------------------------------
    def _on_link_failure(
        self,
        peer: int,
        link: _Link,
        sock: socket.socket,
        gen: int,
        exc: BaseException,
    ) -> None:
        _close_quietly(sock)
        if self._retiring:
            # coordinated teardown: peers are LEAVING, not failing — no
            # reconnect threads, no alarms; just mark the link down so any
            # straggling recv unblocks on the dead sentinel
            self._mark_dead(peer, link, "retired (coordinated handoff)")
            return
        if isinstance(exc, CommError):
            with link.cv:
                if self._closed or link.dead or link.gen != gen:
                    return  # a superseded reader must not kill the new link
            # resync refused (retransmit gap / auth): unrecoverable
            self._mark_dead(peer, link, str(exc))
            return
        with link.cv:
            if self._closed or link.dead or link.gen != gen:
                return
            link.ready = False
            now = time.monotonic()
            if link.relink_deadline is None:
                link.relink_deadline = now + self.reconnect_window
            expired = now > link.relink_deadline
            if not expired:
                if link.relinking:
                    return  # an active reconnect thread owns this link
                link.relinking = True
        if expired:
            self._mark_dead(
                peer, link,
                f"reconnect window ({self.reconnect_window:g}s) exhausted: {exc}",
            )
            return
        _log.warning(
            "worker %d: link to peer %d dropped (%s); reconnecting",
            self.worker_id, peer, exc,
        )
        self._m_reconnects.inc()
        _blackbox.record(
            "comm.reconnect", worker=self.worker_id, peer=peer, error=str(exc)
        )
        if peer < self.worker_id:
            target = self._redial_loop  # we dialed this peer originally
        else:
            target = self._await_reaccept  # the peer dials us back
        threading.Thread(
            target=target, args=(peer, link), daemon=True,
            name=f"pathway:comm-relink-{self.worker_id}-{peer}",
        ).start()

    def _redial_loop(self, peer: int, link: _Link) -> None:
        with link.cv:
            deadline = link.relink_deadline or (
                time.monotonic() + self.reconnect_window
            )
        for delay in self._reconnect_delays():
            if self._closed or link.dead:
                return
            if delay:
                time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            if time.monotonic() > deadline:
                break
            try:
                sock = _dial(
                    self._peer_host(peer), self.first_port + peer,
                    self.worker_id, self._auth_secret,
                    deadline_s=min(5.0, max(0.5, deadline - time.monotonic())),
                )
            except CommError as exc:
                if getattr(exc, "retryable", False):
                    continue  # peer unreachable this attempt; keep trying
                # auth mismatch: peer is alive but holds a different
                # secret — retrying cannot help
                self._mark_dead(peer, link, str(exc))
                return
            except OSError:
                continue
            self._attach(peer, sock)
            with link.cv:
                link.cv.wait_for(
                    lambda: link.ready or link.dead or self._closed,
                    timeout=HANDSHAKE_TIMEOUT_S + 1.0,
                )
                if link.ready or link.dead or self._closed:
                    return
            # resume failed; loop for another attempt
        self._mark_dead(peer, link, "reconnect attempts exhausted")

    def _await_reaccept(self, peer: int, link: _Link) -> None:
        # listener side of the link: the peer re-dials us; the accept loop
        # re-attaches and the reader resumes — we just enforce the window
        with link.cv:
            deadline = link.relink_deadline or (
                time.monotonic() + self.reconnect_window
            )
            link.cv.wait_for(
                lambda: link.ready or link.dead or self._closed,
                timeout=max(0.0, deadline - time.monotonic()),
            )
            if link.ready or link.dead or self._closed:
                return
        self._mark_dead(peer, link, "peer did not reconnect in time")

    def _mark_dead(self, peer: int, link: _Link, why: str) -> None:
        with link.cv:
            if link.dead:
                return
            link.dead = True
            link.ready = False
            link.relinking = False
            if link.sock is not None:
                _close_quietly(link.sock)
            link.cv.notify_all()
        if self._retiring:
            # expected departure during a coordinated handoff — keep the
            # inbox purge + dead sentinel below (stragglers must still
            # unblock) but none of the partition alarms
            _log.debug(
                "worker %d: peer %d retired: %s", self.worker_id, peer, why
            )
        else:
            _log.error(
                "worker %d: peer %d declared dead: %s",
                self.worker_id, peer, why,
            )
            self._m_peers_dead.inc()
            _blackbox.record(
                "comm.peer_dead", worker=self.worker_id, peer=peer, why=why
            )
        with self._cv:
            # stale frames from the dead incarnation must not be consumed
            # by anyone (least of all a respawned peer's exchange rounds)
            self._purge_inbox(peer, notify=False)
            self._inbox[(peer, _PEER_DEAD)].append(None)
            self._cv.notify_all()

    def _purge_inbox(self, peer: int, *, notify: bool) -> None:
        def drop() -> None:
            for key in [k for k in self._inbox if k[0] == peer]:
                del self._inbox[key]

        if notify:
            with self._cv:
                drop()
                self._cv.notify_all()
        else:
            drop()  # caller holds self._cv

    def _backlog_snapshot(self) -> dict[str, float]:
        """Pull-time collector: frames waiting per peer inbox, in the
        ``backlog.*`` backpressure namespace (``engine/freshness.py``).
        Runs at scrape/export cadence off the hot path; the brief ``_cv``
        hold is the same one every recv already takes."""
        # every peer gets a series, zero included — a drained inbox must
        # report 0, not vanish and leave the scraper serving its last
        # (possibly huge) value for the staleness window
        counts: dict[int, int] = {
            peer: 0 for peer in range(self.worker_count)
            if peer != self.worker_id
        }
        with self._cv:
            for (peer, tag), q in self._inbox.items():
                if tag is _PEER_DEAD:
                    continue
                counts[peer] = counts.get(peer, 0) + len(q)
        return {
            f"backlog.comm.inbox{{peer={peer},worker={self.worker_id}}}":
                float(n)
            for peer, n in counts.items()
        }

    # -- heartbeats -------------------------------------------------------
    # pathway-lint: context=heartbeat
    def _heartbeat_loop(self) -> None:
        """Per-link liveness: send heartbeat+ack frames; force-fail links
        whose peer went silent or stopped acking (a hung process looks
        healthy to TCP — only traffic proves liveness).

        This loop must NEVER block on a link's ``send_lock``: a data-phase
        ``sendall`` to a hung peer can hold that lock for up to the send
        deadline, and one such peer must not stall staleness detection —
        or heartbeats — for every OTHER peer.  So staleness is computed
        from lock-free reads (worst case one interval stale), the force-
        close happens outside any lock, and the heartbeat write itself is
        skipped when the lock is busy (an in-progress data send is itself
        evidence the link is being driven; the ack rides the next tick)."""
        while not self._hb_stop.wait(self.heartbeat_interval):
            if self._closed:
                return
            now = time.monotonic()
            max_stale = 0.0
            for link in self._links.values():
                with link.cv:
                    if not link.ready or link.dead:
                        continue
                    sock = link.sock
                    ack = link.recv_seq
                    staleness = now - link.last_seen
                    max_stale = max(max_stale, staleness)
                    silent = staleness > self.heartbeat_timeout
                # unacked_since is read WITHOUT send_lock: a torn read costs
                # at most one stale interval, while taking the lock could
                # block behind a sendall stuck on this very hung peer
                unacked_since = link.unacked_since
                stalled = (
                    unacked_since is not None
                    and now - unacked_since > self.heartbeat_timeout
                )
                if silent or stalled:
                    # reader wakes with an error → reconnect path decides
                    _log.warning(
                        "worker %d: peer %d %s for >%gs; cycling link",
                        self.worker_id, link.peer,
                        "silent" if silent else "not acking",
                        self.heartbeat_timeout,
                    )
                    _close_quietly(sock)
                    continue
                hb = _HDR.pack(_FRAME.size, 0) + _FRAME.pack(ack)
                # BOUNDED wait for the lock: a wedged data sendall costs at
                # most 50 ms per tick (vs. blocking forever, the PR-1
                # residue), while sustained back-to-back data sends — which
                # release the lock between frames — cannot starve the
                # heartbeat indefinitely: acks ride only on heartbeat
                # frames, and a peer that stopped receiving them would
                # force-fail a perfectly healthy link as "not acking"
                if not link.send_lock.acquire(timeout=0.05):
                    continue  # truly wedged; retry next tick
                try:
                    sock.sendall(hb)
                    # bytes symmetry with the receive side, which counts
                    # control frames too (it cannot tell them apart until
                    # after the header is read)
                    self._m_bytes_sent.inc(len(hb))
                except OSError:
                    # includes a send-deadline expiry: progress on the
                    # socket is unknowable, so cycle the link promptly
                    # instead of waiting for the reader to notice
                    _close_quietly(sock)
                finally:
                    link.send_lock.release()
            self._m_staleness.set(max_stale)

    # -- point to point --------------------------------------------------
    def send(self, dest: int, tag: Hashable, payload: Any) -> None:
        self._check_poison()
        if dest == self.worker_id:
            # the codec round-trips every value shape exactly (lists stay
            # lists, wrappers stay wrapped), so a self-send can skip it
            with self._cv:
                self._inbox[(dest, tag)].append(payload)
                self._cv.notify_all()
            return
        blob = _codec.encode_row((tag, payload))
        if len(blob) > MAX_FRAME_BYTES:
            # fail fast on the sender with the actionable message — the
            # receiver would just drop the link as "peer disconnected"
            raise CommError(
                f"comm frame of {len(blob)} bytes exceeds the "
                f"{MAX_FRAME_BYTES}-byte cap; raise PATHWAY_COMM_MAX_FRAME_MB "
                "on every worker for enormous-epoch workloads"
            )
        link = self._links[dest]
        deadline = time.monotonic() + self.reconnect_window + HANDSHAKE_TIMEOUT_S
        with link.cv:
            link.cv.wait_for(
                lambda: link.ready or link.dead or self._closed
                or self._poisoned is not None,
                timeout=max(0.0, deadline - time.monotonic()),
            )
            self._check_poison()
            if link.dead:
                raise CommError(
                    f"worker {self.worker_id}: peer {dest} disconnected "
                    f"while sending {tag!r}"
                )
            if not link.ready:
                raise CommError(
                    f"worker {self.worker_id}: link to peer {dest} not "
                    f"ready within {self.reconnect_window:g}s"
                )
        drop = corrupt = reset = None
        if self._fault_comm:
            spec = _faults.check("comm_delay", worker=self.worker_id, peer=dest)
            if spec is not None:
                time.sleep(spec.delay_ms / 1000.0)
            drop = _faults.check("comm_drop", worker=self.worker_id, peer=dest)
            if drop is None:
                corrupt = _faults.check(
                    "comm_corrupt", worker=self.worker_id, peer=dest
                )
                if corrupt is None:
                    reset = _faults.check(
                        "comm_reset", worker=self.worker_id, peer=dest
                    )
        with link.send_lock:
            link.send_seq += 1
            wire = _HDR.pack(len(blob), link.send_seq) + blob
            link.sent_buf.append((link.send_seq, wire))
            if not link.unacked_since:
                link.unacked_since = time.monotonic()
            link.sent_bytes += len(wire)
            self._m_frames_sent.inc()
            self._m_bytes_sent.inc(len(wire))
            while link.sent_bytes > self.send_buffer_bytes and link.sent_buf:
                evicted, old = link.sent_buf.popleft()
                link.sent_bytes -= len(old)
                self._m_evictions.inc()
                # resync below this seq is now impossible; if the link
                # drops before the peer acks past it, the peer is dead
                link.evicted_seq = max(link.evicted_seq, evicted)
                _log.warning(
                    "worker %d: retransmit buffer to peer %d overflowed; "
                    "evicted unacked frame %d (raise "
                    "PATHWAY_COMM_SEND_BUFFER_MB to keep reconnects "
                    "lossless)",
                    self.worker_id, dest, evicted,
                )
            out: bytes | None = wire
            if drop is not None:
                out = None  # the frame vanishes, as if eaten by a reset
            elif corrupt is not None:
                # bit-flip the payload on the wire only — the retransmit
                # buffer keeps the pristine frame for the resync
                out = wire[: _HDR.size] + bytes(b ^ 0xFF for b in blob)
            sock = link.sock
            if out is not None and sock is not None:
                try:
                    sock.sendall(out)
                except OSError:
                    # the link just failed under us — including a send-
                    # deadline expiry on a hung peer (SO_SNDTIMEO), where
                    # how much of the frame left the kernel is unknowable.
                    # The frame is in the retransmit buffer; close the
                    # socket so the reader fails over NOW (a deadline
                    # expiry alone would never wake it) and the resync
                    # re-delivers from the last acked sequence.
                    _close_quietly(sock)
            if (drop is not None or reset is not None) and sock is not None:
                _close_quietly(sock)  # injected TCP reset

    def recv(
        self, src: int, tag: Hashable, timeout: float | None = None
    ) -> Any:
        if timeout is None:
            timeout = self.recv_timeout
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                self._check_poison()
                q = self._inbox.get((src, tag))
                if q:
                    payload = q.popleft()
                    if not q:
                        self._inbox.pop((src, tag), None)
                    return payload
                if self._inbox.get((src, _PEER_DEAD)):
                    raise CommError(
                        f"worker {self.worker_id}: peer {src} disconnected "
                        f"while waiting for {tag!r}"
                    )
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CommError(
                        f"worker {self.worker_id}: timeout after {timeout:g}s "
                        f"(PATHWAY_COMM_RECV_TIMEOUT_S) waiting for "
                        f"{tag!r} from worker {src}"
                    )
                self._cv.wait(min(remaining, 1.0))

    # -- collectives -----------------------------------------------------
    def alltoall(self, tag: Hashable, per_dest: list[list]) -> list:
        """Send ``per_dest[w]`` to worker ``w``; return concatenation of what
        every worker sent here (own bucket included), ordered by worker id."""
        for w in range(self.worker_count):
            if w != self.worker_id:
                self.send(w, tag, per_dest[w])
        merged: list = []
        for w in range(self.worker_count):
            if w == self.worker_id:
                merged.extend(per_dest[w])
            else:
                merged.extend(self.recv(w, tag))
        return merged

    def gather(self, tag: Hashable, payload: Any, root: int = 0) -> list | None:
        """Root returns [payload per worker, ordered]; others return None."""
        if self.worker_id == root:
            out = []
            for w in range(self.worker_count):
                out.append(payload if w == root else self.recv(w, tag))
            return out
        self.send(root, tag, payload)
        return None

    def bcast(self, tag: Hashable, payload: Any = None, root: int = 0) -> Any:
        if self.worker_id == root:
            for w in range(self.worker_count):
                if w != root:
                    self.send(w, tag, payload)
            return payload
        return self.recv(root, tag)

    def barrier(self, tag: Hashable) -> None:
        self.gather(("barrier", tag), None)
        self.bcast(("barrier-go", tag))

    def poison(self, reason: str) -> None:
        """Abandon this mesh: every blocked (and future) ``send``/``recv``
        — and through them every collective — raises :class:`MeshPoisoned`
        promptly instead of waiting out link timeouts.

        The worker-side promotion sentinel calls this from its watcher
        thread when the supervisor posts a PROMOTE request for a dead
        peer: the epoch loop is parked inside a positionally-paired
        collective that can never complete (the dead peer will return as
        a NEW process with a fresh mesh incarnation), so the only correct
        exit is to unwind, drain-commit the consistent frontier, and
        rejoin a fresh mesh in-process.  Idempotent; the first reason
        sticks."""
        with self._cv:
            if self._poisoned is not None:
                return
            self._poisoned = reason
            self._cv.notify_all()
        for link in self._links.values():
            with link.cv:
                link.cv.notify_all()

    def _check_poison(self) -> None:
        if self._poisoned is not None:
            raise MeshPoisoned(
                f"worker {self.worker_id}: mesh poisoned: {self._poisoned}"
            )

    def retire(self) -> None:
        """Enter coordinated-teardown mode: this mesh is going away ON
        PURPOSE (live shard handoff — every peer drains, barriers, and
        exits together), so link failures from here on are the expected
        sound of peers leaving, not faults.  Reconnect threads stop
        spawning and peer-death goes quiet (no error logs, no
        ``comm.peers.dead`` counts) — a handoff must not light up the
        same alarms a real partition does."""
        self._retiring = True

    def close(self) -> None:
        self._closed = True
        self._hb_stop.set()
        for link in self._links.values():
            with link.cv:
                if link.sock is not None:
                    try:
                        link.sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    _close_quietly(link.sock)
                link.cv.notify_all()
        if self._listener is not None:
            try:
                # wake an accept() blocked in the acceptor thread so the
                # port is actually released, not merely marked for close
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        acceptor = self._acceptor
        if acceptor is not None and acceptor is not threading.current_thread():
            acceptor.join(3.0)
        with self._cv:
            # per-peer inbox state dies with the mesh: a later mesh (or a
            # respawned worker joining one) must never see pre-close frames
            self._inbox.clear()
            self._cv.notify_all()


_PEER_DEAD = ("__peer_dead__",)


def moving_shards(n_old: int, n_new: int) -> int:
    """How many of the 2**SHARD_BITS shard slots change owner when the
    routing rule ``shard % n`` goes from ``n_old`` to ``n_new`` workers.

    The cost model of a rescale decision: only these slots' state actually
    migrates in a live handoff (the successor replays them filtered by
    ``shard_to_worker(key, n_new)``), so the autoscaler's provenance log
    records it alongside every grow/shrink — ``shard % n`` is not a
    consistent hash, and this number says what that choice costs."""
    n_old, n_new = max(1, n_old), max(1, n_new)
    if n_old == n_new:
        return 0
    span = 1 << SHARD_BITS
    # shard s moves iff s % n_old != s % n_new, which is periodic in
    # lcm(n_old, n_new): count one period, scale to the 16-bit space
    period = math.lcm(n_old, n_new)
    moved_per_period = sum(
        1 for s in range(period) if s % n_old != s % n_new
    )
    full, rem = divmod(span, period)
    return full * moved_per_period + sum(
        1 for s in range(rem) if s % n_old != s % n_new
    )


def _close_quietly(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise EOFError("peer closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _dial(
    host: str,
    port: int,
    my_id: int,
    secret: bytes,
    deadline_s: float = CONNECT_TIMEOUT_S,
) -> socket.socket:
    deadline = time.monotonic() + deadline_s
    last: Exception | None = None
    while time.monotonic() < deadline:
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
        except OSError as exc:
            last = exc
            time.sleep(0.1)
            continue
        try:
            sock.settimeout(HANDSHAKE_TIMEOUT_S)
            _handshake_dial(sock, my_id, secret)
            sock.settimeout(None)
            return sock
        except CommError:
            # auth mismatch is fatal, not retryable: the peer is alive but
            # holds a different secret
            sock.close()
            raise
        except (OSError, EOFError) as exc:
            # listener may have dropped us mid-handshake during startup
            # races — retry like a refused connection
            sock.close()
            last = exc
            time.sleep(0.1)
    err = CommError(f"could not reach worker at {host}:{port}: {last}")
    err.retryable = True  # unreachable ≠ unauthorized: reconnects may retry
    raise err


class WorkerContext:
    """Per-process view of the worker group, driving exchange + epochs.

    ``exchange_node`` implements the reference's exchange-before-stateful-
    operator pattern: contributions are routed to the worker that owns the
    key the operator's state is sharded on (``dataflow.rs:1414``,
    ``shard.rs:15-20``).  Nodes declare ownership via ``exchange_routes``
    (port → routing-key fn) or ``exchange_gather0`` (all rows to worker 0,
    for globally-ordered operators: sort, iterate, external index).
    """

    def __init__(self, mesh: TcpMesh):
        self.mesh = mesh
        self.worker_id = mesh.worker_id
        self.worker_count = mesh.worker_count

    def owner_of(self, routing_key: int) -> int:
        return shard_to_worker(routing_key, self.worker_count)

    def exchange_deltas(
        self,
        tag: Hashable,
        deltas: list,
        route: Callable[[int, Any], int] | None,
        route_cols: "tuple[tuple, bool] | None" = None,
    ) -> list:
        """All-to-all one delta list. ``route(key, row) -> routing key``;
        ``None`` routes by the row key itself.  ``route_cols`` = (key
        column indices, hash_none) batches the key-hash+route loop into
        one native pass (``route_deltas``) with identical semantics —
        the per-row Python loop below is the oracle and the fallback."""
        per_dest: list[list] | None = None
        if route_cols is not None and deltas:
            from pathway_tpu_torch.engine.types import _native
            from pathway_tpu_torch.internals import vector_compiler as vc

            nat = _native()
            if vc.ENABLED and nat is not None and hasattr(nat, "route_deltas"):
                idxs, hash_none = route_cols
                per_dest = nat.route_deltas(
                    list(deltas), idxs, self.worker_count, hash_none
                )
        if per_dest is None:
            per_dest = [[] for _ in range(self.worker_count)]
            for key, row, diff in deltas:
                if route is None:
                    rk = key
                else:
                    try:
                        rk = route(key, row)
                    except Exception:
                        rk = key  # poisoned rows resolve locally; the node's
                        # own step reports the error through the error log
                per_dest[self.owner_of(rk)].append((key, row, diff))
        return self.mesh.alltoall(tag, per_dest)

    def gather0_deltas(self, tag: Hashable, deltas: list) -> list:
        per_dest: list[list] = [[] for _ in range(self.worker_count)]
        per_dest[0] = list(deltas)
        return self.mesh.alltoall(tag, per_dest)

    def exchange_node(self, node: Any, time_: int) -> None:
        """Pre-step exchange for one operator (same call order on every
        worker — the DAG is identical, so collectives pair up)."""
        routes = getattr(node, "exchange_routes", None)
        gather0 = getattr(node, "exchange_gather0", False)
        if routes is None and not gather0:
            return
        n_ports = len(node.inputs) if node.inputs else 1
        for port in range(n_ports):
            pending = node.pending.pop(port, [])
            tag = ("x", node.id, port, time_)
            if gather0:
                merged = self.gather0_deltas(tag, pending)
            else:
                route = routes.get(port) if routes else None
                if route is None and routes is not None and port not in routes:
                    # port not exchanged (already co-located) — but peers
                    # still ran alltoall for declared ports only, so skip
                    node.pending[port] = pending
                    continue
                specs = getattr(node, "exchange_route_cols", None)
                route_cols = (
                    specs.get(port)
                    if specs is not None and route is not None
                    else None
                )
                merged = self.exchange_deltas(
                    tag, pending, route, route_cols=route_cols
                )
            if merged:
                node.pending[port] = merged

    def close(self) -> None:
        self.mesh.close()
