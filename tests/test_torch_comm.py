"""The port's TCP mesh against the JAX package's.

``tests/test_comm_security.py`` and the comm half of
``tests/test_fault_injection.py``: typed frames and the HMAC handshake,
malformed frames and strangers refused, oversized headers and pickled
values on an unauthenticated link refused, and single injected frame
drops, resets and corruptions absorbed by retransmit and resync.  The two
packages' frames are byte-identical, and a mesh of one JAX worker and one
port worker exchanges every value kind both ways.
"""

from __future__ import annotations

import ast
import datetime
import inspect
import socket
import threading
import time

import numpy as np
import pytest

from pathway_tpu.engine import comm as jcomm
from pathway_tpu.engine import types as jtypes
from pathway_tpu_torch.engine import comm as tcomm
from pathway_tpu_torch.engine import faults as tfaults
from pathway_tpu_torch.engine import types as ttypes
from tests.torch_cluster_programs import free_port_base


def boot(modules, secret="tok", port=None):
    """One mesh per module in ``modules`` (worker id = position), booted on
    localhost threads."""
    port = port or free_port_base(len(modules))
    meshes, errs = {}, []

    def start(wid, mod):
        try:
            meshes[wid] = mod.TcpMesh(wid, len(modules), port, secret=secret).start()
        except Exception as exc:  # noqa: BLE001
            errs.append((wid, exc))

    threads = [threading.Thread(target=start, args=(w, m)) for w, m in enumerate(modules)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errs, errs
    return [meshes[w] for w in range(len(modules))]


def payload(types):
    return [
        (1, ("txt", 2.5, None, True, b"raw"), 1),
        (2**70, (types.Pointer(7), types.Json({"a": [1, 2]}), types.ERROR), -1),
        (3, (datetime.datetime(2026, 7, 30, 12, 0), datetime.timedelta(seconds=90),
             np.arange(6, dtype=np.int64).reshape(2, 3)), 1),
    ]


def test_comm_imports_no_pickle_and_frames_equal_jax():
    tree = ast.parse(inspect.getsource(tcomm))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not any("pickle" in a.name for a in node.names)
        if isinstance(node, ast.ImportFrom):
            assert "pickle" not in (node.module or "")
    assert tcomm._encode_frame(("t", 1), payload(ttypes)) == jcomm._encode_frame(("t", 1), payload(jtypes))


@pytest.mark.parametrize("order", ["jax-port", "port-jax"])
def test_mixed_mesh_round_trips_every_value_kind(order):
    """A JAX worker and a port worker form one authenticated mesh: the
    typed values one sends, the other reads back as its own types."""
    mods = [jcomm, tcomm] if order == "jax-port" else [tcomm, jcomm]
    types = [jtypes, ttypes] if order == "jax-port" else [ttypes, jtypes]
    m0, m1 = boot(mods)
    try:
        m0.send(1, ("t", 1), payload(types[0]))
        got = m1.recv(0, ("t", 1), timeout=10)
        assert got[0] == (1, ("txt", 2.5, None, True, b"raw"), 1)
        assert got[1][1][0] == types[1].Pointer(7) and got[1][1][1].value == {"a": [1, 2]}
        assert got[1][1][2] is types[1].ERROR and got[1][2] == -1
        assert got[2][1][:2] == (datetime.datetime(2026, 7, 30, 12, 0), datetime.timedelta(seconds=90))
        assert np.asarray(got[2][1][2]).tolist() == [[0, 1, 2], [3, 4, 5]]
        out = {}
        t = threading.Thread(
            target=lambda: out.__setitem__(1, m1.alltoall(("a", 0), [[(10, ("w", 1), 1)], [(11, ("x", 1), 1)]]))
        )
        t.start()
        out[0] = m0.alltoall(("a", 0), [[(0, ("w", 0), 1)], [(1, ("x", 0), 1)]])
        t.join(10)
        assert sorted(k for k, _r, _d in out[0]) == [0, 10]
        assert sorted(k for k, _r, _d in out[1]) == [1, 11]
    finally:
        m0.close()
        m1.close()


def listening_worker0(secret):
    """Worker 0 of a port mesh booting on a thread; the caller dials."""
    port = free_port_base(2)
    result = {}
    t = threading.Thread(
        target=lambda: result.__setitem__("w0", tcomm.TcpMesh(0, 2, port, secret=secret).start()),
        daemon=True,
    )
    t.start()
    time.sleep(0.3)
    return port, result, t


def test_bad_secret_refused_and_honest_peer_still_joins():
    port, result, t = listening_worker0("right")
    with pytest.raises(tcomm.CommError, match="authentication"):
        tcomm.TcpMesh(1, 2, port, secret="wrong").start()
    m1 = jcomm.TcpMesh(1, 2, port, secret="right").start()  # a JAX worker, even
    t.join(15)
    m1.close()
    result["w0"].close()


@pytest.mark.parametrize("attack", ["garbage_hello", "malformed_frame", "pickled_value", "oversized_header"])
def test_hostile_bytes_kill_the_link_not_the_process(attack):
    secret = "" if attack == "pickled_value" else "tok"
    port, result, t = listening_worker0(secret)
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.settimeout(10)
    fired = []
    if attack == "garbage_hello":
        s.sendall(b"GET / HTTP/1.1\r\n\r\n" + b"\0" * 16)
        try:
            assert s.recv(64) == b""
        except ConnectionResetError:
            pass
        s.close()
        m1 = tcomm.TcpMesh(1, 2, port, secret=secret).start()
        t.join(15)
        m1.send(0, "ping", (1, 2))
        assert result["w0"].recv(1, "ping", timeout=10) == (1, 2)
        m1.close()
        result["w0"].close()
        return
    tcomm._handshake_dial(s, 1, secret.encode())
    t.join(15)
    if attack == "malformed_frame":
        good = tcomm._encode_frame("t", (1, 2))
        s.sendall(good[:8] + bytes(x ^ 0xFF for x in good[8:]))
    elif attack == "pickled_value":
        class Evil:
            def __reduce__(self):
                return (fired.append, ("pwned",))

        s.sendall(tcomm._encode_frame("t", Evil()))
    else:
        s.sendall((2**63).to_bytes(8, "big"))
    with pytest.raises(tcomm.CommError, match="disconnected|timeout"):
        result["w0"].recv(1, "t", timeout=2)
    assert not fired
    result["w0"].close()
    s.close()


def test_authenticated_link_carries_python_objects():
    m0, m1 = boot([tcomm, tcomm])
    try:
        m0.send(1, "obj", (ttypes.PyObjectWrapper({"nested": [1, 2]}),))
        got = m1.recv(0, "obj", timeout=10)
        assert isinstance(got[0], ttypes.PyObjectWrapper)
        assert got[0] == ttypes.PyObjectWrapper({"nested": [1, 2]})
    finally:
        m0.close()
        m1.close()


@pytest.fixture
def fast_links(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMM_HEARTBEAT_S", "0.2")
    monkeypatch.setenv("PATHWAY_COMM_HEARTBEAT_TIMEOUT_S", "10")
    monkeypatch.setenv("PATHWAY_COMM_RECONNECT_WINDOW_S", "10")
    tfaults.clear_plan()
    yield
    tfaults.clear_plan()


@pytest.mark.chaos
@pytest.mark.parametrize("kind", ["comm_drop", "comm_reset", "comm_corrupt"])
def test_single_frame_fault_absorbed_no_loss_no_dup(fast_links, kind):
    tfaults.install_plan(tfaults.FaultPlan([{"kind": kind, "worker": 0, "peer": 1, "nth": 20}]))
    m0, m1 = boot([tcomm, tcomm])
    try:
        got = []
        consumer = threading.Thread(target=lambda: got.extend(m1.recv(0, "t", timeout=30) for _ in range(40)))
        consumer.start()
        for i in range(40):
            m0.send(1, "t", (i, "payload"))
        consumer.join(30)
        assert got == [(i, "payload") for i in range(40)]
        assert tfaults.active_plan().log, "the fault must have fired"
    finally:
        m0.close()
        m1.close()


@pytest.mark.chaos
def test_dead_peer_detected_and_recv_timeout_named(fast_links, monkeypatch):
    monkeypatch.setenv("PATHWAY_COMM_RECONNECT_WINDOW_S", "1")
    m0, m1 = boot([tcomm, tcomm])
    try:
        m1.close()
        with pytest.raises(tcomm.CommError, match="disconnected|timeout"):
            m0.recv(1, "never", timeout=15)
    finally:
        m0.close()
    monkeypatch.setenv("PATHWAY_COMM_RECV_TIMEOUT_S", "0.3")
    mesh = tcomm.TcpMesh(0, 1, free_port_base(1))
    with pytest.raises(tcomm.CommError, match=r"timeout after 0\.3s \(PATHWAY_COMM_RECV_TIMEOUT_S\)"):
        mesh.recv(0, "never")
