"""The port's REST surface held to the JAX package's.

One program (``tests/torch_rest_programs.py`` ``rest``: ``rest_connector``
routes and a ``QARestServer``) is served by each package in a subprocess
on free ports, the port's with ``aiohttp``, ``jax`` and ``pathway_tpu``
blocked from import.  The same requests get the same status codes, JSON
bodies and ``Retry-After`` from both: 200, 400 (malformed and non-object
JSON, a bad deadline header), 404, 504 (a 1 µs deadline), 500 (a pipeline
error), the OpenAPI ``/_schema``, and 429 under a seeded
``request_flood``.  ``AdmissionController`` and ``RequestTrace`` driven
in-process with a fixed clock and fixed ids give the same decisions and
snapshots.
"""

from __future__ import annotations

import asyncio
import json
import types

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from tests import torch_rest_programs as rp
from tests.torch_dataflow_programs import sub

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
MODULES = {"pathway_tpu": jpw, "pathway_tpu_torch": tpw}
FLOOD_PLAN = json.dumps({"faults": [{"kind": "request_flood", "source": "/flood", "nth": 1, "delay_ms": 1500}]})
ADD = {"a": 2, "b": 40}


@pytest.fixture(scope="module", autouse=True)
def procs():
    """The ``rest`` program in both packages, started with the file's first
    test so that they boot while the in-process tests run."""
    ports = {pkg: rp.free_ports(2) for pkg in PACKAGES}
    env = {"PATHWAY_FAULT_PLAN": FLOOD_PLAN, "PATHWAY_SERVE_QUEUE": "0"}
    running = {pkg: rp.spawn(pkg, "rest", ports[pkg], env) for pkg in PACKAGES}
    try:
        yield ports, running
    finally:
        rp.stop(running.values())


@pytest.fixture(scope="module")
def servers(procs):
    ports, running = procs
    for pkg in PACKAGES:
        rp.wait_ready(running[pkg], ports[pkg][0], "/add", ADD)
        rp.wait_ready(running[pkg], ports[pkg][1], "/v2/list_documents", {})
    return ports


# ---------------------------------------------------------------------------
# admission and request traces under a fixed clock
# ---------------------------------------------------------------------------


def fixed(pkg, monkeypatch):
    """The package's serving and tracing modules on a fixed clock and
    counter-made ids; returns (serving, tracing, clock)."""
    serving, tracing = sub(MODULES[pkg], "engine.serving"), sub(MODULES[pkg], "engine.tracing")
    clock = [1000.0]
    ids = iter(range(1, 10**6))
    fake_time = types.SimpleNamespace(time=lambda: clock[0], monotonic=lambda: clock[0])
    for mod in (serving, tracing):
        monkeypatch.setattr(mod, "time", fake_time)
    monkeypatch.setattr(tracing, "secrets", types.SimpleNamespace(token_hex=lambda n: f"{next(ids):0{2 * n}x}"))
    serving.reset_for_tests()
    tracing.reset_for_tests()
    return serving, tracing, clock


def admission_transcript(pkg, monkeypatch) -> list:
    serving, tracing, clock = fixed(pkg, monkeypatch)
    c = serving.AdmissionController(inflight_limit=2, inflight_bytes=100, queue_limit=1, target_delay_ms=250.0,
                                    shed_dwell_s=1.0, recover_s=5.0, drain_s=10.0, clock=lambda: clock[0])
    far = serving.Deadline(1e9)
    out = []

    def rejected(exc):
        out.append((type(exc).__name__, exc.status, exc.retry_after_s, exc.message))

    async def run():
        t1 = await c.admit("/r", 10, far, trace_parent="00-" + "ab" * 16 + "-" + "cd" * 8 + "-01")
        t2 = await c.admit("/r", 10, far)
        waiter = asyncio.ensure_future(c.admit("/r", 10, far))
        await asyncio.sleep(0)
        out.append(c.snapshot())
        for nbytes in (10, 500):
            try:
                await c.admit("/r", nbytes, far)
            except serving.ServeRejected as exc:
                rejected(exc)
        clock[0] += 0.4
        c.release(t1, code=200, latency_ms=1800.0)
        t3 = await waiter
        t3.trace.add_span("stage", clock[0], 0.5, rows=1)
        t3.trace.finish(status=200)
        short = asyncio.ensure_future(c.admit("/r", 10, serving.Deadline(clock[0] + 0.1)))
        await asyncio.sleep(0)
        clock[0] += 0.2
        c.release(t2, code=500)
        try:
            await short
        except serving.ServeRejected as exc:
            rejected(exc)
        out.append(c.snapshot())
        c.begin_drain()
        try:
            await c.admit("/r", 10, far)
        except serving.ServeRejected as exc:
            rejected(exc)
        out.append((c.drain_ready(), c.retry_after_s()))
        c.release(t3, code=200, latency_ms=900.0)
        out.append((c.drain_ready(), c.snapshot()))
        t1.trace.finish(status=200)

    asyncio.run(run())
    out.append(tracing.snapshot())
    serving.reset_for_tests()
    tracing.reset_for_tests()
    return out


def test_admission_and_traces_match_jax(monkeypatch):
    got = {pkg: admission_transcript(pkg, monkeypatch) for pkg in PACKAGES}
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
    rejections = [e for e in got["pathway_tpu"] if isinstance(e, tuple) and isinstance(e[0], str)]
    assert [e[1] for e in rejections] == [429, 429, 504, 503]
    traces = got["pathway_tpu"][-1]
    assert traces["buffered"] == 6 and all(t["spans"] for t in traces["recent"])


FAULTS = {
    "slow_handler": ({"kind": "slow_handler", "source": "/r", "nth": 2, "delay_ms": 250},
                     lambda serving, tracing: [serving.slow_handler_delay_s("/r") for _ in range(3)]),
    "trace_storm": ({"kind": "trace_storm", "source": "/r", "nth": 1, "count": 3},
                    lambda serving, tracing: [tracing.maybe_trace_storm("/r"), tracing.maybe_trace_storm("/r"),
                                              tracing.snapshot()["buffered"]]),
    "request_flood": ({"kind": "request_flood", "source": "/r", "nth": 1, "delay_ms": 60000},
                      lambda serving, tracing: [serving.maybe_flood("/r"), serving.get_controller().inflight]),
}


@pytest.mark.parametrize("kind", list(FAULTS))
def test_serving_faults_fire_as_in_jax(kind):
    spec, fire = FAULTS[kind]
    got = []
    for pw in (jpw, tpw):
        serving, tracing, faults = (sub(pw, f"engine.{m}") for m in ("serving", "tracing", "faults"))
        serving.reset_for_tests()
        tracing.reset_for_tests()
        faults.install_plan(faults.FaultPlan([spec]))
        try:
            got.append(fire(serving, tracing))
        finally:
            faults.clear_plan()
            serving.reset_for_tests()
            tracing.reset_for_tests()
    assert got[1] == got[0] and any(got[0])


def test_bind_failure_raises_and_close_frees_the_port():
    import socket

    blocker = socket.socket()
    blocker.bind((rp.HOST, 0))
    blocker.listen(1)
    try:
        with pytest.raises(RuntimeError, match="failed to start"):
            tpw.io.http.PathwayWebserver(rp.HOST, blocker.getsockname()[1])._start()
    finally:
        blocker.close()
    server = tpw.io.http.PathwayWebserver(rp.HOST, rp.free_ports(1)[0])
    server._start()
    server.close()
    with pytest.raises(OSError):
        socket.create_connection((rp.HOST, server.port), timeout=5).close()


def test_get_query_strings_reach_the_schema_uncoerced():
    """A GET's query values are strings, and the poller's coercion leaves
    them so: ``GET /v1/retrieve?k=1`` fails the run in both packages
    (``min(k, n)`` on a str), as the JAX package does."""
    for pw in (jpw, tpw):
        dt = sub(pw, "internals.dtype")
        assert dt.coerce("1", dt.INT) == "1"


# (server, route, payload, headers, method, expected status)
REQUESTS = {
    "add": (0, "/add", ADD, None, None, 200),
    "add_get_is_no_route": (0, "/add", None, None, "GET", 404),
    "malformed": (0, "/add", b"{not json", None, None, 400),
    "not_object": (0, "/add", b"[1, 2]", None, None, 400),
    "bad_deadline": (0, "/add", ADD, {"X-Pathway-Deadline-Ms": "-5"}, None, 400),
    "deadline": (0, "/add", ADD, {"X-Pathway-Deadline-Ms": "0.001"}, None, 504),
    "unknown_route": (0, "/nope", {}, None, None, 404),
    "pipeline_error": (0, "/div", {"a": 1, "b": 0}, None, None, 500),
    "div": (0, "/div", {"a": 9, "b": 3}, None, None, 200),
    "schema": (0, "/_schema", None, None, "GET", 200),
    "answer": (1, "/v1/pw_ai_answer", {"prompt": "what is alpha?"}, None, None, 200),
    "answer_context": (1, "/v2/answer", {"prompt": "kappa", "return_context_docs": True}, None, None, 200),
    "retrieve": (1, "/v1/retrieve", {"query": "alpha beta gamma", "k": 2}, None, None, 200),
    "list_get": (1, "/v1/pw_list_documents?filepath_globpattern=/1*", None, None, "GET", 200),
    "statistics": (1, "/v1/statistics", {}, None, None, 200),
    "list": (1, "/v1/pw_list_documents", {}, None, None, 200),
    "missing_field": (1, "/v1/pw_ai_answer", {}, None, None, 200),
}


def ask(ports, name):
    server, route, payload, headers, method, _ = REQUESTS[name]
    return rp.call(ports[server], route, payload, headers, method)


@pytest.mark.parametrize("name", list(REQUESTS))
def test_requests_get_jax_answers(servers, name):
    got = {pkg: ask(servers[pkg], name) for pkg in PACKAGES}
    assert got["pathway_tpu"][0] == REQUESTS[name][-1]
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]


def test_flood_sheds_429_with_retry_after(servers):
    got = {pkg: rp.call(servers[pkg][0], "/flood", ADD) for pkg in PACKAGES}
    status, body, retry_after = got["pathway_tpu_torch"]
    assert status == 429 and int(retry_after) >= 1 and "error" in body
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
