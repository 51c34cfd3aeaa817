"""Serving programs shared by the REST and answering parity tests.

``python -m tests.torch_rest_programs PACKAGE PROGRAM PORT [PORT ...]
[--block]`` builds PROGRAM in PACKAGE (``pathway_tpu`` or
``pathway_tpu_torch``) and serves it until killed.  ``--block`` first makes
``import aiohttp``, ``jax``, ``flax`` and ``pathway_tpu`` fail, so that the
port's standard-library server is what runs.

* ``rest`` (2 ports): ``rest_connector`` routes ``/add`` (a + b),
  ``/div`` (a // b: a zero divisor is a pipeline error) and ``/flood`` on a
  ``PathwayWebserver`` with the ``/_schema`` endpoint, and a
  ``QARestServer`` over ``BaseRAGQuestionAnswerer`` on the second port.
* ``rag`` (3 ports): ``BaseRAGQuestionAnswerer`` and
  ``AdaptiveRAGQuestionAnswerer`` behind ``build_server`` on the first two
  ports, over one ``DocumentStore``, and ``VectorStoreServer.run_server``
  on the third, which runs them all.

Both use ``mocks.FakeEmbeddings`` and ``mocks.IdentityMockChat``, and run
with ``terminate_on_error=False``.  :func:`call` is the tests' client.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

HOST = "127.0.0.1"
BLOCKED = ("aiohttp", "jax", "jaxlib", "flax", "pathway_tpu")
DOCS = ["alpha beta gamma", "delta epsilon", "zeta eta theta iota", "kappa lambda", "mu nu xi omicron pi",
        "rho sigma tau"]


class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {name} is blocked in this process")
        return None


def _store(pw):
    from tests.torch_dataflow_programs import port_kw

    mocks = importlib.import_module(f"{pw.__name__}.xpacks.llm.mocks")
    _utils = importlib.import_module(f"{pw.__name__}.io._utils")
    indexing = importlib.import_module(f"{pw.__name__}.stdlib.indexing")
    llm_pkg = importlib.import_module(f"{pw.__name__}.xpacks.llm")
    docs = _utils.make_static_input_table(
        pw.schema_from_types(data=bytes, _metadata=pw.Json),
        [{"data": t.encode(), "_metadata": pw.Json({"path": f"/{i}.txt"})} for i, t in enumerate(DOCS)],
    )
    store = llm_pkg.DocumentStore(docs, indexing.BruteForceKnnFactory(embedder=mocks.FakeEmbeddings(),
                                                                      **port_kw(pw)))
    return docs, store, mocks, llm_pkg


def rest_program(pw, rest_port: int, qa_port: int) -> None:
    http = pw.io.http

    class Q(pw.Schema):
        a: int
        b: int

    examples = http.EndpointExamples().add_example("one", "one plus one", {"a": 1, "b": 1})
    doc = http.EndpointDocumentation(summary="add two ints", tags=["math"], examples=examples)
    server = http.PathwayWebserver(HOST, rest_port, with_schema_endpoint=True)
    for route, fn in (("/add", lambda t: t.a + t.b), ("/div", lambda t: t.a // t.b), ("/flood", lambda t: t.a)):
        queries, respond = http.rest_connector(webserver=server, route=route, schema=Q,
                                               delete_completed_queries=True, documentation=doc)
        respond(queries.select(result=fn(pw.this)))
    _docs, store, mocks, llm = _store(pw)
    llm.servers.QARestServer(HOST, qa_port, llm.BaseRAGQuestionAnswerer(mocks.IdentityMockChat(), store))
    pw.run(terminate_on_error=False)


def rag_program(pw, base_port: int, adaptive_port: int, vs_port: int) -> None:
    from tests.torch_dataflow_programs import port_kw

    docs, store, mocks, llm = _store(pw)
    llm.BaseRAGQuestionAnswerer(mocks.IdentityMockChat(), store).build_server(HOST, base_port)
    llm.AdaptiveRAGQuestionAnswerer(mocks.IdentityMockChat(), store).build_server(HOST, adaptive_port)
    vs = llm.VectorStoreServer(docs, embedder=mocks.FakeEmbeddings(), **port_kw(pw))
    vs.run_server(HOST, vs_port, with_cache=False, terminate_on_error=False)


PROGRAMS = {"rest": rest_program, "rag": rag_program}


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind((HOST, 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def call(port: int, route: str, payload=None, headers: dict | None = None, method: str | None = None,
         timeout: float = 20.0) -> tuple:
    """(status, JSON body, Retry-After) of one request; 4xx/5xx answered,
    never raised.  ``payload``: bytes as they are, else JSON-encoded."""
    data = payload if isinstance(payload, bytes) or payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://{HOST}:{port}{route}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})},
                                 method=method or ("POST" if data is not None else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), resp.headers.get("Retry-After")
    except urllib.error.HTTPError as err:
        body = err.read()
        return err.code, json.loads(body) if body else None, err.headers.get("Retry-After")


def spawn(package: str, program: str, ports: list[int], env: dict | None = None):
    """Start a program in a subprocess; the port's runs with ``--block``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "tests.torch_rest_programs", package, program, *map(str, ports)]
    if package.endswith("_torch"):
        cmd.append("--block")
    full_env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": root, **(env or {})}
    return subprocess.Popen(cmd, cwd=root, env=full_env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def wait_ready(proc, port: int, route: str, payload, deadline_s: float = 60.0) -> None:
    """Poll ``route`` until it answers 200; raise if the process died."""
    deadline = time.monotonic() + deadline_s
    last = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"server died: {proc.stderr.read().decode(errors='replace')[-3000:]}")
        try:
            if call(port, route, payload, timeout=5)[0] == 200:
                return
        except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as exc:
            last = exc
        time.sleep(0.2)
    proc.kill()
    raise RuntimeError(f"server never became ready: {last}")


def stop(procs) -> None:
    for p in procs:
        p.kill()
    for p in procs:
        p.wait(timeout=10)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--block"]
    if "--block" in sys.argv:
        sys.meta_path.insert(0, _Blocker())
    pw = importlib.import_module(args[0])
    PROGRAMS[args[1]](pw, *map(int, args[2:]))
