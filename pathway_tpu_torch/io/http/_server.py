"""REST ingress on the standard library (parity: io/http/_server.py).

A copy of ``pathway_tpu/io/http/_server.py`` with its aiohttp server
replaced by ``asyncio.start_server`` and a small HTTP/1.1 request parser:
the port imports nothing outside the standard library, torch and numpy.
The contract is the JAX package's: one ``PathwayWebserver`` per (host,
port), routes added by ``rest_connector``, the same status codes, JSON
bodies, ``Retry-After``, ``X-Pathway-Degraded``, and the
``X-Pathway-Deadline-Ms`` and ``traceparent`` request headers.

Each request: admission (``engine/serving.py`` — bounded in-flight
budget, deadline-aware queue, 429/503 rejects with Retry-After) → a
request id → a deadline-stamped row into the input table → wait on a
future completed by the response writer subscribed to the result table
(or failed typed by the pipeline-error and staging-shed hooks) → reply.

One addition: :meth:`PathwayWebserver.close` closes the listening socket
and ends the serving thread, so a program that served can free its port.
"""

from __future__ import annotations

import asyncio
import itertools
import json as _json
import threading
import time as _time
import urllib.parse
from http import HTTPStatus
from typing import Any

from pathway_tpu_torch.engine import serving, tracing
from pathway_tpu_torch.engine.freshness import safe_label
from pathway_tpu_torch.engine.metrics import MS_BUCKETS, get_registry
from pathway_tpu_torch.engine.types import Error, Json, Pointer, hash_values
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.config import env_float
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._utils import COMMIT, Reader

DEADLINE_HEADER = "X-Pathway-Deadline-Ms"
TRACEPARENT_HEADER = "traceparent"
MAX_BODY_BYTES = 1024**2  # aiohttp's default client_max_size


class EndpointExamples:
    """Named request examples for endpoint documentation (reference
    _server.py:89); rendered into the OpenAPI schema's ``examples`` map."""

    def __init__(self):
        self.examples_by_id = {}

    def add_example(self, id, summary, values):
        if id in self.examples_by_id:
            raise ValueError(f"Duplicate example id: {id}")
        self.examples_by_id[id] = {"summary": summary, "value": values}
        return self

    def _openapi_description(self):
        return self.examples_by_id


class EndpointDocumentation:
    def __init__(
        self,
        *,
        summary=None,
        description=None,
        tags=None,
        method_types=None,
        examples: "EndpointExamples | None" = None,
        **kw,
    ):
        self.summary = summary
        self.description = description
        self.tags = tags
        self.method_types = method_types
        self.examples = examples


# ---------------------------------------------------------------------------
# HTTP/1.1 on asyncio streams
# ---------------------------------------------------------------------------


class _BadRequest(Exception):
    """The bytes on the socket are not an HTTP/1.1 request."""


class Request:
    """One parsed request: what a route handler reads."""

    __slots__ = ("method", "path", "query", "headers", "body", "keep_alive")

    def __init__(self, method: str, path: str, query: dict, headers: dict, body: bytes, keep_alive: bool):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers  # lower-cased names
        self.body = body
        self.keep_alive = keep_alive

    def header(self, name: str) -> str | None:
        return self.headers.get(name.lower())


class Response:
    """One JSON response: status, body value, extra headers."""

    __slots__ = ("status", "body", "headers")

    def __init__(self, body: Any, status: int = 200, headers: dict | None = None):
        self.status = status
        self.body = body
        self.headers = headers or {}

    def encode(self, keep_alive: bool) -> bytes:
        try:
            payload = _json.dumps(self.body).encode()
        except (TypeError, ValueError):
            self.status, payload = 500, _json.dumps({"error": "response is not JSON-serializable"}).encode()
        reason = HTTPStatus(self.status).phrase
        lines = [
            f"HTTP/1.1 {self.status} {reason}",
            "Content-Type: application/json; charset=utf-8",
            f"Content-Length: {len(payload)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}",
        ]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + payload


async def _read_body(reader: asyncio.StreamReader, headers: dict) -> bytes:
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = b""
        while True:
            size = int((await reader.readline()).split(b";")[0].strip() or b"0", 16)
            if size == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                return body
            body += await reader.readexactly(size)
            if len(body) > MAX_BODY_BYTES:
                raise _BadRequest("body too large")
            await reader.readexactly(2)
    n = int(headers.get("content-length") or 0)
    if n < 0:
        raise _BadRequest("negative Content-Length")
    if n > MAX_BODY_BYTES:
        raise _BadRequest("body too large")
    return await reader.readexactly(n) if n else b""


async def _read_request(reader: asyncio.StreamReader) -> Request | None:
    """The next request on the connection; ``None`` at a clean EOF."""
    line = await reader.readline()
    if not line.strip():
        return None
    parts = line.decode("latin-1").rstrip("\r\n").split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise _BadRequest("malformed request line")
    method, target, version = parts
    headers: dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, sep, value = h.decode("latin-1").partition(":")
        if not sep:
            raise _BadRequest("malformed header line")
        headers.setdefault(name.strip().lower(), value.strip())
    try:
        body = await _read_body(reader, headers)
    except ValueError as exc:
        raise _BadRequest(str(exc)) from exc
    url = urllib.parse.urlsplit(target)
    query: dict[str, str] = {}
    for k, v in urllib.parse.parse_qsl(url.query, keep_blank_values=True):
        query.setdefault(k, v)
    conn = headers.get("connection", "").lower()
    keep_alive = conn != "close" if version == "HTTP/1.1" else conn == "keep-alive"
    return Request(method.upper(), urllib.parse.unquote(url.path), query, headers, body, keep_alive)


class PathwayWebserver:
    """Shared asyncio server on a daemon thread; routes added by
    rest_connector."""

    def __init__(self, host: str, port: int, with_schema_endpoint: bool = False, with_cors: bool = False):
        self.host = host
        self.port = port
        self._routes: dict[tuple[str, str], Any] = {}
        self._route_docs: dict[str, dict] = {}  # route -> openapi path item
        self.with_schema_endpoint = with_schema_endpoint
        self._started = False
        self._start_lock = threading.Lock()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._stopping: asyncio.Event | None = None
        self._ready = threading.Event()
        self._closed = threading.Event()
        self._startup_error: BaseException | None = None

    def _add_route(self, route: str, methods: list[str], handler, *, schema=None, documentation=None) -> None:
        for m in methods:
            self._routes[(m.upper(), route)] = handler
        self._route_docs[route] = self._openapi_path_item(methods, schema, documentation)

    @staticmethod
    def _openapi_path_item(methods, schema, documentation) -> dict:
        """OpenAPI v3 path item for one route (the reference's schema
        endpoint, _server.py:188): request properties from the input
        schema's columns, plus summary/description/tags/examples from the
        EndpointDocumentation."""
        _PRIMITIVES = {int: "integer", float: "number", bool: "boolean", str: "string"}
        properties = {}
        if schema is not None:
            for name, col in schema.__columns__.items():
                hint = getattr(col.dtype, "typehint", str)
                properties[name] = {"type": _PRIMITIVES.get(hint, "string")}
        body_schema = {"type": "object", "properties": properties}
        item: dict = {}
        doc = documentation
        for m in methods:
            op: dict = {"responses": {"200": {"description": "OK"}}}
            if doc is not None:
                if doc.summary:
                    op["summary"] = doc.summary
                if doc.description:
                    op["description"] = doc.description
                if doc.tags:
                    op["tags"] = list(doc.tags)
            content: dict = {"schema": body_schema}
            if doc is not None and getattr(doc, "examples", None) is not None:
                content["examples"] = doc.examples._openapi_description()
            if m.upper() in ("POST", "PUT", "PATCH"):
                op["requestBody"] = {"content": {"application/json": content}}
            item[m.lower()] = op
        return item

    def openapi_description_json(self) -> dict:
        return {
            "openapi": "3.0.3",
            "info": {"title": "Pathway REST API", "version": "1.0.0"},
            "paths": dict(self._route_docs),
        }

    async def _dispatch(self, request: Request) -> Response:
        if self.with_schema_endpoint and request.method == "GET" and request.path == "/_schema":
            return Response(self.openapi_description_json())
        handler = self._routes.get((request.method, request.path))
        if handler is None:
            return Response({"error": "no such route"}, status=404)
        try:
            return await handler(request)
        except Exception:  # noqa: BLE001 - a handler bug answers 500, never a dropped socket
            return Response({"error": "internal server error"}, status=500)

    async def _serve_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    request = await _read_request(reader)
                except (_BadRequest, asyncio.LimitOverrunError, ValueError) as exc:
                    status = 413 if "too large" in str(exc) else 400
                    writer.write(Response({"error": f"malformed HTTP request: {exc}"}, status).encode(False))
                    await writer.drain()
                    return
                if request is None:
                    return
                response = await self._dispatch(request)
                writer.write(response.encode(request.keep_alive))
                await writer.drain()
                if not request.keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            return
        finally:
            writer.close()

    def _start(self) -> None:
        with self._start_lock:
            if self._started:
                return
            self._started = True

        async def main():
            try:
                server = await asyncio.start_server(self._serve_connection, self.host, self.port)
            except BaseException as exc:  # bind failure, bad host, …
                self._startup_error = exc
                self._ready.set()
                return
            self._stopping = asyncio.Event()
            self._ready.set()
            await self._stopping.wait()
            server.close()

        def serve():
            loop = self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            try:
                loop.run_until_complete(main())
                pending = asyncio.all_tasks(loop)
                for task in pending:
                    task.cancel()
                loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
            finally:
                loop.close()
                self._closed.set()

        self._thread = threading.Thread(target=serve, name="pathway:webserver", daemon=True)
        self._thread.start()
        # a swallowed bind failure would surface as every request timing
        # out much later — propagate loudly instead
        if not self._ready.wait(timeout=10):
            raise RuntimeError(f"webserver on {self.host}:{self.port} did not become ready within 10 s")
        if self._startup_error is not None:
            raise RuntimeError(
                f"webserver failed to start on {self.host}:{self.port}: "
                f"{self._startup_error!r} (is the port already in use?)"
            ) from self._startup_error

    def close(self, timeout: float = 10.0) -> None:
        """Close the listening socket, cancel open connections and end the
        serving thread; the routes' readers return.  Idempotent."""
        loop, stopping = self._loop, self._stopping
        if loop is not None and stopping is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(stopping.set)
            except RuntimeError:
                pass  # the loop closed meanwhile
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._closed.set()


class _RestSubject(Reader):
    """Bridges HTTP requests into the input table.

    Every request passes the process-global admission controller
    (``engine/serving.py``) before its row is emitted, carries a
    deadline (``X-Pathway-Deadline-Ms`` header, default
    ``PATHWAY_SERVE_DEADLINE_MS``) stamped onto the row, and is answered
    typed on every path — 400 malformed, 429 overloaded (+Retry-After),
    503 draining, 504 deadline, 500 pipeline error — never a stranded
    socket."""

    def __init__(self, webserver: PathwayWebserver, route: str, methods: list[str], schema,
                 delete_completed_queries: bool, documentation=None, degraded_handler=None):
        self.webserver = webserver
        self.route = route
        self.methods = methods
        self.schema = schema
        self.delete_completed_queries = delete_completed_queries
        self.documentation = documentation
        self.degraded_handler = degraded_handler
        self.futures: dict[int, asyncio.Future] = {}
        self._seq = itertools.count()
        self._emit = None

    def _count(self, code: int, route_label: str) -> None:
        get_registry().counter(
            "serve.requests", "REST requests answered, by status code", code=str(code), route=route_label,
        ).inc()

    def _reject(self, route_label: str, rej: serving.ServeRejected) -> Response:
        self._count(rej.status, route_label)
        headers = {}
        if rej.retry_after_s:
            headers["Retry-After"] = str(int(rej.retry_after_s))
        return Response({"error": rej.message}, status=rej.status, headers=headers)

    def run(self, emit) -> None:
        self._emit = emit
        names = list(self.schema.__columns__.keys())
        dtypes = {n: self.schema.__columns__[n].dtype for n in names}
        route_label = safe_label(self.route)

        async def handler(request: Request) -> Response:
            if request.method in ("POST", "PUT", "PATCH"):
                body = request.body
                if body:
                    try:
                        payload = _json.loads(body)
                    except ValueError:
                        self._count(400, route_label)
                        return Response({"error": "malformed JSON payload"}, status=400)
                    if not isinstance(payload, dict):
                        self._count(400, route_label)
                        return Response({"error": "JSON payload must be an object"}, status=400)
                else:
                    payload = {}
            else:
                body = b""
                payload = dict(request.query)
            header = request.header(DEADLINE_HEADER)
            if header is not None:
                try:
                    deadline_ms = float(header)
                    if deadline_ms <= 0:
                        raise ValueError(header)
                except ValueError:
                    self._count(400, route_label)
                    return Response({"error": f"invalid {DEADLINE_HEADER} header"}, status=400)
            else:
                deadline_ms = env_float("PATHWAY_SERVE_DEADLINE_MS")
            deadline = serving.Deadline.from_ms(deadline_ms)
            controller = serving.get_controller()
            serving.maybe_flood(self.route)  # chaos: request_flood
            tracing.maybe_trace_storm(self.route)  # chaos: trace_storm
            ingress_started = _time.time()
            try:
                ticket = await controller.admit(
                    self.route, len(body), deadline, trace_parent=request.header(TRACEPARENT_HEADER),
                )
            except serving.ServeRejected as rej:
                return self._reject(route_label, rej)
            trace = ticket.trace
            if trace is not None:
                trace.add_span(
                    "serve.ingress", ingress_started, max(0.0, _time.time() - ingress_started),
                    method=request.method, nbytes=len(body),
                )
            started = _time.monotonic()
            code = 500
            try:
                with tracing.trace_scope(trace):
                    # chaos: slow_handler stalls while HOLDING the admission
                    # slot — queue delay climbs, shedding paths fire
                    stall_s = serving.slow_handler_delay_s(self.route)
                    if stall_s > 0.0:
                        await asyncio.sleep(stall_s)
                    if controller.degraded and self.degraded_handler is not None:
                        value = self.degraded_handler(payload)
                        if asyncio.iscoroutine(value):
                            value = await value
                        code = 200
                        get_registry().counter(
                            "serve.degraded.served", "requests answered by a degraded_handler", route=route_label,
                        ).inc()
                        return Response(_jsonable(value), headers={"X-Pathway-Degraded": "1"})
                    rid = next(self._seq)
                    key = hash_values(["rest", id(self), rid])
                    row = {"_pw_key": key, _utils.DEADLINE_TS: deadline.at}
                    if trace is not None:
                        # the trace rides the row like the deadline
                        row[tracing.TRACE_STAMP] = trace.traceparent()
                    for n in names:
                        v = payload.get(n)
                        if dtypes[n].strip_optional() is dt.JSON and v is not None:
                            v = Json(v)
                        row[n] = v
                    future = asyncio.get_running_loop().create_future()
                    self.futures[key] = future
                    serving.register_request(key, lambda status, msg, _k=key: self.fail(_k, status, msg))
                    # key→trace binding: the async-UDF node re-enters this
                    # trace's scope when it computes this row
                    tracing.bind_key(key, trace)
                    emit(row)
                    emit(COMMIT)
                    pipeline_started = _time.time()
                    try:
                        result = await asyncio.wait_for(future, timeout=max(0.0, deadline.remaining_s()))
                    except asyncio.TimeoutError:
                        code = 504
                        serving.note_deadline_shed("handler")
                        return Response({"error": "deadline exceeded"}, status=504)
                    finally:
                        if trace is not None:
                            trace.add_span(
                                "serve.pipeline", pipeline_started, max(0.0, _time.time() - pipeline_started),
                            )
                        serving.unregister_request(key)
                        tracing.unbind_key(key)
                        self.futures.pop(key, None)
                        if self.delete_completed_queries:
                            drow = dict(row)
                            drow[_utils.DELETE] = True
                            emit(drow)
                            emit(COMMIT)
                    if isinstance(result, serving.ServeRejected):
                        # typed completion from the pipeline side: row error,
                        # staging shed, or result retraction
                        code = result.status
                        return Response({"error": result.message}, status=result.status)
                    code = 200
                    return Response(result)
            finally:
                latency_ms = (_time.monotonic() - started) * 1000.0
                self._count(code, route_label)
                if code == 200:
                    get_registry().histogram(
                        "serve.latency.ms", "admitted-request end-to-end latency (ms)",
                        buckets=MS_BUCKETS, route=route_label,
                    ).observe(latency_ms, trace_id=trace.trace_id if trace is not None else None)
                if trace is not None:
                    trace.finish(status=code)
                controller.release(ticket, code=code, latency_ms=latency_ms)

        self.webserver._add_route(
            self.route, self.methods, handler, schema=self.schema, documentation=self.documentation,
        )
        self.webserver._start()
        self.webserver._closed.wait()  # a streaming source: runs until the server closes

    def complete(self, key: int, value: Any) -> None:
        future = self.futures.get(key)
        if future is not None and not future.done():
            future.get_loop().call_soon_threadsafe(lambda: future.done() or future.set_result(value))

    def fail(self, key: int, status: int, message: str) -> None:
        """Complete a waiting request with a typed error (pipeline row
        error, staging shed, or result retraction) — threadsafe, no-op
        once the future resolved or the request finished."""
        future = self.futures.get(key)
        if future is None:
            return
        if status == 504:
            err: serving.ServeRejected = serving.DeadlineExceededError(message)
        else:
            err = serving.RequestFailedError(message)
        future.get_loop().call_soon_threadsafe(lambda: future.done() or future.set_result(err))


def _jsonable(v):
    if isinstance(v, Json):
        return v.value
    if isinstance(v, Pointer):
        return repr(v)
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    import numpy as np

    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def rest_connector(
    host: str | None = None,
    port: int | None = None,
    *,
    webserver: PathwayWebserver | None = None,
    route: str = "/",
    methods: list[str] = ("POST",),
    schema: type[schema_mod.Schema] | None = None,
    autocommit_duration_ms: int | None = 50,
    keep_queries: bool | None = None,
    delete_completed_queries: bool = False,
    request_validator=None,
    documentation: EndpointDocumentation | None = None,
    degraded_handler=None,
) -> tuple[Table, Any]:
    """Returns (queries_table, response_writer).

    ``degraded_handler`` — optional plain callable (or coroutine
    function) ``payload_dict -> jsonable``: while the load shedder is
    engaged, requests to this route are answered by it directly
    (``X-Pathway-Degraded: 1`` response header) instead of entering the
    pipeline."""
    if webserver is None:
        if host is None or port is None:
            raise ValueError("provide webserver= or host=/port=")
        webserver = PathwayWebserver(host, port)
    if schema is None:
        schema = schema_mod.schema_from_types(query=str)
    subject = _RestSubject(
        webserver, route, list(methods), schema, delete_completed_queries,
        documentation=documentation, degraded_handler=degraded_handler,
    )
    table = _utils.make_input_table(schema, lambda: subject, autocommit_duration_ms=autocommit_duration_ms)

    def response_writer(response_table: Table) -> None:
        names = response_table.column_names()

        def on_data(key, row, time, diff):
            if diff <= 0:
                # the pipeline retracted the result row while the client
                # is still waiting: typed 500 instead of a silent 504
                subject.fail(key, 500, "result row retracted by the pipeline")
                return
            if any(isinstance(v, Error) for v in row):
                # a poisoned cell reached the response: typed 500, never a
                # JSON-serialization crash
                subject.fail(key, 500, "result row contains an error value")
                return
            if "result" in names:
                value = _jsonable(row[names.index("result")])
            else:
                value = {n: _jsonable(v) for n, v in zip(names, row)}
            subject.complete(key, value)

        _utils.register_output(response_table, on_data, name=f"rest:{route}")

    return table, response_writer
