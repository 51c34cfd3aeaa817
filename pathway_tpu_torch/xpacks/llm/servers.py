"""REST servers for RAG apps (parity: xpacks/llm/servers.py:16-292).

A copy of ``pathway_tpu/xpacks/llm/servers.py``:
``BaseRestServer``/``DocumentStoreServer``/``QARestServer``/
``QASummaryRestServer`` and ``serve_callable``, all built on
``pw.io.http.rest_connector``: requests are streaming rows, responses are
delivered when the result row appears.  Generation-backed routes
(``/v1/pw_ai_answer``, ``/v2/answer``, ``/v1/pw_ai_summary``) reach the
decoder through the ``JaxChat`` UDF and the process-wide continuous
batching scheduler (``serving/generation.py``).

``run_server(with_cache=True)``, the default, needs the persistence layer
of slice H4 and raises until then.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector


class BaseRestServer:
    def __init__(self, host: str, port: int, **rest_kwargs):
        self.host = host
        self.port = port
        self.webserver = PathwayWebserver(host=host, port=port)
        self._routes: list = []

    def serve(
        self,
        route: str,
        schema: type[schema_mod.Schema],
        handler: Callable[[Table], Table],
        *,
        methods: tuple = ("POST",),
        retry_strategy=None,
        cache_strategy=None,
        documentation=None,
        degraded_handler: Callable[[dict], Any] | None = None,
    ) -> None:
        """Mount ``handler`` on ``route``.

        ``degraded_handler`` is the overload fallback (engine/serving.py):
        while the admission controller's shedder is engaged, requests to
        this route are answered by the callable (sync or async,
        ``payload dict -> jsonable``) instead of the pipeline — e.g. a
        keyword-only retrieval when the embedding path is saturated.
        Responses carry ``X-Pathway-Degraded: 1``.  Routes without one
        shed with ``429`` instead."""
        queries, writer = rest_connector(
            webserver=self.webserver,
            route=route,
            methods=list(methods),
            schema=schema,
            autocommit_duration_ms=50,
            delete_completed_queries=False,
            documentation=documentation,
            degraded_handler=degraded_handler,
        )
        writer(handler(queries))
        self._routes.append(route)

    def run_server(
        self,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend: Any = None,
        terminate_on_error: bool = True,
        **kwargs,
    ):
        """Run the pipeline (parity: servers.py run_server).

        ``with_cache`` routes the UDF disk caches through the persistence
        layer, which the port brings in slice H4: until then it raises
        ``NotImplementedError``; pass ``with_cache=False``.  A served run
        never ends by itself; :meth:`close` frees the port."""
        if with_cache:
            raise NotImplementedError(
                "run_server(with_cache=True) caches UDF results through "
                "engine/persistence.py, which the port brings in slice H4; "
                "pass with_cache=False"
            )
        persistence_config = None

        def _run():
            return pw.run(
                terminate_on_error=terminate_on_error,
                persistence_config=persistence_config,
            )

        if threaded:
            t = threading.Thread(target=_run, daemon=True, name="pathway:server")
            t.start()
            return t
        return _run()

    def close(self) -> None:
        """Close the listening socket (the port's own addition)."""
        self.webserver.close()


class DocumentStoreServer(BaseRestServer):
    """Exposes /v1/retrieve, /v1/statistics, /v1/inputs (parity :16)."""

    def __init__(self, host: str, port: int, document_store, **rest_kwargs):
        super().__init__(host, port, **rest_kwargs)
        self.document_store = document_store
        self.serve(
            "/v1/retrieve",
            document_store.RetrieveQuerySchema,
            document_store.retrieve_query,
            methods=("GET", "POST"),
        )
        self.serve(
            "/v1/statistics",
            document_store.StatisticsQuerySchema,
            document_store.statistics_query,
            methods=("GET", "POST"),
        )
        self.serve(
            "/v1/inputs",
            document_store.InputsQuerySchema,
            document_store.inputs_query,
            methods=("GET", "POST"),
        )


class QARestServer(BaseRestServer):
    """Exposes the question-answerer endpoints (parity: servers.py:~150)."""

    def __init__(self, host: str, port: int, rag_question_answerer, **rest_kwargs):
        super().__init__(host, port, **rest_kwargs)
        self.rag = rag_question_answerer
        self.serve(
            "/v1/pw_ai_answer",
            rag_question_answerer.AnswerQuerySchema,
            rag_question_answerer.answer_query,
            methods=("POST",),
        )
        self.serve(
            "/v2/answer",
            rag_question_answerer.AnswerQuerySchema,
            rag_question_answerer.answer_query,
            methods=("POST",),
        )
        self.serve(
            "/v1/retrieve",
            rag_question_answerer.RetrieveQuerySchema,
            rag_question_answerer.retrieve,
            methods=("GET", "POST"),
        )
        self.serve(
            "/v1/pw_list_documents",
            rag_question_answerer.InputsQuerySchema,
            rag_question_answerer.list_documents,
            methods=("GET", "POST"),
        )
        self.serve(
            "/v2/list_documents",
            rag_question_answerer.InputsQuerySchema,
            rag_question_answerer.list_documents,
            methods=("GET", "POST"),
        )
        self.serve(
            "/v1/statistics",
            rag_question_answerer.StatisticsQuerySchema,
            rag_question_answerer.statistics,
            methods=("GET", "POST"),
        )


class QASummaryRestServer(QARestServer):
    """Adds the summarization endpoint (parity: servers.py:~250)."""

    def __init__(self, host: str, port: int, rag_question_answerer, **rest_kwargs):
        super().__init__(host, port, rag_question_answerer, **rest_kwargs)
        self.serve(
            "/v1/pw_ai_summary",
            rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
            methods=("POST",),
        )
        self.serve(
            "/v2/summarize",
            rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
            methods=("POST",),
        )


def serve_callable(
    route: str,
    schema: type[schema_mod.Schema],
    host: str,
    port: int,
    callable_func: Callable | None = None,
    **kwargs,
):
    """Serve a Python callable as a REST endpoint over the streaming engine
    (parity: servers.py serve_callable decorator)."""

    def decorator(func: Callable):
        server = BaseRestServer(host, port)

        def handler(queries: Table) -> Table:
            cols = [getattr(pw.this, n) for n in schema.column_names()]
            return queries.select(
                result=pw.apply_with_type(
                    lambda *vals: func(**dict(zip(schema.column_names(), vals))),
                    object,
                    *cols,
                )
            )

        server.serve(route, schema, handler, **kwargs)
        func._pw_server = server  # type: ignore[attr-defined]
        return func

    if callable_func is not None:
        return decorator(callable_func)
    return decorator
