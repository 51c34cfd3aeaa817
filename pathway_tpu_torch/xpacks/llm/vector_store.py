"""VectorStoreServer / VectorStoreClient (parity: xpacks/llm/vector_store.py:39-769).

A copy of ``pathway_tpu/xpacks/llm/vector_store.py``.  The legacy
(pre-DocumentStore) vector index server: documents in, embedder +
splitter, REST endpoints /v1/retrieve, /v1/statistics, /v1/inputs.  Built on
DocumentStore + the brute-force device index; ``from_langchain_components``
and ``from_llamaindex_components`` adapt third-party splitters/embedders
when those packages are installed.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.udfs import UDF, async_executor
from pathway_tpu_torch.stdlib.indexing.retrievers import BruteForceKnnFactory
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer


def _as_embedder_udf(embedder: Any) -> UDF:
    """Accept a pw UDF, a plain callable, or an async callable."""
    if isinstance(embedder, UDF):
        return embedder
    if callable(embedder):
        import asyncio

        if asyncio.iscoroutinefunction(embedder):
            u = UDF(executor=async_executor())
            u.__wrapped__ = embedder
            return u
        u = UDF()

        def wrapped(text: str) -> np.ndarray:
            return np.asarray(embedder(text))

        u.__wrapped__ = wrapped
        return u
    raise TypeError(f"cannot use {type(embedder)} as an embedder")


class VectorStoreServer:
    """Index documents and serve retrieval queries (parity :39).

    ``device`` is the port's own: the default embedder and the index run
    on ``cuda:0`` unless it names another device."""

    def __init__(
        self,
        *docs: Table,
        embedder: Any = None,
        parser: Callable | None = None,
        splitter: Callable | None = None,
        doc_post_processors: list | None = None,
        device=None,
    ):
        if embedder is None:
            from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

            embedder = SentenceTransformerEmbedder(device=device or "auto")
        embedder = _as_embedder_udf(embedder)
        retriever_factory = BruteForceKnnFactory(embedder=embedder, device=device)
        self.document_store = self._document_store_cls(
            list(docs),
            retriever_factory,
            parser=parser,
            splitter=splitter,
            doc_post_processors=doc_post_processors,
        )
        self._server: DocumentStoreServer | None = None

    _document_store_cls: type[DocumentStore] = DocumentStore

    # constructor adapters (parity :~200)
    @classmethod
    def from_langchain_components(
        cls, *docs, embedder=None, parser=None, splitter=None, **kwargs
    ) -> "VectorStoreServer":
        sp = None
        if splitter is not None:

            def lc_splitter(text, metadata=None):
                return tuple((c, Json({})) for c in splitter.split_text(text))

            sp = UDF()
            sp.__wrapped__ = lc_splitter

        embed = None
        if embedder is not None:

            async def embed(text: str) -> np.ndarray:  # noqa: F811
                return np.asarray(await embedder.aembed_query(text))

        return cls(*docs, embedder=embed, parser=parser, splitter=sp, **kwargs)

    @classmethod
    def from_llamaindex_components(
        cls, *docs, transformations: list | None = None, parser=None, **kwargs
    ) -> "VectorStoreServer":
        embedder = None
        splitter = None
        for t in transformations or []:
            if hasattr(t, "get_text_embedding"):
                emb = t

                def embedder(text: str) -> np.ndarray:  # noqa: F811
                    return np.asarray(emb.get_text_embedding(text))

            elif hasattr(t, "split_text") or hasattr(t, "get_nodes_from_documents"):
                # llamaindex node parsers (SentenceSplitter etc.)
                node_parser = t
                sp = UDF()
                if hasattr(node_parser, "split_text"):
                    sp.__wrapped__ = lambda text: [
                        (c, Json({})) for c in node_parser.split_text(text)
                    ]
                else:
                    def _split_nodes(text, _np=node_parser):
                        from llama_index.core.schema import Document  # type: ignore

                        nodes = _np.get_nodes_from_documents([Document(text=text)])
                        return [(n.get_content(), Json({})) for n in nodes]

                    sp.__wrapped__ = _split_nodes
                splitter = sp
        if embedder is None:
            raise ValueError(
                "from_llamaindex_components: no embedding transformation found "
                "(expected one with .get_text_embedding); pass an embed_model "
                "in `transformations` — refusing to silently substitute the "
                "default embedder"
            )
        return cls(*docs, embedder=embedder, parser=parser, splitter=splitter, **kwargs)

    # query handlers (same signatures as the reference)
    def retrieve_query(self, retrieval_queries: Table) -> Table:
        return self.document_store.retrieve_query(retrieval_queries)

    def statistics_query(self, info_queries: Table) -> Table:
        return self.document_store.statistics_query(info_queries)

    def inputs_query(self, input_queries: Table) -> Table:
        return self.document_store.inputs_query(input_queries)

    @property
    def index(self):
        return self.document_store.index

    RetrieveQuerySchema = DocumentStore.RetrieveQuerySchema
    StatisticsQuerySchema = DocumentStore.StatisticsQuerySchema
    InputsQuerySchema = DocumentStore.InputsQuerySchema

    def run_server(
        self,
        host: str,
        port: int,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend: Any = None,
        terminate_on_error: bool = True,
    ):
        """Start the REST server + pipeline (parity :~600)."""
        # serve self (not the store) so subclass query overrides — e.g.
        # SlidesVectorStoreServer.inputs_query — reach the HTTP endpoints
        self._server = DocumentStoreServer(host, port, self)
        return self._server.run_server(
            threaded=threaded,
            with_cache=with_cache,
            cache_backend=cache_backend,
            terminate_on_error=terminate_on_error,
        )


class SlidesVectorStoreServer(VectorStoreServer):
    """Vector index server for the slide-search application
    (parity: vector_store.py:588-648).

    Uses the slide document store (default parser = ``SlideParser``) and
    answers ``/v1/inputs`` with the per-slide metadata captured *after*
    parsing and post-processing, with the bulky ``b64_image`` entries
    stripped — the reference's modified ``pw_list_documents`` behavior.
    """

    excluded_response_metadata = ["b64_image"]

    @property
    def _document_store_cls(self):
        from pathway_tpu_torch.xpacks.llm.document_store import SlidesDocumentStore

        return SlidesDocumentStore

    def __init__(self, *docs, **kwargs):
        super().__init__(*docs, **kwargs)
        # the store's pack() reads its own attribute; propagate so
        # subclass-level excluded_response_metadata config takes effect
        self.document_store.excluded_response_metadata = self.excluded_response_metadata

    def inputs_query(self, input_queries: Table) -> Table:
        return self.document_store.parsed_documents_query(input_queries)

    def parsed_documents_query(self, parse_docs_queries: Table) -> Table:
        return self.document_store.parsed_documents_query(parse_docs_queries)


class VectorStoreClient:
    """HTTP client for a VectorStoreServer (parity :~700)."""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: int = 15,
        additional_headers: dict | None = None,
    ):
        self.url = url or f"http://{host}:{port}"
        self.timeout = timeout
        self.headers = {"Content-Type": "application/json", **(additional_headers or {})}

    def _post(self, route: str, payload: dict) -> Any:
        from pathway_tpu_torch.xpacks.llm._utils import send_post_request

        return send_post_request(
            self.url + route, payload, self.headers, self.timeout
        )

    def query(
        self, query: str, k: int = 3, metadata_filter: str | None = None, filepath_globpattern: str | None = None
    ) -> list[dict]:
        return self._post(
            "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )

    __call__ = query

    def get_vectorstore_statistics(self) -> dict:
        return self._post("/v1/statistics", {})

    def get_input_files(
        self, metadata_filter: str | None = None, filepath_globpattern: str | None = None
    ) -> list:
        return self._post(
            "/v1/inputs",
            {"metadata_filter": metadata_filter, "filepath_globpattern": filepath_globpattern},
        )
