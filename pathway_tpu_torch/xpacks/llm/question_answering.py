"""RAG question answering (parity: xpacks/llm/question_answering.py:97-1030).

A copy of ``pathway_tpu/xpacks/llm/question_answering.py``.

``BaseRAGQuestionAnswerer`` — retrieve top-k, prompt, answer.
``AdaptiveRAGQuestionAnswerer`` — geometric-k re-asking (:97-162): start
with few documents; if the model answers "No information found", double
the context and ask again.  ``SummaryQuestionAnswerer`` adds summarize.
``DeckRetriever`` — slide-deck retrieval app built on the same base.
``BaseContextProcessor``/``SimpleContextProcessor`` (:221,:257) — pluggable
docs→context assembly.  ``RAGClient`` (:879) — HTTP client for the servers.
"""

from __future__ import annotations

import inspect
import json as _json
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this
from pathway_tpu_torch.internals.udfs import UDF
from pathway_tpu_torch.xpacks.llm import prompts
from pathway_tpu_torch.xpacks.llm._utils import send_post_request
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.xpacks.llm.servers import QARestServer, QASummaryRestServer
from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient


class BaseContextProcessor(ABC):
    """Formats retrieved documents into the LLM context string
    (parity: question_answering.py:221-252).

    Subclasses implement ``docs_to_context``; ``apply`` normalizes the
    incoming docs value (Json, list of Json, or list of dicts) first.
    """

    def maybe_unwrap_docs(self, docs) -> list:
        if isinstance(docs, Json):
            doc_ls = list(docs.value or ())
        elif isinstance(docs, (list, tuple)):
            doc_ls = [d.value if isinstance(d, Json) else d for d in docs]
        else:
            raise ValueError(
                "`docs` argument is not Json | list[Json] | list[dict]; "
                "check your pipeline (pw.reducers.tuple may help)"
            )
        if len(doc_ls) == 1 and isinstance(doc_ls[0], (list, tuple)):
            doc_ls = list(doc_ls[0])
        return [d.value if isinstance(d, Json) else d for d in doc_ls]

    def apply(self, docs) -> str:
        return self.docs_to_context(self.maybe_unwrap_docs(docs))

    @abstractmethod
    def docs_to_context(self, docs: list[dict]) -> str: ...

    def as_udf(self) -> UDF:
        u = UDF()
        u.__wrapped__ = self.apply
        return u


@dataclass
class SimpleContextProcessor(BaseContextProcessor):
    """Keeps the listed metadata keys and joins documents with the joiner
    (parity: question_answering.py:257-282).

    Example:

    >>> from pathway_tpu_torch.xpacks.llm.question_answering import SimpleContextProcessor
    >>> proc = SimpleContextProcessor(context_metadata_keys=["path"])
    >>> docs = [
    ...     {"text": "alpha", "metadata": {"path": "/a.txt", "b64_image": "x"}},
    ...     {"text": "beta", "metadata": {"path": "/b.txt"}},
    ... ]
    >>> print(proc.apply(docs))
    {"text": "alpha", "path": "/a.txt"}
    <BLANKLINE>
    {"text": "beta", "path": "/b.txt"}
    """

    context_metadata_keys: list[str] = field(default_factory=lambda: ["path"])
    context_joiner: str = "\n\n"

    def simplify_context_metadata(self, docs: list[dict]) -> list[dict]:
        filtered = []
        for doc in docs:
            if not isinstance(doc, dict):
                filtered.append({"text": str(doc)})
                continue
            entry = {"text": doc.get("text", "")}
            metadata = doc.get("metadata", {}) or {}
            if isinstance(metadata, Json):
                metadata = metadata.value or {}
            for key in self.context_metadata_keys:
                if key in metadata:
                    entry[key] = metadata[key]
            filtered.append(entry)
        return filtered

    def docs_to_context(self, docs: list[dict]) -> str:
        docs = self.simplify_context_metadata(docs)
        return self.context_joiner.join(
            _json.dumps(doc, ensure_ascii=False) for doc in docs
        )


def _geometric_answer_udf(
    llm_chat_model,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    strict_prompt: bool,
):
    """Async per-row geometric re-asking loop shared by the strategy
    functions and AdaptiveRAGQuestionAnswerer (parity :97-162 semantics:
    ask with k docs, multiply k by ``factor`` until answered or
    ``max_iterations`` reached; None when no answer is found)."""
    llm_fn = llm_chat_model.as_async_callable()
    not_found = "No information found."

    @pw.udf(executor=pw.udfs.async_executor())
    async def geometric_answer(question: str, docs: Json) -> str | None:
        doc_list = list(docs.value or ()) if isinstance(docs, Json) else list(docs or ())
        texts = [
            str(d.get("text", d)) if isinstance(d, dict) else str(d) for d in doc_list
        ]
        n = n_starting_documents
        prev_size = -1
        for _round in range(max_iterations):
            subset = texts[:n]
            if len(subset) == prev_size:
                break  # context exhausted; re-asking would repeat verbatim
            prev_size = len(subset)
            context = "\n\n".join(subset)
            if strict_prompt:
                full_prompt = (
                    "Use the below articles to answer the subsequent question. "
                    f'Respond with json of the form {{"answer": "..."}}; if the '
                    f'answer cannot be found, use "{not_found}".\n'
                    f"Articles:\n{context}\nQuestion: {question}"
                )
            else:
                full_prompt = (
                    "Use the below articles to answer the subsequent question. "
                    f'If the answer cannot be found, write "{not_found}"\n'
                    f"Articles:\n{context}\nQuestion: {question}\nAnswer:"
                )
            res = await llm_fn([{"role": "user", "content": full_prompt}])
            answer = str(res) if res is not None else ""
            if strict_prompt and "{" in answer:
                try:
                    payload = _json.loads(answer[answer.find("{") : answer.find("}") + 1])
                    answer = " ".join(str(v) for v in payload.values())
                except (ValueError, AttributeError):
                    pass
            if answer and not_found.lower().rstrip(".") not in answer.lower():
                return answer
            n = min(n * factor, len(texts))
        return None

    return geometric_answer


def answer_with_geometric_rag_strategy(
    questions: ColumnReference,
    documents: ColumnReference,
    llm_chat_model,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    strict_prompt: bool = False,
) -> ColumnReference:
    """Query the LLM with geometrically growing document context until an
    answer is found (parity: question_answering.py:97-159).  Returns a
    column of answers; None where no answer was found."""
    geometric_answer = _geometric_answer_udf(
        llm_chat_model, n_starting_documents, factor, max_iterations, strict_prompt
    )
    table = questions.table
    # like the reference, the result table carries query/documents through
    # so callers can select alongside the answer column
    result = table.select(
        query=questions,
        documents=documents,
        answer=geometric_answer(questions, documents),
    )
    return result.answer


def answer_with_geometric_rag_strategy_from_index(
    questions: ColumnReference,
    index,
    documents_column,
    llm_chat_model,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    metadata_filter=None,
    strict_prompt: bool = False,
) -> ColumnReference:
    """Like :func:`answer_with_geometric_rag_strategy` but over-fetches the
    documents once from ``index`` (parity: question_answering.py:162-218)."""
    if isinstance(documents_column, ColumnReference):
        documents_column_name = documents_column.name
    else:
        documents_column_name = documents_column
    max_documents = n_starting_documents * (factor ** (max_iterations - 1))
    # one over-fetch at the final context size; the reply table lives on the
    # query universe with the data columns collapsed to ranked tuples
    matches = index.query_as_of_now(
        questions,
        number_of_matches=max_documents,
        collapse_rows=True,
        metadata_filter=metadata_filter,
    )
    return answer_with_geometric_rag_strategy(
        ColumnReference(matches, questions.name),
        ColumnReference(matches, documents_column_name),
        llm_chat_model,
        n_starting_documents,
        factor,
        max_iterations,
        strict_prompt=strict_prompt,
    )


class BaseQuestionAnswerer:
    AnswerQuerySchema: type[pw.Schema]
    RetrieveQuerySchema: type[pw.Schema]
    StatisticsQuerySchema: type[pw.Schema]
    InputsQuerySchema: type[pw.Schema]


class BaseRAGQuestionAnswerer(BaseQuestionAnswerer):
    """Standard RAG: retrieve → prompt → LLM (parity :288)."""

    class AnswerQuerySchema(pw.Schema):
        prompt: str
        filters: str | None
        model: str | None
        return_context_docs: bool | None

    class RetrieveQuerySchema(DocumentStore.RetrieveQuerySchema):
        pass

    class StatisticsQuerySchema(pw.Schema):
        pass

    class InputsQuerySchema(DocumentStore.InputsQuerySchema):
        pass

    class SummarizeQuerySchema(pw.Schema):
        text_list: Json
        model: str | None

    def __init__(
        self,
        llm,
        indexer: DocumentStore,
        *,
        default_llm_name: str | None = None,
        prompt_template=None,
        context_processor=None,
        search_topk: int = 6,
        summarize_template=None,
    ):
        self.llm = llm
        self.indexer = indexer
        self.search_topk = search_topk
        self.prompt_template = prompt_template or prompts.prompt_qa
        if context_processor is None:
            context_processor = SimpleContextProcessor()
        if isinstance(context_processor, BaseContextProcessor):
            self.docs_to_context_transformer = context_processor.as_udf()
        elif isinstance(context_processor, UDF):
            self.docs_to_context_transformer = context_processor
        elif callable(context_processor):
            u = UDF()
            u.__wrapped__ = context_processor
            self.docs_to_context_transformer = u
        else:
            raise ValueError(
                "context_processor must be BaseContextProcessor | Callable | UDF, "
                f"got {type(context_processor)}"
            )
        self.summarize_template = summarize_template or prompts.prompt_summarize
        self.server: Any = None

    def _prompt_expr(self, docs_ref, query_ref):
        """Build the prompt column from docs + query.

        A ``str`` template (reference ``RAGPromptTemplate`` form) and any
        callable taking a ``context`` parameter go through the pluggable
        context processor; legacy repo templates taking ``docs`` receive
        the raw docs value and assemble context themselves.
        """
        template = self.prompt_template
        if isinstance(template, str):
            if "{context}" not in template or "{query}" not in template:
                raise ValueError(
                    "string prompt_template must contain {context} and {query}"
                )
            ctx = self.docs_to_context_transformer(docs_ref)
            return ApplyExpression(
                lambda c, q: template.format(context=c, query=q), str, ctx, query_ref
            )
        fn = template.__wrapped__ if isinstance(template, UDF) else template
        try:
            params = list(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            params = []
        if params and params[0] == "context":
            ctx = self.docs_to_context_transformer(docs_ref)
            return template(ctx, query_ref)
        return template(docs_ref, query_ref)

    # -- internal: fetch docs for a query table --
    def _retrieve_docs(self, queries: Table, k: int | None = None) -> Table:
        augmented = queries.with_columns(
            query=ColumnReference(this, "prompt"),
            k=expr_mod.ColumnConstExpression(k or self.search_topk),
            metadata_filter=expr_mod.coalesce(
                ColumnReference(this, "filters"), None
            )
            if "filters" in queries.column_names()
            else expr_mod.ColumnConstExpression(None),
            filepath_globpattern=expr_mod.ColumnConstExpression(None),
        )
        replies = self.indexer.retrieve_query(augmented)
        return queries.with_columns(
            docs=replies.result,
        )

    def answer_query(self, pw_ai_queries: Table) -> Table:
        """The /v1/pw_ai_answer handler (parity :387)."""
        with_docs = self._retrieve_docs(pw_ai_queries)
        prompted = with_docs.with_columns(
            _pw_prompt=self._prompt_expr(
                ColumnReference(this, "docs"), ColumnReference(this, "prompt")
            )
        )
        llm = self.llm

        answered = prompted.with_columns(
            _pw_answer=llm(
                ApplyExpression(
                    lambda p: Json([{"role": "user", "content": p}]),
                    None,
                    ColumnReference(this, "_pw_prompt"),
                )
            )
        )

        def pack(answer, docs, return_context_docs) -> Json:
            out: dict = {"response": answer}
            if return_context_docs:
                out["context_docs"] = docs.value if isinstance(docs, Json) else docs
            return Json(out)

        return answered.select(
            result=ApplyExpression(
                pack,
                None,
                ColumnReference(this, "_pw_answer"),
                ColumnReference(this, "docs"),
                ColumnReference(this, "return_context_docs")
                if "return_context_docs" in answered.column_names()
                else expr_mod.ColumnConstExpression(False),
                _propagate_none=False,
            )
        )

    pw_ai_query = answer_query  # legacy name (reference keeps both)

    def retrieve(self, retrieval_queries: Table) -> Table:
        return self.indexer.retrieve_query(retrieval_queries)

    def statistics(self, info_queries: Table) -> Table:
        return self.indexer.statistics_query(info_queries)

    def list_documents(self, input_queries: Table) -> Table:
        return self.indexer.inputs_query(input_queries)

    def summarize_query(self, summarize_queries: Table) -> Table:
        """The /v1/pw_ai_summary handler (parity :~460)."""
        prompted = summarize_queries.with_columns(
            _pw_prompt=self.summarize_template(
                ApplyExpression(
                    lambda tl: tuple(tl.value) if isinstance(tl, Json) else tuple(tl or ()),
                    None,
                    ColumnReference(this, "text_list"),
                )
            )
        )
        answered = prompted.with_columns(
            _pw_answer=self.llm(
                ApplyExpression(
                    lambda p: Json([{"role": "user", "content": p}]),
                    None,
                    ColumnReference(this, "_pw_prompt"),
                )
            )
        )
        return answered.select(
            result=ApplyExpression(
                lambda a: Json({"response": a}),
                None,
                ColumnReference(this, "_pw_answer"),
                _propagate_none=False,
            )
        )

    # -- serving --
    def build_server(self, host: str, port: int, **rest_kwargs) -> None:
        self.server = QASummaryRestServer(host, port, self, **rest_kwargs)

    def run_server(self, *args, **kwargs):
        if self.server is None:
            raise ValueError("call build_server(host, port) first")
        return self.server.run_server(*args, **kwargs)


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Geometric-k adaptive RAG (parity :97-162).

    Over-fetches ``max_context_docs`` once from the as-of-now index, then
    asks the LLM with n_starting_documents, doubling (factor) until the
    answer is not the not-found response — the prompt-side behavior of the
    reference's re-asking loop, with one index round-trip instead of many.
    """

    def __init__(
        self,
        llm,
        indexer: DocumentStore,
        *,
        default_llm_name: str | None = None,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        strict_prompt: bool = False,
        **kwargs,
    ):
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations
        self.strict_prompt = strict_prompt
        self.not_found_response = "No information found."

    def answer_query(self, pw_ai_queries: Table) -> Table:
        max_docs = self.n_starting_documents * (
            self.factor ** (self.max_iterations - 1)
        )
        with_docs = self._retrieve_docs(pw_ai_queries, k=max_docs)
        adaptive_answer = _geometric_answer_udf(
            self.llm,
            self.n_starting_documents,
            self.factor,
            self.max_iterations,
            self.strict_prompt,
        )
        not_found = self.not_found_response

        answered = with_docs.with_columns(
            _pw_answer=adaptive_answer(
                ColumnReference(this, "prompt"), ColumnReference(this, "docs")
            )
        )
        return answered.select(
            result=ApplyExpression(
                lambda a: Json({"response": a if a is not None else not_found}),
                None,
                ColumnReference(this, "_pw_answer"),
                _propagate_none=False,
            )
        )


class SummaryQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Alias emphasizing the summarization endpoints (parity)."""


class DeckRetriever(BaseQuestionAnswerer):
    """Slide-deck retrieval app (parity :288; search-only surface)."""

    class AnswerQuerySchema(pw.Schema):
        prompt: str
        filters: str | None

    class RetrieveQuerySchema(DocumentStore.RetrieveQuerySchema):
        pass

    class StatisticsQuerySchema(pw.Schema):
        pass

    class InputsQuerySchema(DocumentStore.InputsQuerySchema):
        pass

    def __init__(self, indexer: DocumentStore, *, search_topk: int = 6, **kwargs):
        self.indexer = indexer
        self.search_topk = search_topk
        self.server = None

    def answer_query(self, queries: Table) -> Table:
        augmented = queries.with_columns(
            query=ColumnReference(this, "prompt"),
            k=expr_mod.ColumnConstExpression(self.search_topk),
            metadata_filter=expr_mod.coalesce(ColumnReference(this, "filters"), None),
            filepath_globpattern=expr_mod.ColumnConstExpression(None),
        )
        return self.indexer.retrieve_query(augmented)

    def retrieve(self, queries: Table) -> Table:
        return self.indexer.retrieve_query(queries)

    def statistics(self, q: Table) -> Table:
        return self.indexer.statistics_query(q)

    def list_documents(self, q: Table) -> Table:
        return self.indexer.inputs_query(q)

    def build_server(self, host: str, port: int, **rest_kwargs) -> None:
        self.server = QARestServer(host, port, self, **rest_kwargs)

    def run_server(self, *args, **kwargs):
        return self.server.run_server(*args, **kwargs)


class RAGClient:
    """HTTP client for the RAG question-answering servers
    (parity: question_answering.py:879-1030).

    Either (``host`` and ``port``) or ``url`` must be set, not both.
    """

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: int | None = 90,
        additional_headers: dict | None = None,
    ):
        err = "Either (`host` and `port`) or `url` must be provided, but not both."
        if url is not None:
            if host is not None or port is not None:
                raise ValueError(err)
            self.url = url
        else:
            if host is None:
                raise ValueError(err)
            port = port or 80
            protocol = "https" if port == 443 else "http"
            self.url = f"{protocol}://{host}:{port}"
        self.timeout = timeout
        self.additional_headers = additional_headers or {}
        self.index_client = VectorStoreClient(
            url=self.url,
            timeout=self.timeout,
            additional_headers=self.additional_headers,
        )

    def retrieve(
        self,
        query: str,
        k: int = 3,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ):
        """Retrieve the k closest documents for ``query``."""
        return self.index_client.query(
            query=query,
            k=k,
            metadata_filter=metadata_filter,
            filepath_globpattern=filepath_globpattern,
        )

    def statistics(self):
        """Index statistics from the /v1/statistics endpoint."""
        return self.index_client.get_vectorstore_statistics()

    def pw_ai_answer(
        self,
        prompt: str,
        filters: str | None = None,
        model: str | None = None,
        return_context_docs: bool | None = None,
    ):
        """Ask the RAG app a question (POST /v1/pw_ai_answer)."""
        payload: dict = {"prompt": prompt}
        if filters:
            payload["filters"] = filters
        if model:
            payload["model"] = model
        if return_context_docs is not None:
            payload["return_context_docs"] = return_context_docs
        return send_post_request(
            f"{self.url}/v1/pw_ai_answer",
            payload,
            self.additional_headers,
            self.timeout,
        )

    answer = pw_ai_answer

    def pw_ai_summary(self, text_list: list[str], model: str | None = None):
        """Summarize a list of texts (POST /v1/pw_ai_summary)."""
        payload: dict = {"text_list": text_list}
        if model:
            payload["model"] = model
        return send_post_request(
            f"{self.url}/v1/pw_ai_summary",
            payload,
            self.additional_headers,
            self.timeout,
        )

    summarize = pw_ai_summary

    def pw_list_documents(
        self, filters: str | None = None, keys: list[str] | None = ["path"]
    ):
        """List indexed documents (POST /v1/pw_list_documents), keeping
        only ``keys`` from each document's metadata."""
        payload: dict = {}
        if filters:
            payload["metadata_filter"] = filters
        response = send_post_request(
            f"{self.url}/v1/pw_list_documents",
            payload,
            self.additional_headers,
            self.timeout,
        )
        if not response:
            return []
        if keys:
            return [{k: v for k, v in dc.items() if k in keys} for dc in response]
        return response

    list_documents = pw_list_documents
