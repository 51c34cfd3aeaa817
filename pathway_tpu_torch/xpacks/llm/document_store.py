"""DocumentStore — parse → post-process → split → index pipeline
(parity: xpacks/llm/document_store.py:32-498).

Inputs: tables of (data: bytes, _metadata: Json) from any connector.
Queries (retrieve/statistics/inputs) are streaming tables; answers are
as-of-now index lookups (§3.4 of SURVEY.md).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this
from pathway_tpu_torch.stdlib.indexing.retrievers import AbstractRetrieverFactory
from pathway_tpu_torch.xpacks.llm.parsers import ParseUtf8
from pathway_tpu_torch.xpacks.llm.splitters import NullSplitter


class DocumentStore:
    """Builds and serves a document index over streaming input tables."""

    class RetrieveQuerySchema(pw.Schema):
        query: str
        k: int
        metadata_filter: str | None
        filepath_globpattern: str | None

    class StatisticsQuerySchema(pw.Schema):
        pass

    class InputsQuerySchema(pw.Schema):
        metadata_filter: str | None
        filepath_globpattern: str | None

    def __init__(
        self,
        docs: Table | Iterable[Table],
        retriever_factory: AbstractRetrieverFactory,
        parser: Any | None = None,
        splitter: Any | None = None,
        doc_post_processors: list[Callable[[str, Json], tuple[str, Json]]] | None = None,
    ):
        if isinstance(docs, Table):
            docs_tables = [docs]
        else:
            docs_tables = list(docs)
        if not docs_tables:
            raise ValueError(
                "DocumentStore requires at least one documents table "
                "(got an empty `docs`); pass e.g. pw.io.fs.read(...)"
            )
        self.docs = (
            docs_tables[0].concat_reindex(*docs_tables[1:])
            if len(docs_tables) > 1
            else docs_tables[0]
        )
        self.retriever_factory = retriever_factory
        self.parser = parser or ParseUtf8()
        self.splitter = splitter or NullSplitter()
        self.doc_post_processors = doc_post_processors or []
        self._build()

    def _build(self) -> None:
        docs = self.docs
        has_meta = "_metadata" in docs.column_names()
        if not has_meta:
            docs = docs.with_columns(_metadata=expr_mod.ColumnConstExpression(Json({})))

        # 1. parse: data -> tuple[(text, meta)]
        parsed = docs.with_columns(
            _pw_parsed=self.parser(ColumnReference(this, "data"))
        )
        parsed_flat = parsed.flatten(
            ColumnReference(this, "_pw_parsed"), origin_id="_pw_doc_id"
        )
        parsed_docs = parsed_flat.select(
            text=ApplyExpression(lambda p: p[0], str, ColumnReference(this, "_pw_parsed")),
            metadata=ApplyExpression(
                _merge_meta, None, ColumnReference(this, "_pw_parsed"),
                ColumnReference(this, "_metadata"),
            ),
        )

        # 2. post-process
        for post in self.doc_post_processors:
            parsed_docs = parsed_docs.select(
                _pw_pp=ApplyExpression(
                    lambda t, m, _p=post: tuple(_p(t, m)),
                    None,
                    ColumnReference(this, "text"),
                    ColumnReference(this, "metadata"),
                )
            ).select(
                text=ApplyExpression(lambda p: p[0], str, ColumnReference(this, "_pw_pp")),
                metadata=ApplyExpression(lambda p: p[1], None, ColumnReference(this, "_pw_pp")),
            )
        self.parsed_docs = parsed_docs

        # 3. split: text -> tuple[(chunk, meta)]
        chunked = parsed_docs.with_columns(
            _pw_chunks=self.splitter(
                ColumnReference(this, "text"), ColumnReference(this, "metadata")
            )
        )
        chunks_flat = chunked.flatten(
            ColumnReference(this, "_pw_chunks"), origin_id="_pw_parent"
        )
        self.chunked_docs = chunks_flat.select(
            text=ApplyExpression(lambda c: c[0], str, ColumnReference(this, "_pw_chunks")),
            metadata=ApplyExpression(
                _merge_chunk_meta,
                None,
                ColumnReference(this, "_pw_chunks"),
                ColumnReference(this, "metadata"),
            ),
        )

        # 4. index
        self._index = self.retriever_factory.build_index(
            ColumnReference(self.chunked_docs, "text"),
            self.chunked_docs,
            metadata_column=ColumnReference(self.chunked_docs, "metadata"),
        )

    @property
    def index(self):
        return self._index

    @staticmethod
    def merge_filters(queries: Table) -> Table:
        """Merge metadata_filter and filepath_globpattern into one filter
        expression (parity: document_store.py merge_filters)."""

        def merge(metadata_filter, globpattern):
            clauses = []
            if metadata_filter:
                clauses.append(f"({metadata_filter})")
            if globpattern:
                clauses.append(f"globmatch('{globpattern}', path)")
            return " && ".join(clauses) if clauses else None

        return queries.with_columns(
            metadata_filter=ApplyExpression(
                merge,
                None,
                ColumnReference(this, "metadata_filter"),
                ColumnReference(this, "filepath_globpattern"),
                _propagate_none=False,
            )
        )

    def retrieve_query(self, retrieval_queries: Table) -> Table:
        """queries(query, k, metadata_filter, filepath_globpattern) → result."""
        queries = self.merge_filters(retrieval_queries)
        matched = self._index.query_as_of_now(
            ColumnReference(queries, "query"),
            number_of_matches=ColumnReference(queries, "k"),
            metadata_filter=ColumnReference(queries, "metadata_filter"),
            collapse_rows=True,
        )

        def pack(texts, metas, scores) -> Json:
            out = []
            for t, m, s in zip(texts or (), metas or (), scores or ()):
                out.append(
                    {
                        "text": t,
                        "metadata": m.value if isinstance(m, Json) else m,
                        "dist": -float(s),
                    }
                )
            return Json(out)

        return matched.select(
            result=ApplyExpression(
                pack,
                None,
                ColumnReference(this, "text"),
                ColumnReference(this, "metadata"),
                ColumnReference(this, "_pw_index_reply_score"),
                _propagate_none=False,
            )
        )

    def statistics_query(self, info_queries: Table) -> Table:
        """Document-count / last-modified statistics (parity :498)."""
        stats = self.parsed_docs.reduce(
            count=reducers.count(),
            last_modified=ApplyExpression(
                lambda ts: ts[-1] if ts else None,
                None,
                reducers.sorted_tuple(
                    ApplyExpression(
                        _modified_at, None, ColumnReference(this, "metadata")
                    ),
                    skip_nones=True,
                ),
                _propagate_none=False,
            ),
        )

        def pack(count, last_modified) -> Json:
            return Json(
                {
                    "file_count": count if count is not None else 0,
                    "last_modified": last_modified,
                    "last_indexed": last_modified,
                }
            )

        stats_view = stats
        return info_queries.select(
            result=ApplyExpression(
                pack,
                None,
                expr_mod.coalesce(_global_scalar(info_queries, stats_view, "count"), 0),
                _global_scalar(info_queries, stats_view, "last_modified"),
                _propagate_none=False,
            )
        )

    def inputs_query(self, input_queries: Table) -> Table:
        """List indexed input files, honoring the query's ``metadata_filter``
        and ``filepath_globpattern`` (parity: document_store.py inputs, which
        applies merged filters per query)."""
        import fnmatch

        from pathway_tpu_torch.stdlib.indexing.filters import metadata_matches

        files = self.parsed_docs.reduce(
            paths=reducers.tuple(
                ApplyExpression(_meta_path_entry, None, ColumnReference(this, "metadata"))
            )
        )

        def pack(paths, metadata_filter, globpattern) -> Json:
            out = []
            for p in paths or ():
                if p is None:
                    continue
                entry = p.value if isinstance(p, Json) else p
                path = entry.get("path") if isinstance(entry, dict) else None
                if globpattern and not fnmatch.fnmatch(str(path or ""), globpattern):
                    continue
                if metadata_filter and not metadata_matches(metadata_filter, entry):
                    continue
                out.append(entry)
            return Json(out)

        return input_queries.select(
            result=ApplyExpression(
                pack,
                None,
                _global_scalar(input_queries, files, "paths"),
                ColumnReference(this, "metadata_filter"),
                ColumnReference(this, "filepath_globpattern"),
                _propagate_none=False,
            )
        )


class SlidesDocumentStore(DocumentStore):
    """Document store for the slide-search application (parity:
    document_store.py:471-529): a DocumentStore whose default parser is
    the slide parser, plus a ``parsed_documents_query`` returning the
    per-slide metadata after parsing/post-processing (with the bulky
    ``b64_image`` entries stripped, like the reference)."""

    excluded_response_metadata = ["b64_image"]

    def __init__(self, docs, retriever_factory, parser=None, **kwargs):
        if parser is None:
            from pathway_tpu_torch.xpacks.llm.parsers import SlideParser

            parser = SlideParser()
        super().__init__(docs, retriever_factory, parser=parser, **kwargs)

    def parsed_documents_query(self, parse_docs_queries: Table) -> Table:
        """List parsed documents' metadata, honoring ``metadata_filter``
        (InputsQuerySchema queries)."""
        from pathway_tpu_torch.stdlib.indexing.filters import metadata_matches

        metas = self.parsed_docs.reduce(
            metadatas=reducers.tuple(ColumnReference(this, "metadata"))
        )
        merged = self.merge_filters(parse_docs_queries)

        def pack(metadatas, metadata_filter) -> Json:
            out = []
            for m in metadatas or ():
                entry = dict(m.value) if isinstance(m, Json) else dict(m or {})
                if metadata_filter and not metadata_matches(
                    metadata_filter, entry
                ):
                    continue
                for key in self.excluded_response_metadata:
                    entry.pop(key, None)
                out.append(entry)
            return Json(out)

        return merged.select(
            result=ApplyExpression(
                pack,
                None,
                _global_scalar(merged, metas, "metadatas"),
                ColumnReference(this, "metadata_filter"),
                _propagate_none=False,
            )
        )


def _merge_meta(parsed_pair, file_meta):
    meta = parsed_pair[1]
    m = dict(meta.value) if isinstance(meta, Json) else dict(meta or {})
    if isinstance(file_meta, Json) and isinstance(file_meta.value, dict):
        m = {**file_meta.value, **m}
    return Json(m)


def _merge_chunk_meta(chunk_pair, parent_meta):
    meta = chunk_pair[1]
    m = dict(meta.value) if isinstance(meta, Json) else dict(meta or {})
    if isinstance(parent_meta, Json) and isinstance(parent_meta.value, dict):
        m = {**parent_meta.value, **m}
    return Json(m)


def _modified_at(meta):
    if isinstance(meta, Json) and isinstance(meta.value, dict):
        return meta.value.get("modified_at")
    return None


def _meta_path_entry(meta):
    # returns Json (hashable) — reducer args must be hashable engine values
    if isinstance(meta, Json) and isinstance(meta.value, dict):
        m = meta.value
        return Json(
            {
                "path": m.get("path"),
                "size": m.get("size"),
                "modified_at": m.get("modified_at"),
            }
        )
    return None


def _global_scalar(query_table: Table, scalar_table: Table, column: str):
    """Reference a single-row aggregate from every query row: the aggregate
    is re-keyed by a constant, and each query row ix-fetches that constant
    pointer — incremental and key-agnostic."""
    keyed = scalar_table.with_columns(_pw_one=expr_mod.ColumnConstExpression(0)).with_id_from(
        ColumnReference(this, "_pw_one")
    )
    view = keyed.ix(
        expr_mod.PointerExpression(keyed, expr_mod.ColumnConstExpression(0)),
        optional=True,
    )
    return getattr(view, column)
