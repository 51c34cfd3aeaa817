"""DataIndex — joins index answers back to data (parity:
stdlib/indexing/data_index.py:278-412).

``query_as_of_now`` lowers onto the engine's as-of-now external-index
operator (§3.4 of SURVEY.md): queries are a stream; each is answered against
current index state, and answers are kept up to date under data changes with
retraction bookkeeping.  The answer join-back (data_index.py:294-349) is
composed from flatten → ix → groupby, all incremental.

A copy of ``pathway_tpu/stdlib/indexing/data_index.py``.  As there,
``query`` and ``query_as_of_now`` share one lowering: the operator
revises a standing query's answer whenever the indexed data changes.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.expression import ApplyExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this


class InnerIndex:
    """Factory-facing half of an index (parity: data_index.py:206)."""

    def __init__(self, data_column: ColumnReference, metadata_column: ColumnReference | None = None):
        self.data_column = data_column
        self.metadata_column = metadata_column

    def factory(self):
        """Return an engine index factory (object with .build())."""
        raise NotImplementedError

    def embed(self, column):
        """Optionally turn a raw query column into the index's vector space."""
        return column

    def data_expr(self, index_column):
        """Expression producing what the engine index stores per data row
        (embeds the data column when an embedder is attached)."""
        embedder = getattr(self, "embedder", None)
        if embedder is not None:
            return embedder(index_column)
        return index_column


class DataIndex:
    """Index over ``data_table`` with query methods returning result tables."""

    def __init__(self, data_table: Table, inner_index: InnerIndex):
        self.data_table = data_table
        self.inner_index = inner_index

    def query_as_of_now(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: int | Any = 3,
        collapse_rows: bool = True,
        metadata_filter: ColumnReference | None = None,
        with_distances: bool = True,
    ) -> Table:
        return self._query(
            query_column,
            number_of_matches=number_of_matches,
            collapse_rows=collapse_rows,
            metadata_filter=metadata_filter,
        )

    # plain query shares the lowering; the external-index operator already
    # revises answers on data change, which is the full incremental semantics
    def query(self, query_column: ColumnReference, **kwargs) -> Table:
        kwargs.pop("collapse_rows", None)
        return self._query(query_column, **kwargs)

    def _query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: int | Any = 3,
        collapse_rows: bool = True,
        metadata_filter: ColumnReference | None = None,
    ) -> Table:
        query_table: Table = query_column.table
        data_table = self.data_table
        index_col = self.inner_index.data_column
        embedded_q = self.inner_index.embed(query_column)
        if embedded_q is not query_column:
            query_table = query_table.with_columns(_pw_q_embedded=embedded_q)
            q_col = ColumnReference(query_table, "_pw_q_embedded")
        else:
            q_col = query_column
        data_expr = self.inner_index.data_expr(index_col)
        if data_expr is not index_col:
            # embed the data column device-side before it enters the index
            data_table = data_table.with_columns(_pw_data_prepared=data_expr)
            index_col = ColumnReference(data_table, "_pw_data_prepared")
        replies = data_table._external_index_as_of_now(
            self.inner_index.factory(),
            query_table,
            index_col,
            q_col,
            index_filter_data_column=self.inner_index.metadata_column,
            query_filter_column=metadata_filter,
            query_number_of_matches=number_of_matches,
        )
        # replies: universe of query_table; _pw_index_reply = sorted tuple of
        # (Pointer, score)
        data_names = [
            n for n in data_table.column_names() if not n.startswith("_pw_")
        ]

        ranked = replies.with_columns(
            _pw_ranked=ApplyExpression(
                lambda reply: tuple((p, s, i) for i, (p, s) in enumerate(reply)),
                None,
                ColumnReference(this, "_pw_index_reply"),
            )
        )
        flat = ranked.flatten(ColumnReference(this, "_pw_ranked"), origin_id="_pw_qid")
        flat = flat.with_columns(
            _pw_match=ApplyExpression(lambda r: r[0], None, ColumnReference(this, "_pw_ranked")),
            _pw_score=ApplyExpression(lambda r: r[1], None, ColumnReference(this, "_pw_ranked")),
            _pw_rank=ApplyExpression(lambda r: r[2], None, ColumnReference(this, "_pw_ranked")),
        )
        view = data_table.ix(ColumnReference(this, "_pw_match"))
        enriched_exprs: dict[str, Any] = {
            "_pw_qid": ColumnReference(this, "_pw_qid"),
            "_pw_score": ColumnReference(this, "_pw_score"),
            "_pw_rank": ColumnReference(this, "_pw_rank"),
        }
        for n in data_names:
            enriched_exprs[n] = getattr(view, n)
        enriched = flat.select(**enriched_exprs)

        if not collapse_rows:
            out_exprs: dict[str, Any] = {n: ColumnReference(this, n) for n in data_names}
            out_exprs["_pw_index_reply_score"] = ColumnReference(this, "_pw_score")
            out_exprs["_pw_query_id"] = ColumnReference(this, "_pw_qid")
            return enriched.select(**out_exprs)

        agg: dict[str, Any] = {"_pw_qid": ColumnReference(this, "_pw_qid")}
        for n in data_names:
            agg[n] = reducers.tuple(
                ColumnReference(this, n), sort_by=ColumnReference(this, "_pw_rank")
            )
        agg["_pw_index_reply_score"] = reducers.tuple(
            ColumnReference(this, "_pw_score"), sort_by=ColumnReference(this, "_pw_rank")
        )
        grouped = enriched.groupby(ColumnReference(this, "_pw_qid")).reduce(**agg)
        collected = grouped.with_id(ColumnReference(this, "_pw_qid"))
        cview = collected.ix(ColumnReference(this, "id"), optional=True)

        final: dict[str, Any] = {}
        for n in query_table.column_names():
            if n.startswith("_pw_"):
                continue
            final[n] = ColumnReference(this, n)
        for n in data_names:
            final[n] = expr_mod.coalesce(cview[n], ())
        final["_pw_index_reply_score"] = expr_mod.coalesce(
            cview["_pw_index_reply_score"], ()
        )
        return query_table.select(**final)
